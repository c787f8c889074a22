"""Parquet output writer (reference ``src/output/parquet.rs``).

Snappy compression, 1000-row batches, typed schema: six base columns
(start_s/end_s f32, scientific_name/common_name utf8, confidence f32,
file utf8) plus the recognised optional metadata columns with their exact
Arrow types (lat/lon f64, week u8, overlap/sensitivity/min_conf f32,
model/species_list utf8). Unknown column names raise — the strictest of the
three writer behaviors, preserved deliberately (``constants.rs:131-158``).
"""

from __future__ import annotations

from pathlib import Path

import pyarrow as pa
import pyarrow.parquet as pq

from ..errors import InvalidColumnName, NoInputFilesToCombine, ParquetFileOpen, ParquetWrite
from .types import Detection
from .writer import OutputWriter

BATCH_SIZE = 1000

_META_TYPES = {
    "lat": pa.float64(),
    "lon": pa.float64(),
    "week": pa.uint8(),
    "model": pa.utf8(),
    "overlap": pa.float32(),
    "sensitivity": pa.float32(),
    "min_conf": pa.float32(),
    "species_list": pa.utf8(),
}


def build_schema(include_columns: list[str]) -> pa.Schema:
    fields = [
        pa.field("start_s", pa.float32(), nullable=False),
        pa.field("end_s", pa.float32(), nullable=False),
        pa.field("scientific_name", pa.utf8(), nullable=False),
        pa.field("common_name", pa.utf8(), nullable=False),
        pa.field("confidence", pa.float32(), nullable=False),
        pa.field("file", pa.utf8(), nullable=False),
    ]
    for col in include_columns:
        t = _META_TYPES.get(col)
        if t is None:
            continue  # build_schema drops unknowns (reference behavior)
        fields.append(pa.field(col, t, nullable=True))
    return pa.schema(fields)


def _metadata_column(detections: list[Detection], col: str):
    if col not in _META_TYPES:
        raise InvalidColumnName(col)
    values = [getattr(d.metadata, col) for d in detections]
    return pa.array(values, _META_TYPES[col])


def build_record_batch(detections: list[Detection], schema: pa.Schema) -> pa.RecordBatch:
    cols = [
        pa.array([d.start_time for d in detections], pa.float32()),
        pa.array([d.end_time for d in detections], pa.float32()),
        pa.array([d.scientific_name for d in detections], pa.utf8()),
        pa.array([d.common_name for d in detections], pa.utf8()),
        pa.array([d.confidence for d in detections], pa.float32()),
        pa.array([str(d.file_path) for d in detections], pa.utf8()),
    ]
    for field in list(schema)[6:]:
        cols.append(_metadata_column(detections, field.name))
    return pa.RecordBatch.from_arrays(cols, schema=schema)


class ParquetWriter(OutputWriter):
    def __init__(self, path: Path | str, include_columns: list[str] | None = None):
        self._path = Path(path)
        self.schema = build_schema(include_columns or [])
        try:
            self._writer = pq.ParquetWriter(
                str(path), self.schema, compression="snappy",
            )
        except OSError as e:
            from ..errors import ParquetFileCreate

            raise ParquetFileCreate(str(path), str(e)) from e
        self._buffer: list[Detection] = []

    def write_detection(self, d: Detection) -> None:
        self._buffer.append(d)
        if len(self._buffer) >= BATCH_SIZE:
            self._flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        try:
            batch = build_record_batch(self._buffer, self.schema)
            self._writer.write_batch(batch)
        except (pa.ArrowInvalid, OSError) as e:
            raise ParquetWrite(str(e)) from e
        self._buffer.clear()

    def finalize(self) -> None:
        self._flush()
        self._writer.close()

    def abort(self) -> None:
        # Close and remove the fragment: without the footer the file is
        # unreadable Parquet, and at its final name it would also satisfy
        # the output-existence resume check.
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 — best-effort on the error path
            pass
        try:
            self._path.unlink()
        except OSError:
            pass


def combine_parquet_files(input_files: list[Path], output_path: Path | str) -> None:
    """Concatenate per-file Parquet results into one table (reference
    ``parquet.rs:318``). Schema comes from the first file.

    Atomic: the combined table is assembled at a temp sibling and renamed
    onto the final name only after a clean close. A mid-combine failure
    (unreadable input, schema mismatch) must not leave a footer-complete —
    i.e. silently truncated but *readable* — table at the final path.
    """
    if not input_files:
        raise NoInputFilesToCombine()
    output_path = Path(output_path)
    try:
        first = pq.ParquetFile(str(input_files[0]))
    except (OSError, pa.ArrowInvalid) as e:
        raise ParquetFileOpen(str(input_files[0]), str(e)) from e
    schema = first.schema_arrow
    import os

    tmp = output_path.parent / f".{output_path.name}.{os.getpid()}.part"
    writer = pq.ParquetWriter(str(tmp), schema, compression="snappy")
    try:
        for path in input_files:
            try:
                pf = pq.ParquetFile(str(path))
            except (OSError, pa.ArrowInvalid) as e:
                raise ParquetFileOpen(str(path), str(e)) from e
            try:
                for batch in pf.iter_batches():
                    writer.write_batch(
                        batch.cast(schema) if batch.schema != schema else batch)
            except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError) as e:
                raise ParquetWrite(
                    f"combining {path}: {e}") from e
        writer.close()
    except BaseException:
        try:
            writer.close()
        except Exception:  # noqa: BLE001 — best-effort on the error path
            pass
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
    os.replace(tmp, output_path)
