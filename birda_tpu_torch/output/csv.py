"""CSV output format writer (reference ``src/output/csv.rs``).

Byte-identical to the reference: optional UTF-8 BOM for Excel, header
``Start (s),End (s),Scientific name,Common name,Confidence,File`` plus the
requested metadata columns, times at 1 decimal, confidence at 4, minimal
quoting (only when a value contains comma/quote/newline).
"""

from __future__ import annotations

from pathlib import Path

from ..constants import UTF8_BOM, confidence
from .types import Detection
from .writer import OutputWriter


def escape_csv(value: str) -> str:
    if "," in value or '"' in value or "\n" in value:
        return '"' + value.replace('"', '""') + '"'
    return value


def _fmt_opt(v) -> str:
    """Rust's ``{}`` Display for the metadata cells: shortest float repr,
    and WHOLE floats without the trailing ``.0`` (``format!("{}", 45.0)``
    is ``"45"`` in Rust, not Python's ``"45.0"``)."""
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


class CsvWriter(OutputWriter):
    def __init__(self, path: Path | str, include_columns: list[str] | None = None,
                 include_bom: bool = True):
        self._path = Path(path)
        self._f = open(path, "w", encoding="utf-8", newline="")
        self.include_columns = include_columns or []
        if include_bom:
            self._f.write(UTF8_BOM.decode("utf-8"))

    def write_header(self) -> None:
        header = "Start (s),End (s),Scientific name,Common name,Confidence,File"
        for col in self.include_columns:
            header += "," + col
        self._f.write(header + "\n")

    def write_detection(self, d: Detection) -> None:
        dp = confidence.DECIMAL_PLACES
        row = (
            f"{d.start_time:.1f},{d.end_time:.1f},"
            f"{escape_csv(d.scientific_name)},{escape_csv(d.common_name)},"
            f"{d.confidence:.{dp}f},{escape_csv(str(d.file_path))}"
        )
        md = d.metadata
        for col in self.include_columns:
            row += ","
            val = {
                "lat": md.lat, "lon": md.lon, "week": md.week,
                "model": md.model, "overlap": md.overlap,
                "sensitivity": md.sensitivity, "min_conf": md.min_conf,
                "species_list": md.species_list,
            }.get(col)
            if val is not None:
                if col in ("model", "species_list"):
                    row += escape_csv(str(val))
                else:
                    row += _fmt_opt(val)
        self._f.write(row + "\n")

    def finalize(self) -> None:
        self._f.flush()
        self._f.close()

    def abort(self) -> None:
        # Close AND remove the partial output: output-existence resume
        # must retry this file, not skip it as done.
        try:
            self._f.close()
        except OSError:
            pass
        try:
            self._path.unlink()
        except OSError:
            pass
