"""Raven selection table writer (reference ``src/output/raven.rs``)."""

from __future__ import annotations

from pathlib import Path

from ..constants import confidence, raven
from .types import Detection
from .writer import OutputWriter

_HEADER = (
    "Selection\tView\tChannel\tBegin Time (s)\tEnd Time (s)\tLow Freq (Hz)\t"
    "High Freq (Hz)\tCommon Name\tSpecies Code\tConfidence\tBegin Path\t"
    "File Offset (s)"
)


def generate_species_code(common_name: str) -> str:
    """Placeholder species code from the common name (first3+last3 or
    first4), pending real eBird taxonomy — reference ``raven.rs:74-90``."""
    words = common_name.split()
    if not words:
        return "unkn"
    if len(words) == 1:
        return words[0][:4].lower()
    return (words[0][:3] + words[-1][:3]).lower()


class RavenWriter(OutputWriter):
    def __init__(self, path: Path | str):
        self._path = Path(path)
        self._f = open(path, "w", encoding="utf-8", newline="")
        self._selection_id = 0

    def write_header(self) -> None:
        self._f.write(_HEADER + "\n")

    def write_detection(self, d: Detection) -> None:
        self._selection_id += 1
        dp = confidence.DECIMAL_PLACES
        common = d.common_name.replace(" ", "_")
        code = generate_species_code(d.common_name)
        self._f.write(
            f"{self._selection_id}\t{raven.VIEW}\t{raven.CHANNEL}\t"
            f"{d.start_time:.1f}\t{d.end_time:.1f}\t{raven.DEFAULT_LOW_FREQ}\t"
            f"{raven.DEFAULT_HIGH_FREQ}\t{common}\t{code}\t"
            f"{d.confidence:.{dp}f}\t{d.file_path}\t{d.start_time:.1f}\n"
        )

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
