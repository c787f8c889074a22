"""Audacity label track writer (reference ``src/output/audacity.rs``)."""

from __future__ import annotations

from pathlib import Path

from ..constants import confidence
from .types import Detection
from .writer import OutputWriter


class AudacityWriter(OutputWriter):
    def __init__(self, path: Path | str):
        self._path = Path(path)
        self._f = open(path, "w", encoding="utf-8", newline="")

    def write_detection(self, d: Detection) -> None:
        dp = confidence.DECIMAL_PLACES
        species = d.common_name.replace("_", ", ")
        self._f.write(
            f"{d.start_time:.1f}\t{d.end_time:.1f}\t{species}\t"
            f"{d.confidence:.{dp}f}\n"
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
