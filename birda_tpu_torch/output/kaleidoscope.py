"""Kaleidoscope CSV writer (reference ``src/output/kaleidoscope.rs``)."""

from __future__ import annotations

from pathlib import Path

from ..constants import confidence
from .types import Detection
from .writer import OutputWriter


class KaleidoscopeWriter(OutputWriter):
    def __init__(self, path: Path | str):
        self._path = Path(path)
        self._f = open(path, "w", encoding="utf-8", newline="")

    def write_header(self) -> None:
        self._f.write("INDIR,FOLDER,IN FILE,OFFSET,DURATION,TOP1MATCH,TOP1DIST\n")

    def write_detection(self, d: Detection) -> None:
        dp = confidence.DECIMAL_PLACES
        path = Path(d.file_path)
        parent = path.parent
        folder = parent.name if parent.name else ""
        indir = str(parent.parent) if parent.name else ""
        # Path("x.wav").parent is "." with no grandparent string — mirror the
        # reference's empty-default behavior.
        if str(parent) in (".", ""):
            folder = ""
            indir = ""
        duration = d.end_time - d.start_time
        self._f.write(
            f"{indir},{folder},{path.name},{d.start_time:.1f},{duration:.1f},"
            f"{d.common_name.replace(' ', '_')},{d.confidence:.{dp}f}\n"
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
