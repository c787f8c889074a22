"""Output writer interface (reference ``src/output/writer.rs``)."""

from __future__ import annotations

from .types import Detection


class OutputWriter:
    """Base class for detection output writers."""

    def write_header(self) -> None:  # noqa: B027 — optional hook
        pass

    def write_detection(self, detection: Detection) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        raise NotImplementedError

    def abort(self) -> None:  # noqa: B027 — optional hook
        """Close resources WITHOUT finalizing (error path): a half-written
        output must not hold its file handle open — in a long directory run
        every failing file would leak one — nor pretend to be complete."""

    def __enter__(self):
        self.write_header()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.finalize()
        else:
            self.abort()
