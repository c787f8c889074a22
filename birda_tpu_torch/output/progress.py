"""Human-mode progress bars (reference ``src/output/progress.rs``, indicatif
replaced by tqdm). Bars render to stderr so stdout stays clean for the JSON
protocol."""

from __future__ import annotations

import sys
from typing import Optional


def create_file_progress(total_files: int, enabled: bool):
    if not enabled or total_files == 0:
        return None
    from tqdm import tqdm

    return tqdm(
        total=total_files, unit="file", file=sys.stderr,
        bar_format="[{elapsed}] {bar:40} {n_fmt}/{total_fmt} files ({remaining})",
    )


def create_segment_progress(total_segments: int, file_name: str, enabled: bool):
    if not enabled or total_segments == 0:
        return None
    from tqdm import tqdm

    # Strip braces so a hostile filename cannot break the bar template.
    safe = file_name.replace("{", "").replace("}", "")
    return tqdm(
        total=total_segments, unit="seg", file=sys.stderr, leave=False,
        bar_format="[{elapsed}] {bar:40} {n_fmt}/{total_fmt} segments - " + safe,
    )


def inc_progress(pb, n: int = 1) -> None:
    if pb is not None:
        pb.update(n)


def finish_progress(pb, message: Optional[str] = None) -> None:
    if pb is not None:
        if message:
            pb.set_postfix_str(message)
        pb.close()


class HumanReporter:
    """ProgressReporter rendering tqdm bars for interactive runs."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled and sys.stderr.isatty()
        self._file_bar = None
        self._segment_bar = None
        self._segments_done = 0

    def pipeline_started(self, total_files, model, min_confidence,
                         execution_provider, range_filter=None,
                         precision=None, sharding=None):
        self._file_bar = create_file_progress(total_files, self.enabled)

    def file_started(self, file, index, estimated_segments, duration_seconds=None):
        finish_progress(self._segment_bar)
        self._segments_done = 0
        self._segment_bar = create_segment_progress(
            estimated_segments, str(file), self.enabled
        )

    def progress(self, batch=None, file=None):
        if file and self._segment_bar is not None:
            done = file.get("segments_done", 0)
            inc_progress(self._segment_bar, done - self._segments_done)
            self._segments_done = done

    def _file_done(self):
        finish_progress(self._segment_bar)
        self._segment_bar = None
        inc_progress(self._file_bar)

    def file_completed_success(self, file, detections, duration_ms):
        self._file_done()

    def file_completed_failure(self, file, error_code, error_message):
        self._file_done()

    def file_skipped(self, file, reason):
        inc_progress(self._file_bar)

    def pipeline_completed(self, summary):
        finish_progress(self._segment_bar)
        finish_progress(self._file_bar)

    def error(self, code, severity, message, suggestion=None):
        pass

    def cancelled(self, reason, files_completed, files_total):
        finish_progress(self._segment_bar)
        finish_progress(self._file_bar)

    def detections(self, file, detections, bsg_metadata=None):
        pass

    def result(self, payload):
        pass

    def finish(self):
        finish_progress(self._segment_bar)
        finish_progress(self._file_bar)
