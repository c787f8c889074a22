"""Progress reporters (reference ``src/output/reporter.rs``).

Three output planes: human logs/progress to stderr, the NDJSON event stream
on stdout for GUI integration, and buffered-JSON mode that collects every
event and prints one array at the end. Progress events are throttled by
percent delta (10) and minimum interval (500 ms), with 0% and 100% always
emitted.
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time

from . import json_envelope as env
from .json_envelope import (
    CancelReason,
    ErrorSeverity,
    EventType,
    FileStatus,
    PipelineStatus,
)


class ProgressThrottler:
    MIN_INTERVAL_MS = 500
    MIN_PERCENT_CHANGE = 10

    def __init__(self):
        self._last_percent = 0
        self._last_update = time.monotonic()
        self._lock = threading.Lock()

    def should_emit(self, current_percent: float) -> bool:
        current = int(min(max(math.floor(current_percent), 0), 100))
        with self._lock:
            if current == 0 or current >= 100:
                self._last_percent = current
                self._last_update = time.monotonic()
                return True
            percent_changed = current - self._last_percent >= self.MIN_PERCENT_CHANGE
            time_elapsed = (
                (time.monotonic() - self._last_update) * 1000 >= self.MIN_INTERVAL_MS
            )
            if percent_changed or time_elapsed:
                self._last_percent = current
                self._last_update = time.monotonic()
                return True
            return False

    def reset(self):
        with self._lock:
            self._last_percent = 0
            self._last_update = time.monotonic()


class ProgressReporter:
    """Event sink interface (reference trait, ``reporter.rs:22``)."""

    def pipeline_started(self, total_files, model, min_confidence,
                         execution_provider, range_filter=None,
                         precision=None, sharding=None): ...

    def file_started(self, file, index, estimated_segments,
                     duration_seconds=None): ...

    def progress(self, batch=None, file=None): ...

    def file_completed_success(self, file, detections, duration_ms): ...

    def file_completed_failure(self, file, error_code, error_message): ...

    def file_skipped(self, file, reason: FileStatus): ...

    def pipeline_completed(self, summary: dict): ...

    def error(self, code, severity: ErrorSeverity, message, suggestion=None): ...

    def cancelled(self, reason: CancelReason, files_completed, files_total): ...

    def detections(self, file, detections, bsg_metadata=None): ...

    def result(self, payload: dict): ...

    def finish(self): ...


class NullReporter(ProgressReporter):
    """Swallows everything (human-progress mode uses stderr bars instead)."""


class JsonReporter(ProgressReporter):
    """NDJSON (streaming) or buffered-JSON reporter on a text stream."""

    def __init__(self, stream=None, buffered: bool = False):
        self._stream = stream or sys.stdout
        self._buffered = buffered
        self._buffer: list[dict] = []
        self._throttler = ProgressThrottler()
        # RLock, not Lock: the SIGINT handler runs ON the main thread and
        # calls cancelled()/finish(); if the interrupt lands while the
        # main thread is inside _emit (holding the lock during a write to
        # a possibly-slow stdout pipe), a non-reentrant lock deadlocks
        # the handler forever. Same-thread reentry may interleave one
        # line mid-write — acceptable for a process that exits next.
        self._lock = threading.RLock()

    def _emit(self, event: EventType, payload: dict) -> None:
        doc = env.envelope(event, payload)
        with self._lock:
            if self._buffered:
                self._buffer.append(doc)
            else:
                self._stream.write(json.dumps(doc, separators=(",", ":")) + "\n")
                self._stream.flush()

    # -- events --------------------------------------------------------------

    def pipeline_started(self, total_files, model, min_confidence,
                         execution_provider, range_filter=None,
                         precision=None, sharding=None):
        self._emit(
            EventType.PIPELINE_STARTED,
            env.pipeline_started_payload(
                total_files, model, min_confidence, execution_provider,
                range_filter, precision, sharding,
            ),
        )

    def file_started(self, file, index, estimated_segments, duration_seconds=None):
        self._throttler.reset()
        self._emit(
            EventType.FILE_STARTED,
            env.file_started_payload(
                str(file), index, estimated_segments, duration_seconds
            ),
        )

    def progress(self, batch=None, file=None):
        percent = (file or batch or {}).get("percent", 0.0)
        if not self._throttler.should_emit(percent):
            return
        self._emit(EventType.PROGRESS, env.progress_payload(batch, file))

    def file_completed_success(self, file, detections, duration_ms):
        self._emit(
            EventType.FILE_COMPLETED,
            env.file_completed_payload(
                str(file), FileStatus.PROCESSED,
                detections=detections, duration_ms=duration_ms,
            ),
        )

    def file_completed_failure(self, file, error_code, error_message):
        self._emit(
            EventType.FILE_COMPLETED,
            env.file_completed_payload(
                str(file), FileStatus.FAILED,
                error={"code": error_code, "message": error_message},
            ),
        )

    def file_skipped(self, file, reason: FileStatus):
        self._emit(
            EventType.FILE_COMPLETED,
            env.file_completed_payload(str(file), reason),
        )

    def pipeline_completed(self, summary: dict):
        self._emit(EventType.PIPELINE_COMPLETED, summary)

    def error(self, code, severity, message, suggestion=None):
        self._emit(
            EventType.ERROR,
            env.error_payload(code, severity, message, suggestion),
        )

    def cancelled(self, reason, files_completed, files_total):
        self._emit(
            EventType.CANCELLED,
            env.cancelled_payload(reason, files_completed, files_total),
        )

    def detections(self, file, detections, bsg_metadata=None):
        self._emit(
            EventType.DETECTIONS,
            env.detections_payload(str(file), detections, bsg_metadata),
        )

    def result(self, payload: dict):
        self._emit(EventType.RESULT, payload)

    def finish(self):
        """Buffered mode: print the collected array."""
        with self._lock:
            if self._buffered:
                self._stream.write(json.dumps(self._buffer, indent=2) + "\n")
                self._stream.flush()
                self._buffer.clear()


def create_reporter(mode: str, stream=None) -> ProgressReporter:
    """``ndjson`` | ``json`` | ``none`` (reference ``reporter.rs:486``)."""
    if mode == "ndjson":
        return JsonReporter(stream, buffered=False)
    if mode == "json":
        return JsonReporter(stream, buffered=True)
    return NullReporter()
