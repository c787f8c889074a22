"""Inference watchdog (reference ``src/gpu/watchdog.rs``).

A detached timer that hard-exits the process if one inference batch exceeds
its deadline — the accelerator-hang failure mode (memory exhaustion wedges
the device without raising) — printing batch-size-halving advice first.
Cancelled by guard release on normal completion. Timeout configurable via
``BIRDA_INFERENCE_TIMEOUT`` (1-3600 s, default 10 s).
"""

from __future__ import annotations

import os
import sys
import threading

from ..constants import watchdog as wd


def parse_timeout_env() -> float:
    """Timeout from the environment, clamped to the valid range; invalid
    values fall back to the default (reference ``processor.rs:194-211``)."""
    raw = os.environ.get(wd.TIMEOUT_ENV)
    if raw is None:
        return float(wd.DEFAULT_TIMEOUT_SECS)
    try:
        value = int(raw)
    except ValueError:
        return float(wd.DEFAULT_TIMEOUT_SECS)
    if value < wd.MIN_TIMEOUT_SECS or value > wd.MAX_TIMEOUT_SECS:
        return float(wd.DEFAULT_TIMEOUT_SECS)
    return float(value)


class WatchdogGuard:
    def __init__(self, timer: threading.Timer):
        self._timer = timer

    def cancel(self) -> None:
        self._timer.cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cancel()


def start_inference_watchdog(batch_size: int,
                             timeout_secs: float | None = None) -> WatchdogGuard:
    timeout = timeout_secs if timeout_secs is not None else parse_timeout_env()

    def _fire():
        sys.stderr.write(
            f"ERROR: inference batch (size {batch_size}) exceeded "
            f"{timeout:.0f}s watchdog timeout — the accelerator appears "
            f"wedged.\nTry halving the batch size "
            f"(--batch-size {max(1, batch_size // 2)}) or raising "
            f"{wd.TIMEOUT_ENV}.\n"
        )
        sys.stderr.flush()
        os._exit(75)  # hard exit: the device is unrecoverable in-process

    timer = threading.Timer(timeout, _fire)
    timer.daemon = True
    timer.start()
    return WatchdogGuard(timer)
