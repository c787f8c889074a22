"""Exclusive lock serialising config read-modify-write.

Port of reference ``src/locking/config_lock.rs`` (closes the reference's
issue #313 pattern): each atomic save alone is not enough — two concurrent
writers both load the old file and the later save discards the earlier
edit, so the whole load-mutate-save is wrapped in a sibling
``config.toml.birda.lock`` held for the duration, acquired with retries
(50 ms interval, 5 s timeout).
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

from ..constants import config_lock as cl
from ..errors import ConfigLocked

# Separate from file_lock's registry on purpose (reference config_lock.rs
# module notes): one shared registry would let either type's cleanup remove
# the other's lock file.
_registry: set[Path] = set()
_registry_lock = threading.Lock()


def cleanup_all_config_locks() -> int:
    """Ctrl+C cleanup for config locks (reference ``lib.rs:342``)."""
    with _registry_lock:
        paths = list(_registry)
        _registry.clear()
    removed = 0
    for p in paths:
        try:
            p.unlink()
            removed += 1
        except OSError:
            pass
    return removed


class ConfigLock:
    def __init__(self, config_path: Path | str):
        self.lock_path = Path(str(config_path) + cl.LOCK_SUFFIX)
        self._held = False

    def acquire(self,
                timeout: float = cl.ACQUIRE_TIMEOUT_SECS,
                retry_interval: float = cl.RETRY_INTERVAL_SECS) -> "ConfigLock":
        deadline = time.monotonic() + timeout
        self.lock_path.parent.mkdir(parents=True, exist_ok=True)
        while True:
            try:
                fd = os.open(
                    self.lock_path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644
                )
            except FileExistsError:
                if time.monotonic() >= deadline:
                    raise ConfigLocked(timeout) from None
                time.sleep(retry_interval)
                continue
            # The lock file exists from here on: any failure writing the
            # (best-effort) pid body must still end with a HELD, removable
            # lock — leaving _held False would orphan it permanently (this
            # lock deliberately has no staleness breaking, see module docs).
            try:
                os.write(fd, str(os.getpid()).encode())
            except OSError:
                pass
            finally:
                os.close(fd)
            self._held = True
            # Register AFTER the successful create — the opposite ordering
            # from file_lock, and deliberate (reference config_lock.rs:
            # 120-123): only paths we actually acquired are ever registered,
            # so Ctrl+C cleanup can never remove a peer's lock. The cost is
            # a Ctrl+C in this create-to-register gap leaking our OWN lock
            # (loud: later writers fail ConfigLocked), which beats silently
            # deleting a peer's (lost config update — the #313 bug again).
            with _registry_lock:
                _registry.add(self.lock_path)
            return self

    def release(self) -> None:
        if not self._held:
            return
        self._held = False
        with _registry_lock:
            _registry.discard(self.lock_path)
        try:
            self.lock_path.unlink()
        except OSError:
            pass

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
