"""Advisory per-input file locks for multi-process / multi-host work sharing.

Port of the reference's lock-file protocol (``src/locking/file_lock.rs``):
``<filename>.birda.lock`` in the output directory, created with O_EXCL, body
a JSON record (pid, hostname, start time, input path) for debugging;
staleness judged by mtime; a global registry lets the SIGINT handler clean
up every held lock. The mechanism works unchanged across TPU hosts over a
shared filesystem (SURVEY §2.3).
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import threading
from pathlib import Path

from ..constants import LOCK_FILE_EXTENSION
from ..errors import FileLocked, LockCreate, LockRemove, OutputDirCreateFailed

_registry: set[Path] = set()
_registry_lock = threading.Lock()


def _register(path: Path) -> None:
    with _registry_lock:
        _registry.add(path)


def _unregister(path: Path) -> None:
    with _registry_lock:
        _registry.discard(path)


def _owned_by_this_process(path: Path) -> bool:
    """True when the lock body parses and names this pid, or the file is
    already gone (unlinking is then a harmless no-op).

    Empty or unparseable bodies are NOT treated as ours: registration
    happens before creation, so between a foreign process's O_EXCL create
    and its pid write, a path we lost the create race on is briefly a
    foreign live lock with an empty body. Leaking an empty lock is
    recoverable via the stale-lock timeout; deleting a live foreign lock
    causes duplicate processing.
    """
    try:
        body = path.read_text()
    except FileNotFoundError:
        return True  # gone already; unlink below is a no-op
    except OSError:
        return False  # unreadable: can't prove ownership, don't touch it
    if not body.strip():
        return False
    try:
        doc = json.loads(body)
        return (
            doc.get("pid") == os.getpid()
            # Locks live next to the audio on what may be a SHARED
            # filesystem (the multi-process sharing protocol's whole
            # point): a pid match alone can be a coincidence with a
            # process on another host, so the hostname must agree too.
            and doc.get("hostname") == (socket.gethostname() or "unknown")
        )
    except (ValueError, AttributeError):
        return False


def cleanup_all_locks() -> int:
    """Remove every lock this process holds (Ctrl+C handler; reference
    ``lib.rs:339-346``). Returns the number removed.

    Ownership is verified before unlinking: registration happens BEFORE
    creation (so a Ctrl+C between create and register cannot leak — the
    reference's ordering), which means a registered path may actually be
    ANOTHER process's live lock when our own create lost the race; deleting
    it would put two workers on one file — the exact duplicate-processing
    the lock exists to prevent.
    """
    with _registry_lock:
        paths = list(_registry)
        _registry.clear()
    removed = 0
    for p in paths:
        if not _owned_by_this_process(p):
            continue
        try:
            p.unlink()
            removed += 1
        except OSError:
            pass
    return removed


class FileLock:
    """RAII-style lock guard; use as a context manager or call release()."""

    def __init__(self, lock_path: Path):
        self.lock_path = lock_path
        self._released = False

    @staticmethod
    def lock_path_for(input_path: Path | str, output_dir: Path | str) -> Path:
        name = Path(input_path).name or "unknown"
        return Path(output_dir) / f"{name}{LOCK_FILE_EXTENSION}"

    @classmethod
    def acquire(cls, input_path: Path | str, output_dir: Path | str) -> "FileLock":
        input_path = Path(input_path)
        output_dir = Path(output_dir)
        lock_path = cls.lock_path_for(input_path, output_dir)
        try:
            output_dir.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise OutputDirCreateFailed(str(output_dir), str(e)) from e

        # Register BEFORE creation so a Ctrl+C between create and register
        # cannot leak the lock.
        _register(lock_path)
        try:
            fd = os.open(lock_path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        except FileExistsError:
            _unregister(lock_path)
            raise FileLocked(str(lock_path)) from None
        except OSError as e:
            _unregister(lock_path)
            raise LockCreate(str(lock_path), str(e)) from e

        from ..parallel.mesh import process_index

        info = {
            "pid": os.getpid(),
            "hostname": socket.gethostname() or "unknown",
            # Pod rank (0 single-host): the cross-host tie-break /
            # observability field for multi-host directory runs
            # (SURVEY §2.3 row 3).
            "process_index": process_index(),
            "started": datetime.datetime.now(datetime.timezone.utc)
            .isoformat()
            .replace("+00:00", "Z"),
            "input": str(input_path),
        }
        try:
            os.write(fd, json.dumps(info, indent=2).encode())
        except OSError:
            pass  # body is best-effort debugging info
        finally:
            os.close(fd)
        return cls(lock_path)

    @staticmethod
    def is_locked(input_path: Path | str, output_dir: Path | str) -> bool:
        return FileLock.lock_path_for(input_path, output_dir).exists()

    @staticmethod
    def is_stale(input_path: Path | str, output_dir: Path | str,
                 max_age_secs: float) -> bool:
        lock_path = FileLock.lock_path_for(input_path, output_dir)
        try:
            mtime = lock_path.stat().st_mtime
        except OSError:
            return False
        import time

        return (time.time() - mtime) > max_age_secs

    @staticmethod
    def remove_stale(input_path: Path | str, output_dir: Path | str) -> None:
        lock_path = FileLock.lock_path_for(input_path, output_dir)
        try:
            lock_path.unlink()
        except OSError as e:
            raise LockRemove(str(lock_path), str(e)) from e

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        _unregister(self.lock_path)
        try:
            self.lock_path.unlink()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass
