"""Atomic, durable filesystem writes.

Semantics follow the reference atomic writer (``src/utils/fs.rs:101,193,501``):

- write to a temp file created beside the target, fsync the file, rename over
  the target, then fsync the parent directory (and any newly created ancestor
  directories' parents);
- a symlink whose target exists is followed and the *target* replaced; a
  dangling symlink is not followed (``resolve_link`` in config does that
  deliberately for the config file only);
- a target that exists and is not a regular file (device, FIFO) is written in
  place with no temporary — renaming over a device node would destroy it;
- the replaced file's permission bits are carried onto the published file
  (setuid/setgid/sticky dropped); a brand-new file takes ``mode``;
- while the fill runs the temporary is no more permissive than owner-only,
  and the published mode is applied *before* the fsync so a crash cannot
  publish the file still private.
"""

from __future__ import annotations

import os
import stat
import tempfile
from pathlib import Path
from typing import Callable, IO


class NewFileMode:
    """Mode for a file that did not previously exist."""

    #: Respect the process umask (0o666 & ~umask).
    UMASK = "umask"
    #: Owner read/write only (0o600) — for config files with secrets.
    OWNER_ONLY = "owner_only"


_PERMISSION_BITS = 0o777  # setuid/setgid/sticky deliberately dropped


def _resolve_existing_link(path: Path) -> Path:
    """Follow a symlink chain only while the next hop exists.

    A dangling symlink is returned as-is rather than resolved, so we never
    create directories toward a target that may not be the caller's own path.
    """
    seen = 0
    cur = path
    while cur.is_symlink() and cur.exists() and seen < 40:
        cur = cur.parent / os.readlink(cur) if not os.path.isabs(os.readlink(cur)) else Path(os.readlink(cur))
        seen += 1
    return cur


def _missing_ancestors(directory: Path) -> list[Path]:
    """Ancestor directories that do not yet exist, deepest last."""
    missing: list[Path] = []
    cur = directory
    while not cur.exists():
        missing.append(cur)
        parent = cur.parent
        if parent == cur:
            break
        cur = parent
    missing.reverse()
    return missing


def sync_parent_directory(path: Path) -> None:
    """fsync the directory containing ``path`` so its entry is durable."""
    parent = path.parent if str(path.parent) else Path(".")
    try:
        fd = os.open(parent, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return  # platforms/filesystems that refuse directory opens
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_atomic_with(
    path: Path | str,
    fill: Callable[[IO[bytes]], None],
    mode: str = NewFileMode.UMASK,
) -> None:
    """Replace ``path`` with whatever ``fill`` writes, atomically and durably."""
    path = Path(path)
    target = _resolve_existing_link(path)

    # Non-regular existing targets (FIFO, device, /dev/stdout) are written in
    # place — they have no contents to replace and a rename would destroy them.
    try:
        st = os.stat(target, follow_symlinks=False)
        in_place = not stat.S_ISREG(st.st_mode) and not stat.S_ISLNK(st.st_mode)
    except FileNotFoundError:
        st = None
        in_place = False
    if in_place:
        with open(target, "wb") as f:
            fill(f)
        return

    directory = target.parent if str(target.parent) else Path(".")
    created_dirs = _missing_ancestors(directory)
    directory.mkdir(parents=True, exist_ok=True)

    published_mode = (st.st_mode & _PERMISSION_BITS) if st is not None else None

    fd, temp_name = tempfile.mkstemp(prefix=f".{target.name}.", dir=directory)
    temp_path = Path(temp_name)
    try:
        # mkstemp creates at 0600 already — the "no more permissive than
        # owner-only while writing" half is inherent.
        with os.fdopen(fd, "wb", closefd=False) as f:
            fill(f)
            f.flush()

        if published_mode is not None:
            os.fchmod(fd, published_mode)
        elif mode == NewFileMode.UMASK:
            umask = os.umask(0)
            os.umask(umask)
            os.fchmod(fd, 0o666 & ~umask)
        # OWNER_ONLY: already 0600 from mkstemp.

        os.fsync(fd)
        os.close(fd)
        fd = -1
        os.replace(temp_path, target)
    except BaseException:
        if fd >= 0:
            os.close(fd)
        try:
            temp_path.unlink()
        except OSError:
            pass
        raise

    sync_parent_directory(target)
    # Newly created ancestors each need their own parent's entry flushed, or a
    # crash right after a first write on a fresh install loses the directory
    # entry along with the file, having reported success.
    for d in created_dirs:
        sync_parent_directory(d)


def write_atomic(
    path: Path | str, contents: bytes, mode: str = NewFileMode.UMASK
) -> None:
    """Byte-slice case of :func:`write_atomic_with`."""
    write_atomic_with(path, lambda f: f.write(contents) and None, mode)
