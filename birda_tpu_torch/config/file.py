"""Config file load/save/update (reference ``src/config/file.rs``).

- Loading a missing file yields defaults (first run needs no setup).
- Saving validates first, resolves a symlinked config path (including a
  dangling link — the user deliberately placed it), writes atomically, and
  creates new files 0600.
- ``update_config`` wraps the whole load-mutate-save in the config lock so
  concurrent writers serialize (#313 pattern).
"""

from __future__ import annotations

import os
import tomllib
from pathlib import Path
from typing import Callable

from ..errors import ConfigParse, ConfigRead, ConfigWrite
from ..locking.config_lock import ConfigLock
from ..utils import toml_writer
from ..utils.fs import NewFileMode, write_atomic
from . import paths
from .types import Config
from .validate import validate_config


def load_config(path: Path | str) -> Config:
    path = Path(path)
    if not path.exists():
        return Config()
    try:
        raw = path.read_bytes()
    except OSError as e:
        raise ConfigRead(str(path), str(e)) from e
    try:
        doc = tomllib.loads(raw.decode("utf-8"))
    except (tomllib.TOMLDecodeError, UnicodeDecodeError) as e:
        raise ConfigParse(str(path), str(e)) from e
    try:
        return Config.from_dict(doc)
    except (ValueError, KeyError, TypeError) as e:
        raise ConfigParse(str(path), str(e)) from e


def load_default_config() -> Config:
    return load_config(paths.config_file_path())


def resolve_link(path: Path) -> Path:
    """Follow a symlink chain even when dangling: the user placed the link at
    their config path on purpose, so the write belongs at its target."""
    seen = 0
    cur = path
    while cur.is_symlink() and seen < 40:
        target = os.readlink(cur)
        cur = Path(target) if os.path.isabs(target) else cur.parent / target
        seen += 1
    return cur


def save_config(config: Config, path: Path | str | None = None) -> None:
    validate_config(config)
    path = Path(path) if path is not None else paths.config_file_path()
    target = resolve_link(path)
    text = toml_writer.dumps(config.to_dict())
    try:
        write_atomic(target, text.encode("utf-8"), mode=NewFileMode.OWNER_ONLY)
    except OSError as e:
        raise ConfigWrite(str(target), str(e)) from e


def update_config(
    mutate: Callable[[Config], None], path: Path | str | None = None
) -> Config:
    """Locked read-modify-write of the config file."""
    path = Path(path) if path is not None else paths.config_file_path()
    with ConfigLock(path):
        config = load_config(path)
        mutate(config)
        save_config(config, path)
    return config
