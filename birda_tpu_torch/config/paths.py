"""Platform configuration paths (reference ``src/config/paths.rs``).

Linux XDG layout: config ``~/.config/birda/``, cache ``~/.cache/birda/``;
macOS and Windows follow their platform conventions. The XLA compilation
cache (the TensorRT-engine-cache analogue) lives under the cache dir.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from ..constants import APP_NAME, compile_cache


def config_dir() -> Path:
    if sys.platform == "darwin":
        return Path.home() / "Library" / "Application Support" / APP_NAME
    if sys.platform == "win32":
        base = os.environ.get("APPDATA")
        return Path(base) / APP_NAME if base else Path.home() / APP_NAME
    base = os.environ.get("XDG_CONFIG_HOME")
    return (Path(base) if base else Path.home() / ".config") / APP_NAME


def cache_dir() -> Path:
    if sys.platform == "darwin":
        return Path.home() / "Library" / "Caches" / APP_NAME
    if sys.platform == "win32":
        base = os.environ.get("LOCALAPPDATA")
        return Path(base) / APP_NAME if base else Path.home() / APP_NAME / "cache"
    base = os.environ.get("XDG_CACHE_HOME")
    return (Path(base) if base else Path.home() / ".cache") / APP_NAME


def data_dir() -> Path:
    """Installed model assets."""
    if sys.platform == "darwin":
        return Path.home() / "Library" / "Application Support" / APP_NAME / "models"
    if sys.platform == "win32":
        base = os.environ.get("APPDATA")
        root = Path(base) / APP_NAME if base else Path.home() / APP_NAME
        return root / "models"
    base = os.environ.get("XDG_DATA_HOME")
    return (Path(base) if base else Path.home() / ".local" / "share") / APP_NAME / "models"


def config_file_path() -> Path:
    return config_dir() / "config.toml"


def xla_cache_dir() -> Path:
    """Persistent XLA compilation cache (machine-specific, regenerable)."""
    return cache_dir() / compile_cache.CACHE_DIR
