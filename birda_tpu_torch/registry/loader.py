"""Registry load with the three-outcome cache policy.

Port of reference ``src/registry/loader.rs:21-121``: the registry ships
embedded in the package and is cached on disk (where updates can land).

- cache **unparseable** -> replace it with the embedded copy (it is ours and
  it is broken);
- cache **unreadable** (permissions, I/O) -> use the embedded copy from
  memory but do NOT destroy the file (it may be fine next time);
- cache **older** than the embedded registry version -> upgrade the cache.
"""

from __future__ import annotations

import json
import logging
from importlib import resources
from pathlib import Path

from ..config import paths
from ..errors import RegistryParse
from ..utils.fs import write_atomic
from .schema import Registry

logger = logging.getLogger(__name__)

CACHE_FILENAME = "registry.json"


def embedded_registry_text() -> str:
    return (
        resources.files("birda_tpu_torch.registry")
        .joinpath("registry.json")
        .read_text(encoding="utf-8")
    )


def load_embedded() -> Registry:
    return Registry.from_dict(json.loads(embedded_registry_text()))


def cache_path() -> Path:
    return paths.cache_dir() / CACHE_FILENAME


def load_registry(cache: Path | None = None) -> Registry:
    """Load the registry, preferring a newer on-disk cache."""
    cache = cache if cache is not None else cache_path()
    embedded = load_embedded()

    if not cache.exists():
        # Bootstrap the bundled registry onto disk (reference loader.rs
        # test_a_missing_registry_is_bootstrapped_onto_disk): later reads —
        # including other processes' — see the same file updates land in.
        try:
            cache.parent.mkdir(parents=True, exist_ok=True)
            write_atomic(cache, embedded_registry_text().encode())
        except OSError:
            pass
        return embedded

    try:
        raw_bytes = cache.read_bytes()
    except OSError as e:
        # Unreadable: use memory, never destroy the file.
        logger.warning("registry cache unreadable (%s); using embedded", e)
        return embedded

    try:
        # Non-UTF8 bytes are the same outcome as non-JSON bytes: the file is
        # ours and it is broken, repair it (reference loader.rs
        # test_a_registry_whose_bytes_are_not_utf8_is_repaired).
        cached = Registry.from_dict(json.loads(raw_bytes.decode("utf-8")))
    except (UnicodeDecodeError, json.JSONDecodeError, RegistryParse) as e:
        # Unparseable: it is our file and it is broken — replace it.
        logger.warning("registry cache corrupt (%s); replacing with embedded", e)
        try:
            write_atomic(cache, embedded_registry_text().encode())
        except OSError:
            pass
        return embedded

    if cached.registry_version < embedded.registry_version:
        logger.info(
            "registry cache v%d older than embedded v%d; upgrading",
            cached.registry_version, embedded.registry_version,
        )
        try:
            write_atomic(cache, embedded_registry_text().encode())
        except OSError:
            pass
        return embedded

    return cached


def save_registry_cache(registry_text: str, cache: Path | None = None) -> None:
    cache = cache if cache is not None else cache_path()
    write_atomic(cache, registry_text.encode())
