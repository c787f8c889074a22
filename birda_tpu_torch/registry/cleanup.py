"""Superseded-file cleanup (reference ``src/registry/cleanup.rs``).

Scope is one config entry: the files a removed or reinstalled entry owned
(model, labels, BSG extras), minus anything the replacement keeps and
anything another entry still references. Published filenames never change
across versions, so an upgrade writes new files beside the old ones —
without this every upgrade would leak the previous download (reference
lib.rs:2303-2305). The scope matters: a directory-wide sweep of
"registry-known but unreferenced" files would also delete downloads the
user deliberately keeps un-configured.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Sequence

from ..config.types import Config, ModelConfig

logger = logging.getLogger(__name__)

_OWNED_ATTRS = (
    "path", "labels", "meta_model",
    "bsg_calibration", "bsg_migration", "bsg_distribution_maps",
)


def owned_paths(model: ModelConfig) -> list[Path]:
    """Every file a config entry owns, in a stable order."""
    out = []
    for attr in _OWNED_ATTRS:
        v = getattr(model, attr, None)
        if v is not None:
            out.append(Path(v))
    return out


def referenced_model_paths(config: Config) -> set[Path]:
    """Files any configured entry (or the shared geomodel setting) owns."""
    refs: set[Path] = set()
    for m in config.models.values():
        refs.update(owned_paths(m))
    for attr in ("geomodel", "geomodel_labels"):
        v = getattr(config.defaults, attr)
        if v is not None:
            refs.add(Path(v))
    return refs


def orphaned_files(
    config: Config, key: str, keeping: Sequence[Path] = (),
) -> list[Path]:
    """Files the entry at ``key`` owns that nothing else will reference.

    Call BEFORE overwriting/removing the entry (reference cleanup.rs:37-66):
    ``config`` still holds the previous entry, ``keeping`` is what the
    replacement install reuses. Deduped — an entry whose path and labels
    are the same file would otherwise list twice.
    """
    previous = config.models.get(key)
    if previous is None:
        return []
    keeping_set = {Path(p) for p in keeping}
    still_referenced: set[Path] = set()
    for other_key, model in config.models.items():
        if other_key != key:
            still_referenced.update(owned_paths(model))
    for attr in ("geomodel", "geomodel_labels"):
        v = getattr(config.defaults, attr)
        if v is not None:
            still_referenced.add(Path(v))

    orphans: list[Path] = []
    for path in owned_paths(previous):
        if path in keeping_set or path in still_referenced:
            continue
        if path in orphans:
            continue
        orphans.append(path)
    return orphans


def remove_orphans(paths: Sequence[Path]) -> list[tuple[Path, OSError]]:
    """Best-effort deletion; returns the failures (reference
    cleanup.rs:74-90). A missing file is already done, not a failure, and
    one failure never skips the rest."""
    failures: list[tuple[Path, OSError]] = []
    for p in paths:
        try:
            Path(p).unlink(missing_ok=True)
        except OSError as e:
            failures.append((Path(p), e))
    return failures
