"""Geomodel resolution (reference ``src/config/geomodel.rs:96-200``).

Resolves the BirdNET Geomodel v3.0.2 assets for range filtering:

1. explicit ``defaults.geomodel``/``geomodel_labels`` paths from config;
2. otherwise the standard install location under the models directory;
3. only the copy birda manages (path == the registry install path) has its
   sha256 re-verified against the registry pin — a user's own path is taken
   on trust, it may legitimately be a different build (geomodel.rs:110-128);
   a corrupt managed copy is re-downloaded, not loaded (geomodel.rs:131-138);
4. when unavailable, a :class:`GeomodelUnavailable` carries the reason: the
   analyze path degrades to unfiltered with a warning, the ``species``
   command fails (the geomodel IS the feature there).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..errors import GeomodelNotInstalled, GeomodelPathsIncomplete
from ..registry.installer import GEOMODEL_INSTALL_ID
from ..registry.schema import Registry
from .types import Config

logger = logging.getLogger(__name__)


@dataclass
class InstalledRangeFilter:
    model_path: Path
    labels_path: Path
    verified: bool = False


@dataclass
class GeomodelUnavailable:
    """The geomodel could not be resolved; ``reason`` says why (reference
    ``GeomodelResolution::Unavailable``, config/geomodel.rs). On the analyze
    path the caller logs "Range filtering disabled: {reason}" and continues
    unfiltered (lib.rs:219-222); the species command treats it as fatal."""

    reason: str


def config_with_override(
    config: Config,
    geomodel_path: Optional[Path],
    geomodel_labels_path: Optional[Path],
) -> Config:
    """Config view with ``defaults.geomodel(_labels)`` replaced — the
    ``--geomodel-path`` CLI override, shared by analyze and species (the
    reference's global flags reach both, args.rs geomodel_path notes).
    Returns the original config untouched when no override is given."""
    if geomodel_path is None:
        return config
    import copy

    cfg = copy.deepcopy(config)
    cfg.defaults.geomodel = geomodel_path
    cfg.defaults.geomodel_labels = geomodel_labels_path
    return cfg


def default_geomodel_paths(registry: Registry) -> Optional[tuple[Path, Path]]:
    from ..registry.installer import models_dir

    if registry.range_filter is None:
        return None
    d = models_dir()
    return (
        d / registry.range_filter.model.filename,
        d / registry.range_filter.labels.filename,
    )


def _verify(path: Path, expected_sha: Optional[str]) -> bool:
    """True iff the digest matches. A read error is NOT a checksum failure:
    re-downloading a file that is fine will not fix a failing disk, so the
    OSError propagates as the real error (reference geomodel.rs:140-144)."""
    if not expected_sha:
        return True
    from ..registry.installer import sha256_file

    return sha256_file(path) == expected_sha.lower()


def prompt_for_download(entry, corrupt: bool = False) -> bool:
    """Offer the geomodel download on a terminal (reference
    ``geomodel.rs::prompt_for_download``).

    Written to stderr, not stdout: interactivity is decided by stdin being
    a terminal, so ``birda ... > results.txt`` from a terminal still
    prompts; on stdout the prompt would land in the redirected file and the
    user would see an unexplained hang on the read.

    ``corrupt=True``: an installed copy exists but failed checksum
    verification — say that, not "not installed" (a user who just
    installed it would conclude the install silently failed)."""
    import sys

    license_type = getattr(getattr(entry, "license", None), "type", None)
    state = ("whose installed copy failed checksum verification"
             if corrupt else "which is not installed")
    sys.stderr.write(
        f"Range filtering needs the {entry.name or entry.id}, {state}.\n"
        f"  Model: {human_size(getattr(entry.model, 'size_bytes', None))}"
        f"    Labels: {human_size(getattr(entry.labels, 'size_bytes', None))}"
        f"    Licence: {license_type or 'unknown'}\n"
        "Download it now? [y/N]: "
    )
    sys.stderr.flush()
    try:
        line = sys.stdin.readline()
    except (OSError, ValueError):
        # ValueError: stdin CLOSED (not just EOF) — an embedding app;
        # decline gracefully like every other closed-stdin prompt.
        return False
    return line.strip().lower() in ("y", "yes")


def resolve_geomodel(
    config: Config,
    registry: Registry,
    allow_download: bool = False,
    progress=None,
    session=None,
    interactive: bool = False,
) -> "InstalledRangeFilter | GeomodelUnavailable":
    """Resolve geomodel assets, or say why they are unavailable.

    The analyze path logs ``Range filtering disabled: {reason}`` and
    continues unfiltered (reference ``lib.rs:219-222``); the species command
    raises :class:`GeomodelNotInstalled` instead (``require_geomodel``).

    ``interactive=True`` (stdin is a TTY and output is human-mode — the
    caller decides, reference ``geomodel.rs:158``) offers the download on
    stderr when it would otherwise be unavailable; ``allow_download``
    (``-y``/``--accept-license``) skips the prompt entirely.
    """
    explicit_model = config.defaults.geomodel
    explicit_labels = config.defaults.geomodel_labels
    if (explicit_model is None) != (explicit_labels is None):
        raise GeomodelPathsIncomplete(
            "defaults.geomodel and defaults.geomodel_labels must be set together"
        )

    entry = registry.range_filter
    registry_paths = default_geomodel_paths(registry)

    if explicit_model is not None:
        model_path, labels_path = explicit_model, explicit_labels
    elif registry_paths is not None:
        model_path, labels_path = registry_paths
    else:
        return GeomodelUnavailable("no geomodel asset in the registry")

    # "Ours to verify" is decided by which FILE this is, not by how the path
    # was reached: 'models install geomodel' records its own install path in
    # config, so keying on "came from config" would exempt exactly the copy
    # birda manages (reference geomodel.rs:110-126).
    birda_managed = (
        registry_paths is not None
        and (model_path, labels_path) == registry_paths
    )

    corrupt_managed = False
    if model_path.exists() and labels_path.exists():
        if not birda_managed:
            # A path pointing somewhere else is taken on trust: it may
            # legitimately be a different build of the geomodel, and its
            # checksum is not ours to police (geomodel.rs:124-128).
            return InstalledRangeFilter(model_path, labels_path, verified=True)
        if _verify(model_path, entry.model.sha256):
            return InstalledRangeFilter(model_path, labels_path, verified=True)
        # Genuine mismatch of the copy birda manages: re-download rather
        # than load corrupt bytes on every later run (geomodel.rs:131-138).
        # The "will be downloaded again" promise is only made below, on
        # the branches that actually download.
        corrupt_managed = True
    elif not birda_managed:
        # A configured path pointing outside the models directory is a
        # configuration error when missing — not something to paper over by
        # downloading to a different location (geomodel.rs:147-157).
        return GeomodelUnavailable(
            f"configured geomodel path {model_path} does not exist; correct "
            f"defaults.geomodel or run 'birda models install "
            f"{GEOMODEL_INSTALL_ID}'"
        )

    name = entry.name or entry.id
    install_hint = (f"run 'birda models install {GEOMODEL_INSTALL_ID}' to "
                    "enable range filtering")
    if not allow_download:
        # A missing geomodel is never a hard error here: coordinates in
        # config enable range filtering implicitly, so failing would break
        # automated pipelines on upgrade. Non-interactive runs degrade with
        # the reason; a terminal user is offered the download
        # (geomodel.rs::acquire).
        if not interactive:
            if corrupt_managed:
                return GeomodelUnavailable(
                    f"the installed copy of {name} failed checksum "
                    f"verification; re-run 'birda models install "
                    f"{GEOMODEL_INSTALL_ID}' to replace it"
                )
            return GeomodelUnavailable(
                f"{name} is not installed; {install_hint}"
            )
        if not prompt_for_download(entry, corrupt=corrupt_managed):
            return GeomodelUnavailable(f"download declined; {install_hint}")

    if corrupt_managed:
        logger.warning(
            "Installed %s failed checksum verification and will be "
            "downloaded again", name,
        )
    from ..registry.installer import install_range_filter

    model_path, labels_path = install_range_filter(
        entry, progress=progress, session=session
    )
    return InstalledRangeFilter(model_path, labels_path, verified=True)


def require_geomodel(
    config: Config, registry: Registry, allow_download: bool = False,
    progress=None, session=None, interactive: bool = False,
) -> InstalledRangeFilter:
    """Fatal variant for commands where the geomodel is the feature."""
    resolved = resolve_geomodel(
        config, registry, allow_download, progress, session,
        interactive=interactive,
    )
    if isinstance(resolved, GeomodelUnavailable):
        raise GeomodelNotInstalled()
    return resolved


def human_size(size_bytes: Optional[int]) -> str:
    """Render a byte count for humans (reference ``config/geomodel.rs::
    human_size``): MB past 1 MiB, KB below, "unknown size" for None —
    the caller decides whether an unknown is acceptable."""
    if size_bytes is None:
        return "unknown size"
    mib = 1024.0 * 1024.0
    if size_bytes >= mib:
        return f"{size_bytes / mib:.1f} MB"
    return f"{size_bytes / 1024.0:.0f} KB"


def total_download_size(entry) -> Optional[int]:
    """Model + labels, or None unless BOTH sizes are declared — a
    half-total reads as the whole (reference ``registry/mod.rs:160``)."""
    model = getattr(entry.model, "size_bytes", None)
    labels = getattr(entry.labels, "size_bytes", None)
    if model is None or labels is None:
        return None
    return model + labels
