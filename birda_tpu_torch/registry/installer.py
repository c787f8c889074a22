"""Model asset download + install (reference ``src/registry/installer.rs``).

Download protocol: stream to a **pid-qualified** ``.part`` file (concurrent
installs cannot collide), verify sha256 BEFORE the rename, fsync the file
then the directory, then rename onto the final name — an interrupted or
corrupt transfer can never leave a truncated asset at the destination.
Hugging Face URLs honor the ``HF_ENDPOINT`` mirror variable the HF client
libraries already use.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path
from typing import Callable, Optional

from ..config import paths as config_paths
from ..constants import download as dl
from ..errors import DownloadFailed, DownloadInstallFailed, UpdateChecksumMismatch
from ..utils.fs import sync_parent_directory
from .schema import FileRef, RangeFilterEntry, Registry, RegistryModel, Variant

logger = logging.getLogger(__name__)

#: The id a user types to install/inspect the shared range filter
#: (``birda models install geomodel``) — the install handle, deliberately
#: not the registry asset id (reference ``src/registry/installer.rs:13``).
GEOMODEL_INSTALL_ID = "geomodel"


def find_obsolete_files(directory: Path) -> list[Path]:
    """Files from earlier versions that are no longer used and can be
    deleted (e.g. a leftover ``birdnet-v24-meta.onnx``, replaced by the
    shared Geomodel v3.0.2) — reported by ``models check``, never deleted
    automatically (reference ``src/registry/installer.rs:393``)."""
    from ..constants import obsolete_files

    found = []
    for name in obsolete_files.NAMES:
        candidate = directory / name
        if candidate.is_file():
            found.append(candidate)
    return found


def models_dir() -> Path:
    return config_paths.data_dir()


def apply_hf_mirror(url: str) -> str:
    """Rewrite the canonical HF origin to the user's configured mirror."""
    endpoint = os.environ.get(dl.HF_ENDPOINT_ENV)
    if endpoint and url.startswith(dl.HUGGING_FACE_ENDPOINT):
        return endpoint.rstrip("/") + url[len(dl.HUGGING_FACE_ENDPOINT):]
    return url


def sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_verified(
    file_ref: FileRef,
    dest_dir: Path,
    progress: Optional[Callable[[int, int], None]] = None,
    session=None,
) -> Path:
    """Download one asset with the atomic .part protocol. Returns the final
    path (short-circuits when the file already exists with a good hash)."""
    dest_dir.mkdir(parents=True, exist_ok=True)
    final = dest_dir / file_ref.filename

    if final.exists() and file_ref.sha256:
        if sha256_file(final) == file_ref.sha256.lower():
            return final
        logger.warning("existing %s fails checksum; re-downloading", final.name)

    part = dest_dir / f"{file_ref.filename}.{os.getpid()}.{dl.PARTIAL_SUFFIX}"
    url = apply_hf_mirror(file_ref.url)

    try:
        import requests

        sess = session or requests
        with sess.get(
            url, stream=True,
            timeout=(dl.CONNECT_TIMEOUT_SECS, dl.REQUEST_TIMEOUT_MINS * 60),
        ) as resp:
            resp.raise_for_status()
            total = int(resp.headers.get("content-length", 0)) or (
                file_ref.size_bytes or 0
            )
            done = 0
            h = hashlib.sha256()
            with open(part, "wb") as f:
                for chunk in resp.iter_content(1 << 20):
                    f.write(chunk)
                    h.update(chunk)
                    done += len(chunk)
                    if progress:
                        progress(done, total)
                f.flush()
                os.fsync(f.fileno())
    except Exception as e:  # noqa: BLE001
        try:
            part.unlink()
        except OSError:
            pass
        raise DownloadFailed(file_ref.filename, str(e)) from e

    if file_ref.sha256:
        got = h.hexdigest()
        # Expected digests compare case-insensitively: a manifest or .sha256
        # sidecar may carry uppercase hex (reference update/checksum.rs
        # test_verify_sha256_accepts_uppercase_expected).
        if got != file_ref.sha256.lower():
            try:
                part.unlink()
            except OSError:
                pass
            raise UpdateChecksumMismatch(file_ref.sha256, got)

    try:
        os.replace(part, final)
        sync_parent_directory(final)
    except OSError as e:
        raise DownloadInstallFailed(file_ref.filename, str(e)) from e
    return final


class InstalledModel:
    """Paths produced by an install, to be recorded in config.toml."""

    def __init__(self, model_path: Path, labels_path: Path,
                 extra: dict[str, Path] | None = None,
                 variant: Optional[str] = None, region: Optional[str] = None):
        self.model_path = model_path
        self.labels_path = labels_path
        self.extra = extra or {}
        self.variant = variant
        self.region = region


def install_model(
    model: RegistryModel,
    language: Optional[str] = None,
    dest_dir: Path | None = None,
    variant: Optional[Variant] = None,
    progress=None,
    session=None,
) -> InstalledModel:
    """Install a registry model (simple files or a selected variant)."""
    from ..errors import LanguageNotFound, ModelHasNoLanguages

    dest = dest_dir if dest_dir is not None else models_dir()

    if model.has_variants:
        v = variant or _default_variant(model)
        if v.labels is None:
            raise ModelHasNoLanguages(model.id)
        model_existed = (dest / v.model.filename).exists()
        model_path = download_verified(v.model, dest, progress, session)
        try:
            labels_path = download_verified(v.labels, dest, progress, session)
        except BaseException:
            # A failed SECOND download must not leave a verified model
            # with no labels: presence-based is_installed checks would
            # then lie. Only files THIS install created are removed — a
            # pre-existing model (reinstall/upgrade) stays (reference
            # installer.rs:605-609, roll_back).
            if not model_existed:
                _roll_back([model_path])
            raise
        return InstalledModel(model_path, labels_path,
                              variant=v.id, region=v.region)

    files = model.files
    if files is None:
        raise ModelHasNoLanguages(model.id)
    # The requested language must EXIST — no silent fallback to the
    # default — and it is validated BEFORE downloading anything
    # (reference ``installer.rs:499-505``: a user who asked for German
    # labels must not silently receive English ones, nor pay for a model
    # download that ends in an error). ``language=None`` means "the
    # model's default".
    code = language or files.default_language
    lang = model.language(code)
    if lang is None:
        raise LanguageNotFound(code, model.id)
    created: list[Path] = []

    def fetch(ref) -> Path:
        existed = (dest / ref.filename).exists()
        path = download_verified(ref, dest, progress, session)
        if not existed:
            created.append(path)
        return path

    try:
        model_path = fetch(files.model)
        labels_path = fetch(FileRef(url=lang.url, filename=lang.filename))
        extra = {key: fetch(ref) for key, ref in files.extra.items()}
    except BaseException:
        # Roll back every file THIS install created so a failed
        # multi-file install (model + labels + BSG extras) leaves
        # nothing half-installed; pre-existing files stay (reference
        # installer.rs:605-609, roll_back).
        _roll_back(created)
        raise
    return InstalledModel(model_path, labels_path, extra)


def _roll_back(paths: list[Path]) -> None:
    """Best-effort removal of files a FAILED install created (reference
    installer.rs:629-637)."""
    for p in paths:
        try:
            Path(p).unlink()
        except OSError:
            pass


def _default_variant(model: RegistryModel) -> Variant:
    from .selection import select_variant

    return select_variant(model)


def install_range_filter(
    entry: RangeFilterEntry, dest_dir: Path | None = None,
    progress=None, session=None,
) -> tuple[Path, Path]:
    """Install the shared geomodel + labels; returns (model, labels) paths."""
    dest = dest_dir if dest_dir is not None else models_dir()
    model_path = download_verified(entry.model, dest, progress, session)
    labels_path = download_verified(entry.labels, dest, progress, session)
    return model_path, labels_path
