"""Self-update (reference ``src/update/``).

Fetches the latest-release manifest from GitHub, compares semver, downloads
the platform asset, verifies its sha256, extracts it, and swaps the running
executable keeping a ``.backup`` — with a dev-build guard so an un-tagged
development install never self-replaces (reference ``mod.rs:58-104``,
``replace.rs:65-97``).
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import re
import shutil
import sys
import tarfile
import tempfile
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .. import __version__
from ..constants import download as dl
from ..errors import (
    UpdateChecksumMismatch,
    UpdateDevBuild,
    UpdateExeNotFound,
    UpdateExtractFailed,
    UpdateFetchFailed,
    UpdateManifestParse,
    UpdateReplaceFailed,
    UpdateUnsupportedPlatform,
)

RELEASES_URL = "https://api.github.com/repos/birda-tpu/birda-tpu/releases/latest"


@dataclass
class UpdateInfo:
    version: str
    asset_url: str
    asset_name: str
    sha256: Optional[str] = None
    #: Release's expected runtime library versions (from the optional
    #: ``birda-runtime.json`` sidecar asset), e.g. {"jax": "0.9.0"}.
    runtime: Optional[dict] = None


def platform_asset_key() -> str:
    """``birda-<os>-<arch>`` asset naming (reference ``platform.rs:9``)."""
    system = {"linux": "linux", "darwin": "macos", "win32": "windows"}.get(
        sys.platform
    )
    if system is None:
        raise UpdateUnsupportedPlatform(sys.platform)
    arch = {"x86_64": "x86_64", "AMD64": "x86_64", "aarch64": "aarch64",
            "arm64": "aarch64"}.get(platform.machine(), platform.machine())
    return f"birda-{system}-{arch}"


def parse_semver(version: str) -> tuple[int, int, int]:
    m = re.match(r"v?(\d+)\.(\d+)\.(\d+)", version)
    if not m:
        raise UpdateManifestParse(f"bad version '{version}'")
    return tuple(int(g) for g in m.groups())


def is_dev_build(version: str = __version__) -> bool:
    """Pre-1.0 and -dev suffixed builds refuse to self-update."""
    return "dev" in version or version.startswith("0.")


def check_for_update(session=None, current: str = __version__
                     ) -> Optional[UpdateInfo]:
    """None when already current; UpdateInfo when newer exists."""
    try:
        import requests

        sess = session or requests
        resp = sess.get(RELEASES_URL, timeout=dl.CONNECT_TIMEOUT_SECS)
        resp.raise_for_status()
        manifest = resp.json()
    except Exception as e:  # noqa: BLE001
        raise UpdateFetchFailed(str(e)) from e

    try:
        latest = manifest["tag_name"]
        assets = manifest.get("assets", [])
    except (KeyError, TypeError) as e:
        raise UpdateManifestParse(str(e)) from e

    if parse_semver(latest) <= parse_semver(current):
        return None

    key = platform_asset_key()
    asset = next((a for a in assets if key in a.get("name", "")), None)
    if asset is None:
        raise UpdateUnsupportedPlatform(key)

    sha = None
    sha_asset = next(
        (a for a in assets if a.get("name") == asset["name"] + ".sha256"), None
    )
    if sha_asset is not None:
        try:
            sha = sess.get(sha_asset["browser_download_url"],
                           timeout=dl.CONNECT_TIMEOUT_SECS).text.split()[0]
        except Exception:  # noqa: BLE001 — checksum sidecar is best-effort
            sha = None
    runtime = None
    rt_asset = next(
        (a for a in assets if a.get("name") == "birda-runtime.json"), None
    )
    if rt_asset is not None:
        try:
            runtime = json.loads(sess.get(
                rt_asset["browser_download_url"],
                timeout=dl.CONNECT_TIMEOUT_SECS).text)
        except Exception:  # noqa: BLE001 — compat sidecar is best-effort
            runtime = None
    return UpdateInfo(
        version=latest,
        asset_url=asset["browser_download_url"],
        asset_name=asset["name"],
        sha256=sha,
        runtime=runtime,
    )


def check_library_versions(info: UpdateInfo) -> list[str]:
    """Runtime-compatibility warnings before a swap (the reference warns
    when the release's CUDA toolkit/cuDNN differ from the build-embedded
    versions, ``mod.rs:242-256``; the TPU analogue compares the release's
    expected jax/libtpu against the running environment). Warnings, not
    errors — the swap proceeds, informed."""
    if not info.runtime:
        return []
    import importlib

    warnings = []
    for lib in ("jax", "libtpu"):
        want = info.runtime.get(lib)
        if want is None:
            continue
        try:
            have = importlib.import_module(lib).__version__
        except Exception:  # noqa: BLE001 — absent lib: nothing to compare
            continue
        if have != want:
            warnings.append(
                f"release {info.version} expects {lib} {want}, this "
                f"environment has {have} — consider updating it alongside"
            )
    return warnings


def current_executable() -> Path:
    exe = Path(sys.argv[0]).resolve()
    if not exe.exists():
        raise UpdateExeNotFound()
    return exe


def perform_update(info: UpdateInfo, session=None,
                   target: Optional[Path] = None) -> Path:
    """Download, verify, extract, swap. Returns the replaced path."""
    if is_dev_build():
        raise UpdateDevBuild()
    target = target if target is not None else current_executable()

    import logging

    for w in check_library_versions(info):
        logging.getLogger(__name__).warning("%s", w)

    try:
        import requests

        sess = session or requests
        resp = sess.get(info.asset_url, timeout=(
            dl.CONNECT_TIMEOUT_SECS, dl.REQUEST_TIMEOUT_MINS * 60
        ))
        resp.raise_for_status()
        payload = resp.content
    except Exception as e:  # noqa: BLE001
        raise UpdateFetchFailed(str(e)) from e

    if info.sha256:
        got = hashlib.sha256(payload).hexdigest()
        # Uppercase expected hex must still match (reference checksum.rs).
        if got != info.sha256.lower():
            raise UpdateChecksumMismatch(info.sha256, got)

    with tempfile.TemporaryDirectory() as td:
        archive = Path(td) / info.asset_name
        archive.write_bytes(payload)
        extracted = _extract_binary(archive, Path(td))
        return replace_binary(target, extracted)


def _extract_binary(archive: Path, dest: Path) -> Path:
    out = dest / "extracted"
    out.mkdir()
    try:
        if archive.name.endswith((".tar.gz", ".tgz")):
            with tarfile.open(archive) as tf:
                tf.extractall(out, filter="data")
        elif archive.name.endswith(".zip"):
            with zipfile.ZipFile(archive) as zf:
                zf.extractall(out)
        else:
            return archive  # bare binary
    except (tarfile.TarError, zipfile.BadZipFile, OSError) as e:
        raise UpdateExtractFailed(str(e)) from e
    # Match the exact binary names only (reference ``replace.rs:97`` looks
    # for the precise asset-key name): a loose prefix match would "install"
    # whatever file happens to sort first — e.g. a bundled
    # ``birda-runtime.json`` sidecar.
    key = platform_asset_key()
    wanted = {"birda", "birda.exe", key, key + ".exe"}
    for p in sorted(out.rglob("*")):
        if p.is_file() and p.name in wanted:
            return p
    raise UpdateExtractFailed("no birda binary in archive")


def replace_binary(target: Path, new_binary: Path) -> Path:
    """Swap with a kept backup (reference ``replace.rs:97``)."""
    backup = target.with_suffix(target.suffix + ".backup")
    try:
        shutil.copy2(target, backup)
        mode = target.stat().st_mode
        tmp = target.with_suffix(".new")
        shutil.copy2(new_binary, tmp)
        os.chmod(tmp, mode)
        os.replace(tmp, target)
    except OSError as e:
        raise UpdateReplaceFailed(str(e)) from e
    return target
