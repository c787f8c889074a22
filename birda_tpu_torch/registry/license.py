"""License acceptance gate (reference ``src/registry/license.rs``).

Non-commercial or share-alike licenses require an explicit interactive yes
before download; ``--accept-license`` (or a non-TTY with acceptance already
recorded) skips the prompt. Acceptance is recorded per (model id, license
type) so re-installs don't re-ask.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..config import paths
from ..utils.fs import write_atomic
from .schema import LicenseInfo

ACCEPTANCES_FILE = "license_acceptances.json"


def _acceptances_path() -> Path:
    return paths.config_dir() / ACCEPTANCES_FILE


def _load_acceptances() -> dict:
    p = _acceptances_path()
    try:
        return json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def is_accepted(model_id: str, license_info: LicenseInfo) -> bool:
    return _load_acceptances().get(model_id) == license_info.type


def record_acceptance(model_id: str, license_info: LicenseInfo) -> None:
    # Serialized read-modify-write: two concurrent installs must not lose
    # each other's acceptance (the exact issue-#313 pattern ConfigLock
    # closes for config.toml).
    from ..locking.config_lock import ConfigLock

    with ConfigLock(_acceptances_path()):
        acc = _load_acceptances()
        acc[model_id] = license_info.type
        write_atomic(_acceptances_path(), json.dumps(acc, indent=2).encode())


def needs_prompt(license_info: LicenseInfo) -> bool:
    """Permissive commercial-use licenses install silently."""
    return not license_info.commercial_use or license_info.share_alike


def license_summary(model_name: str, license_info: LicenseInfo,
                    vendor: str = "") -> str:
    """Render the license terms the user is accepting, as a pure string.

    Split from the prompt so tests assert on the CONTENT (reference #291:
    the printing version was tested without assertions, so a summary that
    silently dropped the share-alike obligation still passed a green
    suite). Every obligation the gate prompts for must appear here."""
    lines = [
        f"{model_name} is distributed under {license_info.type}"
        + (f" ({license_info.url})" if license_info.url else ""),
        f"  Commercial use: "
        f"{'Allowed' if license_info.commercial_use else 'Not allowed'}",
        f"  Attribution required: "
        f"{'Yes' if license_info.attribution_required else 'No'}",
        f"  Share-alike required: "
        f"{'Yes' if license_info.share_alike else 'No'}",
    ]
    obligations = []
    if not license_info.commercial_use:
        obligations.append("  - Use for non-commercial purposes only")
    if license_info.attribution_required:
        who = vendor or "the model vendor"
        obligations.append(f"  - Provide attribution to {who}")
    if license_info.share_alike:
        obligations.append(
            "  - Share derivatives under the same license "
            f"({license_info.type})")
    if obligations:
        lines.append("By using this model, you agree to:")
        lines.extend(obligations)
    return "\n".join(lines) + "\n"


def prompt_license_acceptance(
    model_id: str,
    model_name: str,
    license_info: LicenseInfo,
    assume_yes: bool = False,
    input_fn=input,
    vendor: str = "",
) -> bool:
    """Returns True when the user may proceed. Records acceptance."""
    if not needs_prompt(license_info):
        return True
    if is_accepted(model_id, license_info):
        return True
    if assume_yes:
        record_acceptance(model_id, license_info)
        return True
    if not sys.stdin.isatty():
        sys.stderr.write(
            f"{model_name} is licensed {license_info.type}; pass "
            f"--accept-license to accept non-interactively.\n"
        )
        return False
    sys.stderr.write(
        "\n" + license_summary(model_name, license_info, vendor=vendor))
    try:
        answer = input_fn("Accept the license terms? [y/N] ")
    except EOFError:
        return False
    if answer.strip().lower() in ("y", "yes"):
        record_acceptance(model_id, license_info)
        return True
    return False
