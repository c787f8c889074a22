"""Self-update in the port (``birda_tpu_torch/update``, a copy of the JAX
package's module) and its ``update`` command, against the JAX package's,
with the release fetch mocked as ``tests/test_update.py`` mocks it: the
same session double answers both packages, and they give the same update
info, the same typed refusals with the same messages, the same swapped
binary, and through the CLI the same stdout, errors and exit codes.
"""

import hashlib
import io
import tarfile

import pytest
from click.testing import CliRunner

import birda_tpu.cli.main as jax_cli
import birda_tpu.update as jax_update
import birda_tpu.update.mod as jax_mod

import birda_tpu_torch.cli.main as port_cli
import birda_tpu_torch.update as port_update
import birda_tpu_torch.update.mod as port_mod

from test_update import _FakeResp, _FakeSession

PACKAGES = [(jax_update, jax_mod), (port_update, port_mod)]


def _manifest(tag, assets):
    return {"tag_name": tag, "assets": assets}


def _asset(name, url="https://dl/x.tar.gz"):
    return {"name": name, "browser_download_url": url}


def _outcome(fn):
    """What ``fn()`` returns, or its error's class name and message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


def _info_fields(info):
    return None if info is None else (info.version, info.asset_url,
                                      info.asset_name, info.sha256,
                                      info.runtime)


SESSIONS = {
    "up_to_date": {"releases/latest": _manifest("v0.0.1", [])},
    "newer": {"releases/latest": _manifest("v2.0.0", [
        _asset("{key}.tar.gz")])},
    "newer_with_checksum": {"releases/latest": _manifest("v2.0.0", [
        _asset("{key}.tar.gz"),
        _asset("{key}.tar.gz.sha256", "https://dl/x.tar.gz.sha256")]),
        "x.tar.gz.sha256": "ab" * 32 + "  {key}.tar.gz\n"},
    "no_platform_asset": {"releases/latest": _manifest("v2.0.0", [
        _asset("birda-solaris-sparc.tar.gz")])},
    "runtime_sidecar": {"releases/latest": _manifest("v2.0.0", [
        _asset("{key}.tar.gz"),
        _asset("birda-runtime.json", "https://dl/runtime.json")]),
        "runtime.json": '{"jax": "99.0.0"}'},
    "bad_tag": {"releases/latest": _manifest("main", [])},
    "fetch_failure": {},
}


def _session(name, key):
    out = {}
    for k, v in SESSIONS[name].items():
        if isinstance(v, dict):
            v = {**v, "assets": [{a: b.replace("{key}", key)
                                  for a, b in asset.items()}
                                 for asset in v["assets"]]}
            out[k] = _FakeResp(v)
        else:
            out[k] = _FakeResp(text=v.replace("{key}", key))
    return _FakeSession(out)


@pytest.mark.parametrize("name", list(SESSIONS))
def test_check_for_update_matches(name):
    got = []
    for pkg, _ in PACKAGES:
        key = pkg.platform_asset_key()
        kind, value = _outcome(lambda: pkg.check_for_update(
            session=_session(name, key), current="1.0.0"))
        got.append((kind, _info_fields(value) if kind == "ok" else value))
    assert got[1] == got[0]


def test_semver_and_platform_key_match():
    for text in ("1.2.3", "v10.0.1", "main", "1.2"):
        assert _outcome(lambda: port_update.parse_semver(text)) == \
            _outcome(lambda: jax_update.parse_semver(text))
    assert port_update.platform_asset_key() == \
        jax_update.platform_asset_key()
    assert port_update.is_dev_build() == jax_update.is_dev_build() is True


def _archive(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


@pytest.mark.parametrize("case", ["swap", "decoy_then_binary",
                                  "checksum_mismatch", "dev_build"])
def test_perform_update_matches(tmp_path, monkeypatch, case):
    results = []
    for i, (pkg, mod) in enumerate(PACKAGES):
        key = pkg.platform_asset_key()
        if case != "dev_build":
            monkeypatch.setattr(mod, "is_dev_build", lambda *a: False)
        members = [(key, b"#!/bin/sh\necho new\n")]
        if case == "decoy_then_binary":
            members.insert(0, ("birda-runtime.json", b'{"jax": "9.9"}'))
        payload = _archive(members)
        sha = ("0" * 64 if case == "checksum_mismatch"
               else hashlib.sha256(payload).hexdigest())
        target = tmp_path / str(i) / "birda"
        target.parent.mkdir()
        target.write_bytes(b"old binary")
        target.chmod(0o755)
        info = pkg.UpdateInfo("v9.9.9", "https://dl/a.tar.gz",
                              f"{key}.tar.gz", sha256=sha)
        kind, value = _outcome(lambda: mod.perform_update(
            info, session=_FakeSession({"dl/": _FakeResp(content=payload)}),
            target=target))
        backup = target.parent / "birda.backup"
        results.append((kind, value == target if kind == "ok" else value,
                        target.read_bytes(),
                        backup.read_bytes() if backup.exists() else None))
    assert results[1] == results[0]


@pytest.mark.parametrize("case", ["up_to_date", "check_only", "install",
                                  "no_platform_asset", "fetch_failure"])
def test_update_command_matches(tmp_path, monkeypatch, capsys, case):
    """``birda update [--check]`` through both CLIs, the fetch mocked."""
    out = []
    for i, (pkg, mod) in enumerate(PACKAGES):
        key = pkg.platform_asset_key()
        sessions = {"up_to_date": "up_to_date", "check_only": "newer",
                    "install": "newer",
                    "no_platform_asset": "no_platform_asset",
                    "fetch_failure": "fetch_failure"}
        session = _session(sessions[case], key)
        real_check = mod.check_for_update
        monkeypatch.setattr(pkg, "check_for_update",
                            lambda real=real_check, s=session:
                            real(session=s, current="1.0.0"))
        swapped = []
        monkeypatch.setattr(pkg, "perform_update",
                            lambda info, swapped=swapped:
                            swapped.append(info.version))
        argv = ["update"] + (["--check"] if case == "check_only" else [])
        if i == 0:
            r = CliRunner().invoke(jax_cli.cli, argv)
            out.append((r.exit_code, r.stdout, r.stderr, swapped))
        else:
            capsys.readouterr()
            code = port_cli.main(argv)
            c = capsys.readouterr()
            out.append((code, c.out, c.err, swapped))
    assert out[1] == out[0]
