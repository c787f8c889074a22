"""The port's CLI subcommands against the JAX package's, command by command:
``version``, ``providers``, ``config {init,show,path,set}``, ``models
{list,list-available,add,check,info,remove,regions,install}``, the global
``--output-mode``, the bare-file ``analyze`` spelling, the first-run smart
help and the last-resort typed-error printer.

Each command runs through both CLIs (the JAX package's ``main`` under
click's test isolation, the port's ``main(argv)``) from the same state of
one ``XDG_*`` home: the home is restored between the two runs, and what
each run leaves in it (``config.toml``, installed files) must be equal,
byte for byte. Compared: the exit code, stdout in the human, json and
ndjson modes (the protocol's timestamps aside), and the ``Error:`` lines a
refusal prints to stderr; a usage error's message (click's ``Error:``,
argparse's ``error:``). ``providers`` lists other backends by design (the
TPU's there, the CUDA card's here), so it is compared by structure.
Installs are offline: the registry and the downloads are faked in both
packages alike.
"""

import hashlib
import io
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

import fixtures_onnx as fo
from fixtures_audio import write_wav

import birda_tpu.cli.main as jax_cli

import birda_tpu_torch.cli.main as port_cli

MODES = ["human", "json", "ndjson"]


class Home:
    """One XDG home, both CLIs, and the comparison of their runs."""

    def __init__(self, root: Path, capsys, monkeypatch):
        self.root = root
        self.capsys = capsys
        self.monkeypatch = monkeypatch
        for d in ("config", "cache", "data"):
            monkeypatch.setenv(f"XDG_{d.upper()}_HOME", str(root / d))
            (root / d).mkdir(parents=True, exist_ok=True)
        monkeypatch.delenv("BIRDA_OUTPUT_MODE", raising=False)

    # -- state ---------------------------------------------------------------
    def tree(self) -> dict:
        out = {}
        for d in ("config", "cache", "data"):
            for p in sorted((self.root / d).rglob("*")):
                if p.is_file() and not p.name.endswith(".lock"):
                    out[str(p.relative_to(self.root))] = p.read_bytes()
        return out

    def _snapshot(self) -> Path:
        snap = self.root.parent / (self.root.name + ".snap")
        shutil.rmtree(snap, ignore_errors=True)
        shutil.copytree(self.root, snap, symlinks=True)
        return snap

    def _restore(self, snap: Path) -> None:
        for d in ("config", "cache", "data"):
            shutil.rmtree(self.root / d, ignore_errors=True)
            shutil.copytree(snap / d, self.root / d, symlinks=True)
        shutil.rmtree(snap)

    # -- runs ----------------------------------------------------------------
    def _env_guard(self):
        return os.environ.get("BIRDA_OUTPUT_MODE")

    def _env_reset(self, saved):
        if saved is None:
            os.environ.pop("BIRDA_OUTPUT_MODE", None)
        else:
            os.environ["BIRDA_OUTPUT_MODE"] = saved

    def jax(self, argv, stdin=""):
        saved = self._env_guard()
        runner = CliRunner()
        with runner.isolation(input=stdin) as streams:
            try:
                code = jax_cli.main(list(argv)) or 0
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else \
                    (0 if e.code is None else 1)
            sys.stdout.flush()
            sys.stderr.flush()
            out = streams[0].getvalue().decode()
            err = streams[1].getvalue().decode()
        self._env_reset(saved)
        # click's test runner echoes each line a prompt reads, as a
        # terminal would; the port's stdout holds the prompt alone.
        for line in stdin.splitlines():
            out = out.replace(f": {line}\n", ": ", 1)
        return code, out, err

    def port(self, argv, stdin=""):
        saved = self._env_guard()
        self.capsys.readouterr()
        with self.monkeypatch.context() as m:
            m.setattr(sys, "stdin", io.StringIO(stdin))
            try:
                code = port_cli.main(list(argv))
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else \
                    (0 if e.code is None else 1)
        c = self.capsys.readouterr()
        self._env_reset(saved)
        return code, c.out, c.err

    def both(self, argv, stdin=""):
        """Both CLIs from the same state; the port's run leaves its state.
        Returns ((code, out, err), (code, out, err)) after checking that
        the two runs left the same files."""
        snap = self._snapshot()
        want = self.jax(argv, stdin)
        after_jax = self.tree()
        self._restore(snap)
        got = self.port(argv, stdin)
        assert self.tree() == after_jax, argv
        return want, got

    def same(self, argv, stdin="", code=None):
        """The same exit code, stdout and ``Error:`` lines."""
        (jc, jo, je), (pc, po, pe) = self.both(argv, stdin)
        assert pc == jc, (argv, jo, je, po, pe)
        if code is not None:
            assert jc == code, (argv, jo, je)
        assert normalize(po) == normalize(jo), argv
        assert errors(pe) == errors(je), argv
        return po, pe


def normalize(out: str):
    """stdout with the protocol's timestamps dropped: a JSON document or
    NDJSON lines parsed, text kept as it is."""
    text = out.strip()
    try:
        docs = json.loads(text) if text.startswith("[") else \
            [json.loads(line) for line in text.splitlines()]
    except ValueError:  # text, or TOML ("[defaults]")
        return out
    if not docs or not all(isinstance(d, dict) for d in docs):
        return out
    for d in docs:
        d.pop("timestamp", None)
    return docs


def errors(err: str) -> list[str]:
    """The error lines of stderr: the cause chain of a typed error."""
    return [ln for ln in err.splitlines()
            if ln.startswith(("Error: ", "  caused by: "))]


def usage_message(err: str) -> str:
    """A usage error's message: click's ``Error: m`` or argparse's
    ``prog: error: m``."""
    for ln in reversed(err.splitlines()):
        for mark in ("Error: ", "error: "):
            if mark in ln:
                return ln.split(mark, 1)[1]
    return ""


@pytest.fixture()
def home(tmp_path, capsys, monkeypatch):
    return Home(tmp_path / "home", capsys, monkeypatch)


def _mode(mode):
    return [] if mode == "human" else ["--output-mode", mode]


# -- version, providers, smart help, dispatch ----------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_version(home, mode):
    out, _ = home.same(["version", *_mode(mode)], code=0)
    if mode == "human":
        assert out == "birda 0.1.0\n"


@pytest.mark.parametrize("mode", ["json", "ndjson"])
def test_global_output_mode_reaches_the_subcommand(home, mode):
    home.same(["--output-mode", mode, "version"], code=0)
    home.same([f"--output-mode={mode}", "models", "list"], code=0)
    # A subcommand's own flag wins over the global one.
    home.same(["--output-mode", mode, "version", "--output-mode", "human"],
              code=0)


def test_version_flag(home):
    (jc, jo, _), (pc, po, _) = home.both(["--version"])
    assert jc == pc == 0
    assert po == jo == "birda, version 0.1.0\n"


def test_smart_help_without_arguments(home):
    out, _ = home.same([], code=0)
    assert out.startswith("No models configured.")
    home.same(["models", "add", "tiny", "--path", "synthetic:tiny",
               "--labels", "synthetic:tiny", "--type", "birdnet-v24"])
    out, _ = home.same([], code=0)
    assert out.startswith("Usage: birda [FILES]...")


@pytest.mark.parametrize("mode", MODES)
def test_providers_by_structure(home, mode):
    (jc, jo, _), (pc, po, _) = home.both(["providers", *_mode(mode)])
    assert jc == pc == 0
    if mode == "human":
        jl, pl = jo.splitlines(), po.splitlines()
        assert pl[0] == jl[0] == "Available execution providers:"
        assert "  cpu: CPU (always available)" in jl
        assert "  cpu: CPU (always available)" in pl
        assert [ln for ln in pl if ln.startswith("  cuda: ")]
        for text in ("Usage:", "--cpu", "--gpu",
                     "Explicit providers (fail if unavailable):"):
            assert any(text in ln for ln in jl)
            assert any(text in ln for ln in pl)
        return
    want, got = normalize(jo), normalize(po)
    assert [d["event"] for d in got] == [d["event"] for d in want]
    jp, pp = want[0]["payload"], got[0]["payload"]
    assert pp["result_type"] == jp["result_type"] == "providers"
    cpu = {"id": "cpu", "name": "CPU", "description": "CPU (always available)"}
    assert cpu in jp["providers"] and cpu in pp["providers"]
    assert all(set(p) == set(cpu) for p in pp["providers"])


def _recording(tmp_path):
    wav = tmp_path / "rec.wav"
    write_wav(wav, np.zeros(48_000, np.float32), 48_000)
    return wav


def test_bare_file_is_analyze(home, tmp_path, monkeypatch):
    """``birda rec.wav ...`` runs analyze over rec.wav in both, the global
    ``--output-mode`` included."""
    import birda_tpu_torch.orchestrator as port_orchestrator

    seen = {}

    def recorder(pkg):
        def analyze_files(options, config, reporter=None):
            seen[pkg] = ([str(p) for p in options.inputs],
                         type(reporter).__name__, reporter._buffered)
            return 0
        return analyze_files

    monkeypatch.setattr(jax_cli, "analyze_files", recorder("jax"))
    monkeypatch.setattr(port_orchestrator, "analyze_files",
                        recorder("port"))
    wav = _recording(tmp_path)
    argv = ["--output-mode", "ndjson", str(wav), "--model-path",
            "synthetic:tiny", "--labels-path", "synthetic:tiny",
            "--model-type", "birdnet-v24", "--cpu", "-q"]
    (jc, _, _), (pc, _, _) = home.both(argv)
    assert jc == pc == 0
    assert seen["port"] == seen["jax"] == ([str(wav)], "JsonReporter", False)


def test_last_resort_printer_renders_a_typed_error(home):
    """A corrupt config.toml under ``config show``: the typed error's cause
    chain and exit 1, never a traceback."""
    path = home.root / "config" / "birda" / "config.toml"
    path.parent.mkdir(parents=True)
    path.write_text("[defaults\nmodel = 1\n")
    _, err = home.same(["config", "show"], code=1)
    assert errors(err)


# -- config ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_config_init_path_show(home, mode):
    home.same(["config", "path", *_mode(mode)], code=0)
    home.same(["config", "init"], code=0)
    home.same(["config", "init"], code=0)  # already exists
    home.same(["config", "path", *_mode(mode)], code=0)
    home.same(["config", "show", *_mode(mode)], code=0)


VALID_SETS = [
    ("defaults.latitude", "-33.9"), ("defaults.longitude", "151.2"),
    ("defaults.min_confidence", "0.25"), ("defaults.overlap", "1.5"),
    ("defaults.batch_size", "64"), ("defaults.range_threshold", "0.05"),
    ("defaults.range_unmatched", "drop"), ("defaults.day_of_year", "120"),
    ("defaults.geomodel", "/g/geo.onnx"),
    ("defaults.geomodel_labels", "/g/geo.txt"),
    ("defaults.species_list_file", "/s/list.txt"),
    ("defaults.formats", "csv,table, json"),
    ("inference.device", "cpu"), ("output.default_format", "ndjson"),
]
#: An empty value clears a key back to its default.
CLEARS = [k for k, _ in VALID_SETS]
REFUSED_SETS = [
    ("defaults.batch_size", "100000"), ("defaults.latitude", "95"),
    ("defaults.bogus", "1"), ("inference.device", "quantum"),
    ("output.default_format", "xml"), ("defaults.formats", "csv,wav"),
    ("defaults.range_unmatched", "maybe"), ("defaults.min_confidence", "x"),
    ("defaults.model", "ghost"),
]


def test_config_set_writes_the_same_file(home):
    _add(home)
    for key, value in [*VALID_SETS, ("defaults.model", "tiny")]:
        out, _ = home.same(["config", "set", key, value], code=0)
        assert out == f"Set {key} = {value}\n"
    for mode in MODES:
        home.same(["config", "show", *_mode(mode)], code=0)
    for key in CLEARS:
        home.same(["config", "set", key, ""], code=0)
    home.same(["config", "show"], code=0)


@pytest.mark.parametrize("key,value", REFUSED_SETS)
def test_config_set_refusals_are_the_same(home, key, value):
    _, err = home.same(["config", "set", key, value], code=1)
    assert errors(err)


# -- models: list, add, check, info, remove, regions -------------------------------

def _add(home, name="tiny", path="synthetic:tiny", labels="synthetic:tiny",
         *extra):
    return home.same(["models", "add", name, "--path", str(path),
                      "--labels", str(labels), "--type", "birdnet-v24",
                      *extra], code=0)


@pytest.mark.parametrize("mode", MODES)
def test_models_list_and_add(home, mode):
    home.same(["models", "list", *_mode(mode)], code=0)
    _add(home)
    _, err = home.same(["models", "add", "tiny", "--path", "x", "--labels",
                        "y", "--type", "birdnet-v24"], code=1)
    assert "already exists" in errors(err)[0]
    _add(home, "other", "synthetic:tiny", "synthetic:tiny", "--default")
    home.same(["models", "list", *_mode(mode)], code=0)


def test_models_add_refuses_an_unknown_type(home):
    (jc, _, je), (pc, _, pe) = home.both(
        ["models", "add", "m", "--path", "x", "--labels", "y", "--type",
         "birdnet-v99"])
    assert jc == pc == 2
    assert "birdnet-v99" in usage_message(je)
    assert "birdnet-v99" in usage_message(pe)


@pytest.mark.parametrize("mode", MODES)
def test_models_check(home, tmp_path, mode):
    """A good model, a missing file, a graph preflight refuses (every
    finding listed), the geomodel line and a leftover partial download."""
    _add(home)
    _add(home, "gone", tmp_path / "missing.onnx", tmp_path / "missing.txt")
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(fo.model(
        [fo.node("NonZero", ["x"], ["y"])],
        inputs=[fo.value_info("x", [2, 3])],
        outputs=[fo.value_info("y", [2, "n"], elem_type=7)]))
    labels = tmp_path / "labels.txt"
    labels.write_text("a_b\n")
    _add(home, "bad", bad, labels)
    good = tmp_path / "geo.onnx"
    good.write_bytes(fo.make_fixture_geomodel(num_species=4))
    _add(home, "good", good, labels)
    models = home.root / "data" / "birda" / "models"
    models.mkdir(parents=True, exist_ok=True)
    (models / "perch.onnx.999999999.part").write_bytes(b"x")
    out, _ = home.same(["models", "check", *_mode(mode)], code=1)
    if mode == "human":
        assert "tiny: OK" in out and "good: OK" in out
        assert "bad: FAILED" in out and "NonZero" in out
        assert "leftover partial download" in out
    home.same(["models", "check", "--no-graph", *_mode(mode)], code=1)
    home.same(["models", "remove", "gone"], code=0)
    home.same(["models", "remove", "bad"], code=0)
    home.same(["models", "check", *_mode(mode)], code=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model_id", ["birdnet-v24", "birdnet-v30",
                                      "perch-v2", "geomodel", "tiny"])
def test_models_info(home, mode, model_id):
    _add(home)
    home.same(["models", "info", model_id, *_mode(mode)], code=0)
    if mode == "human" and model_id != "tiny":
        home.same(["models", "info", model_id, "--languages"])


def test_models_info_refusals(home):
    _, err = home.same(["models", "info", "ghost"], code=1)
    assert errors(err)


@pytest.mark.parametrize("model_id,code", [("birdnet-v30", 0),
                                           ("perch-v2", 0),
                                           ("birdnet-v24", 1),
                                           ("ghost", 1)])
def test_models_regions(home, model_id, code):
    home.same(["models", "regions", model_id], code=code)


@pytest.mark.parametrize("mode", MODES)
def test_models_list_available(home, mode):
    out, _ = home.same(["models", "list-available", *_mode(mode)], code=0)
    if mode == "human":
        assert "birdnet-v24" in out and "Range filter" in out


@pytest.mark.parametrize("mode", MODES)
def test_models_remove(home, mode):
    _add(home, "b")
    _add(home, "a")
    _add(home, "c")
    # Removing the default promotes the alphabetically first.
    home.same(["models", "remove", "b", *_mode(mode)], code=0)
    home.same(["models", "list", *_mode(mode)], code=0)
    home.same(["models", "remove", "a", *_mode(mode)], code=0)
    home.same(["models", "remove", "c", *_mode(mode)], code=0)  # none left
    _, err = home.same(["models", "remove", "ghost", *_mode(mode)], code=1)
    assert errors(err)


def test_models_remove_purge(home, tmp_path):
    """With stdin closed the prompt cancels (exit 0, nothing removed); with
    -y each owned file is deleted, and one another model still uses is
    kept."""
    models = home.root / "data" / "birda" / "models"
    models.mkdir(parents=True)
    own, shared = models / "own.onnx", models / "shared.txt"
    own.write_bytes(b"m")
    shared.write_text("a_b\n")
    _add(home, "one", own, shared)
    _add(home, "two", "synthetic:tiny", shared)
    out, _ = home.same(["models", "remove", "one", "--purge"], stdin="",
                       code=0)
    assert out.endswith("Removal cancelled.\n")
    home.same(["models", "remove", "one", "--purge"], stdin="n\n", code=0)
    out, _ = home.same(["models", "remove", "one", "--purge", "-y"], code=0)
    assert f"Deleted: {own}" in out and "Skipped (used by another" in out
    assert not own.exists() and shared.exists()
    home.same(["models", "remove", "two", "--purge"], stdin="y\n", code=0)
    assert not shared.exists()


# -- models install (offline) ------------------------------------------------------

class _Resp:
    def __init__(self, data):
        self._data = data
        self.headers = {"content-length": str(len(data))}

    def raise_for_status(self):
        pass

    def iter_content(self, n):
        for i in range(0, len(self._data), n):
            yield self._data[i:i + n]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


def _ref(url, data, name):
    return {"url": url, "filename": name,
            "sha256": hashlib.sha256(data).hexdigest(),
            "size_bytes": len(data)}


@pytest.fixture()
def fake_registry(monkeypatch):
    """One classifier ("mini"), one with regional variants ("tiles") and
    the range filter, served from memory to both packages."""
    import birda_tpu.registry.installer as jax_installer
    import birda_tpu.registry.loader as jax_loader
    from birda_tpu.registry.schema import Registry as JaxRegistry

    import birda_tpu_torch.registry.installer as port_installer
    import birda_tpu_torch.registry.loader as port_loader
    from birda_tpu_torch.registry.schema import Registry as PortRegistry

    model = fo.make_fixture_geomodel(num_species=5)
    labels = b"".join(f"Sp{i} x_Common {i}\n".encode() for i in range(5))
    geo_labels = b"".join(f"Geo{i} sp_Common {i}\n".encode()
                          for i in range(5))
    downloads = {"https://x/m.onnx": model, "https://x/l.txt": labels,
                 "https://x/geo.onnx": model, "https://x/geo.txt": geo_labels,
                 "https://x/eu.onnx": model}
    lic = {"type": "MIT", "commercial_use": True}
    files = {"model": _ref("https://x/m.onnx", model, "mini.onnx"),
             "labels": {"default_language": "en", "languages": [
                 {"code": "en", "name": "English", "url": "https://x/l.txt",
                  "filename": "mini-en.txt"}]}}
    doc = {
        "schema_version": "tpu-1.0", "registry_version": 1,
        "models": [
            {"id": "mini", "name": "Mini", "description": "fixture",
             "vendor": "test", "version": "1.0", "model_type": "birdnet-v24",
             "license": lic, "files": files},
            {"id": "tiles", "name": "Tiles", "description": "regional",
             "vendor": "test", "version": "2.0", "model_type": "birdnet-v30",
             "license": lic, "default_variant": "global-fp32",
             "variants": [
                 {"id": "global-fp32", "precision": "fp32", "classes": 5,
                  "model": _ref("https://x/m.onnx", model, "tiles.onnx"),
                  "labels": _ref("https://x/l.txt", labels,
                                 "tiles-en.txt")},
                 {"id": "eu-fp32", "precision": "fp32", "region": "europe",
                  "group_name": "Europe", "classes": 5,
                  "model": _ref("https://x/eu.onnx", model, "tiles-eu.onnx"),
                  "labels": _ref("https://x/l.txt", labels,
                                 "tiles-eu.txt")}]}],
        "range_filter": {
            "id": "birdnet-geomodel-v3", "name": "BirdNET Geomodel v3.0.2",
            "vendor": "Cornell Lab of Ornithology", "version": "3.0.2",
            "species_count": 5,
            "license": {"type": "CC-BY-SA-4.0", "commercial_use": True,
                        "share_alike": True},
            "model": _ref("https://x/geo.onnx", model, "geo.onnx"),
            "labels": _ref("https://x/geo.txt", geo_labels, "geo.txt")},
    }

    class FakeRequests:
        @staticmethod
        def get(url, **kw):
            return _Resp(downloads[url])

    for loader, installer, registry in (
            (jax_loader, jax_installer, JaxRegistry),
            (port_loader, port_installer, PortRegistry)):
        monkeypatch.setattr(loader, "load_registry",
                            lambda cache=None, r=registry: r.from_dict(doc))
        real = installer.download_verified
        monkeypatch.setattr(
            installer, "download_verified",
            lambda ref, dest, progress=None, session=None, real=real:
            real(ref, dest, progress, FakeRequests))
    return doc


@pytest.mark.parametrize("mode", MODES)
def test_models_install(home, fake_registry, mode):
    home.same(["models", "install", "mini", "-y", *_mode(mode)], code=0)
    home.same(["models", "install", "tiles", "--region", "europe",
               "--variant", "eu-fp32", "-y", "--default", *_mode(mode)],
              code=0)
    home.same(["models", "install", "geomodel", "-y", *_mode(mode)], code=0)
    # A reinstall replaces the entry and keeps its files.
    home.same(["models", "install", "mini", "-y", *_mode(mode)], code=0)
    home.same(["models", "list", *_mode(mode)], code=0)
    home.same(["models", "check", *_mode(mode)], code=0)
    home.same(["models", "info", "tiles", *_mode(mode)], code=0)


@pytest.mark.parametrize("argv", [
    ["models", "install", "ghost", "-y"],
    ["models", "install", "mini", "--region", "europe", "-y"],
    ["models", "install", "mini", "--variant", "int8", "-y"],
    ["models", "install", "tiles", "--region", "atlantis", "-y"],
    ["models", "install", "mini", "--language", "xx", "-y"],
])
@pytest.mark.parametrize("mode", MODES)
def test_models_install_refusals(home, fake_registry, argv, mode):
    _, err = home.same([*argv, *_mode(mode)], code=1)
    assert errors(err)


def test_models_install_license_refused_with_closed_stdin(home,
                                                          fake_registry):
    home.same(["models", "install", "mini"], stdin="")


@pytest.mark.parametrize("mode", MODES)
def test_analyze_interrupt_releases_locks_alike(home, tmp_path, monkeypatch,
                                                mode):
    """Ctrl+C during ``analyze`` (the SIGINT handler each CLI installs,
    called while a file lock is held): the lock is released, the
    cancellation reported in the structured modes, exit 130, alike."""
    import signal

    import birda_tpu.locking.file_lock as jax_lock

    import birda_tpu_torch.locking.file_lock as port_lock
    import birda_tpu_torch.orchestrator as port_orchestrator

    locks = []
    (tmp_path / "out").mkdir()

    def interrupted(lock_mod):
        def analyze_files(options, config, reporter=None):
            # The guard is kept alive: dropping it releases the lock.
            locks.append(lock_mod.FileLock.acquire(
                tmp_path / "held.wav", tmp_path / "out"))
            assert locks[-1].lock_path.exists()
            signal.getsignal(signal.SIGINT)(signal.SIGINT, None)
        return analyze_files

    monkeypatch.setattr(jax_cli, "analyze_files", interrupted(jax_lock))
    monkeypatch.setattr(port_orchestrator, "analyze_files",
                        interrupted(port_lock))
    wav = _recording(tmp_path)
    previous = signal.getsignal(signal.SIGINT)
    try:
        _, err = home.same(
            [str(wav), "--model-path", "synthetic:tiny", "--labels-path",
             "synthetic:tiny", "--model-type", "birdnet-v24", "--cpu",
             *_mode(mode)], code=130)
    finally:
        signal.signal(signal.SIGINT, previous)
    assert len(locks) == 2
    assert not any(lock.lock_path.exists() for lock in locks)
    assert "Released 1 lock(s)" in err
