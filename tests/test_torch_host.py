"""The host layers of the PyTorch port are its own copies of the JAX
package's modules (birda_tpu_torch/{audio,config,output,onnx,...}).

- No module of the port, and not chip_smoke.py, imports ``birda_tpu``,
  ``jax``, ``jaxlib`` or ``flax``, at any depth (an AST scan, so imports
  inside functions count too).
- Each copy computes what its original computes: the full-scale fixture
  bytes, the fusion pass's node list, every writer's bytes, the error
  taxonomy and the CLI's exit code for each error, the model contracts, the
  decoder's samples and the host resampler — all equal, not within a bound.
"""

import ast
import datetime
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

from fixtures_audio import write_wav

import birda_tpu.errors as jax_errors
from birda_tpu.models import contracts as jax_contracts
from birda_tpu.onnx import fullscale as jax_fullscale

import birda_tpu_torch.errors as port_errors
from birda_tpu_torch.models import contracts as port_contracts
from birda_tpu_torch.onnx import fullscale as port_fullscale

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("birda_tpu", "jax", "jaxlib", "flax")
#: The test helpers ``chip_smoke.py`` imports on the card's machine, which
#: has no jax: the op case table, the spectrogram-transformer graph and the
#: front-end route graphs.
CHIP_HELPERS = ["tests/torch_op_cases.py", "tests/torch_seq_graphs.py",
                "tests/torch_route_graphs.py"]
#: The port's tools, run on the card's machine.
TOOLS = ["scripts/torch_accept_asset.py", "scripts/verify_kernels_cuda.py"]
PORT_SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "birda_tpu_torch").rglob("*.py")) + ["chip_smoke.py"] \
    + CHIP_HELPERS + TOOLS


def _imported_roots(path: Path) -> list[tuple[int, str]]:
    """(line, top-level package) of every absolute import in the file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, (node.module or "").split(".")[0]))
    return out


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_no_import_of_the_jax_package_or_jax(rel):
    bad = [(line, mod) for line, mod in _imported_roots(REPO / rel)
           if mod in FORBIDDEN]
    assert bad == [], f"{rel} imports {bad}"


def test_import_scan_covers_the_int8_modules():
    for rel in ("birda_tpu_torch/onnx/quantize.py",
                "birda_tpu_torch/onnx/int8_accuracy.py",
                "birda_tpu_torch/onnx/lowering.py"):
        assert rel in PORT_SOURCES


def test_import_scan_covers_the_native_and_parallel_modules():
    for rel in ("birda_tpu_torch/ops/melspec.py",
                "birda_tpu_torch/models/backbone.py",
                "birda_tpu_torch/models/zoo.py",
                "birda_tpu_torch/parallel/__init__.py",
                "birda_tpu_torch/parallel/mesh.py",
                "birda_tpu_torch/parallel/sharding.py",
                "birda_tpu_torch/locking/file_lock.py"):
        assert rel in PORT_SOURCES


def test_import_scan_covers_every_helper_chip_smoke_imports():
    """Every module of ``tests/`` that ``chip_smoke.py`` imports is
    scanned too."""
    helpers = {f"tests/{mod}.py" for _, mod in _imported_roots(
        REPO / "chip_smoke.py") if (REPO / "tests" / f"{mod}.py").exists()}
    assert helpers == set(CHIP_HELPERS)
    assert set(CHIP_HELPERS) <= set(PORT_SOURCES)


def test_import_scan_covers_the_tools():
    assert set(TOOLS) <= set(PORT_SOURCES)
    for rel in TOOLS:
        assert (REPO / rel).exists()


def test_every_jax_module_has_a_port_counterpart():
    """The port has a module of the same subpackage and name for every
    module of the JAX package."""
    def tree(pkg):
        return {str(p.relative_to(REPO / pkg))
                for p in (REPO / pkg).rglob("*.py")}

    assert tree("birda_tpu") - tree("birda_tpu_torch") == set()


def test_import_scan_sees_imports_inside_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from birda_tpu.errors import X\n"
                   "    import jax.numpy as jnp\n")
    assert [m for _, m in _imported_roots(src)] == ["birda_tpu", "jax"]


# -- fixtures and the fusion pass ---------------------------------------------

SPECS = ["BIRDNET_V24_SPEC", "BIRDNET_V30_SPEC", "PERCH_V2_SPEC"]


@pytest.mark.parametrize("spec", SPECS)
def test_fullscale_fixture_bytes_are_identical(spec):
    want = jax_fullscale.build(
        jax_fullscale.tiny_spec(getattr(jax_fullscale, spec)), seed=1)
    got = port_fullscale.build(
        port_fullscale.tiny_spec(getattr(port_fullscale, spec)), seed=1)
    assert got.model_bytes == want.model_bytes
    assert (got.param_count, got.macs, got.frames) == \
        (want.param_count, want.macs, want.frames)


@pytest.mark.parametrize("spec", ["BIRDNET_V24_SPEC", "BIRDNET_V30_SPEC"])
def test_fusion_pass_leaves_the_same_nodes(spec):
    from birda_tpu.onnx import fuse as jax_fuse
    from birda_tpu.onnx import proto as jax_proto

    from birda_tpu_torch.onnx import fuse as port_fuse
    from birda_tpu_torch.onnx import proto as port_proto

    g = jax_fullscale.cached_build(
        jax_fullscale.tiny_spec(getattr(jax_fullscale, spec)), seed=1)
    jm = jax_proto.load_model(g.model_bytes)
    pm = port_proto.load_model(g.model_bytes)
    assert port_fuse.fuse_mel_frontend(pm.graph) == \
        jax_fuse.fuse_mel_frontend(jm.graph) == 1

    def nodes(m):
        return [(n.op_type, n.name, list(n.inputs), list(n.outputs),
                 sorted(n.attrs)) for n in m.graph.nodes]

    assert nodes(pm) == nodes(jm)
    assert sorted(pm.graph.initializers) == sorted(jm.graph.initializers)


# -- the int8 path's host code ----------------------------------------------------

def _source(module, name) -> str:
    return inspect.getsource(getattr(module, name))


@pytest.mark.parametrize("module,names", [
    ("int8_accuracy", ["CrossingCounts", "Criteria", "Int8AccuracyReport",
                       "compare_scores"]),
    ("quantize", ["_structurally_eligible", "CalibrationResult",
                  "calibration_signals", "_smoothing_vectors"]),
])
def test_int8_host_code_is_a_copy(module, names):
    """The numpy parts of int8_accuracy and the host-only parts of quantize
    are the JAX package's, byte for byte, constants included."""
    import importlib

    jax_mod = importlib.import_module(f"birda_tpu.onnx.{module}")
    port_mod = importlib.import_module(f"birda_tpu_torch.onnx.{module}")
    for name in names:
        assert _source(port_mod, name) == _source(jax_mod, name), name
    consts = [n for n in vars(jax_mod) if n.isupper()
              and isinstance(getattr(jax_mod, n), (int, float, tuple))]
    assert consts
    for name in consts:
        assert getattr(port_mod, name) == getattr(jax_mod, name), name


def test_lower_int8_selection_walk_is_a_copy():
    """lower_int8's selection and boundary-policy walk — everything from the
    parsed graph on — is the JAX package's text."""
    from birda_tpu.onnx import quantize as jq

    from birda_tpu_torch.onnx import quantize as tq

    def walk(mod):
        src = _source(mod, "lower_int8")
        return src[src.index("    graph = model.graph\n"):]

    assert walk(tq) == walk(jq)
    assert walk(tq).count("\n") > 200


# -- writers --------------------------------------------------------------------

WRITERS = ["csv", "raven", "audacity", "kaleidoscope", "parquet", "json"]


class _FrozenDatetime:
    """The ``datetime`` module with a fixed ``now``: the JSON writer stamps
    its analysis date."""

    timezone = datetime.timezone

    class datetime(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime.datetime(2026, 5, 1, 6, 30, tzinfo=tz)


def _detections(types, wav):
    rows = [(0.0, 3.0, "Turdus merula_Eurasian Blackbird", 0.91234),
            (0.0, 3.0, "Parus major_Great Tit, \"common\"", 0.5),
            (1.5, 4.5, "Erithacus rubecula", 0.123456)]
    out = []
    for t0, t1, label, conf in rows:
        d = types.Detection.from_label(label, conf, t0, t1, wav)
        d.metadata.lat, d.metadata.lon, d.metadata.week = 60.2, 24.9, 20
        d.metadata.model, d.metadata.overlap = "birdnet-v24", 1.5
        d.metadata.min_conf = 0.1
        out.append(d)
    return out


def _write(pkg: str, fmt: str, path: Path, wav: Path, monkeypatch) -> bytes:
    import importlib

    types = importlib.import_module(f"{pkg}.output.types")
    columns = ["lat", "lon", "week", "model", "overlap", "min_conf"]
    if fmt == "csv":
        writer = importlib.import_module(f"{pkg}.output.csv").CsvWriter(
            path, columns, True)
    elif fmt == "raven":
        writer = importlib.import_module(
            f"{pkg}.output.raven").RavenWriter(path)
    elif fmt == "audacity":
        writer = importlib.import_module(
            f"{pkg}.output.audacity").AudacityWriter(path)
    elif fmt == "kaleidoscope":
        writer = importlib.import_module(
            f"{pkg}.output.kaleidoscope").KaleidoscopeWriter(path)
    elif fmt == "parquet":
        writer = importlib.import_module(
            f"{pkg}.output.parquet").ParquetWriter(path, columns)
    else:
        mod = importlib.import_module(f"{pkg}.output.json_file")
        monkeypatch.setattr(mod, "datetime", _FrozenDatetime)
        writer = mod.JsonResultWriter(
            path, source_file=wav.name, model="birdnet-v24",
            min_confidence=0.1, overlap=1.5, audio_duration=9.0, lat=60.2,
            lon=24.9, week=20)
    with writer as w:
        for d in _detections(types, wav):
            w.write_detection(d)
    return path.read_bytes()


@pytest.mark.parametrize("fmt", WRITERS)
def test_writers_write_identical_bytes(tmp_path, monkeypatch, fmt):
    if fmt == "parquet":
        pytest.importorskip("pyarrow")
    wav = tmp_path / "meadow.wav"
    want = _write("birda_tpu", fmt, tmp_path / f"jax.{fmt}", wav, monkeypatch)
    got = _write("birda_tpu_torch", fmt, tmp_path / f"port.{fmt}", wav,
                 monkeypatch)
    assert want
    assert got == want


# -- errors ---------------------------------------------------------------------

ERROR_NAMES = sorted(
    name for name, obj in vars(jax_errors).items()
    if isinstance(obj, type) and issubclass(obj, jax_errors.BirdaError))


@pytest.fixture()
def cli_home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    wav = tmp_path / "rec.wav"
    write_wav(wav, np.zeros(48_000, np.float32), 48_000)
    model = tmp_path / "m.onnx"
    model.write_bytes(b"")
    labels = tmp_path / "labels.txt"
    labels.write_text("A_a\n")
    return ["analyze", str(wav), "--model-path", str(model),
            "--labels-path", str(labels), "--model-type", "birdnet-v24",
            "--cpu", "-q"]


@pytest.mark.parametrize("name", ERROR_NAMES)
def test_error_class_maps_to_the_same_exit_code(name, cli_home, monkeypatch,
                                                capsys):
    """The same class under the same subsystem base with the same message,
    and the CLI exits with the same code when the analysis raises it."""
    from click.testing import CliRunner

    import birda_tpu.cli.main as jax_cli

    import birda_tpu_torch.cli.main as port_cli
    import birda_tpu_torch.orchestrator as port_orchestrator

    jcls, pcls = getattr(jax_errors, name), getattr(port_errors, name)
    assert [c.__name__ for c in pcls.__mro__] == \
        [c.__name__ for c in jcls.__mro__]
    assert inspect.getmodule(pcls) is port_errors
    args = ("/data/rec.wav", "reason")
    try:
        jcls(*args)
    except ValueError:  # a numeric template ("waited {0:.1f}s")
        args = (2.5,)
    assert str(pcls(*args)) == str(jcls(*args))

    def raising(cls):
        def analyze_files(*a, **k):
            raise cls(*args)
        return analyze_files

    monkeypatch.setattr(jax_cli, "analyze_files", raising(jcls))
    monkeypatch.setattr(port_orchestrator, "analyze_files", raising(pcls))
    want = CliRunner().invoke(jax_cli.cli, cli_home)
    got = port_cli.main(cli_home)
    assert got == want.exit_code == 1
    assert f"Error: {pcls(*args)}" in capsys.readouterr().err


# -- contracts, decoder, resampler ----------------------------------------------

@pytest.mark.parametrize("family", [f.value for f in jax_contracts.ModelFamily
                                    if f.value in ("birdnet-v24",
                                                   "birdnet-v30", "perch-v2",
                                                   "bsg-fi-v44")])
def test_contracts_are_equal(family):
    want = jax_contracts.contract_for(family)
    got = port_contracts.contract_for(family)
    assert type(got) is port_contracts.ModelConfig
    assert {k: getattr(v, "value", v) for k, v in vars(got).items()} == \
        {k: getattr(v, "value", v) for k, v in vars(want).items()}


@pytest.mark.parametrize("rate", [48_000, 44_100])
def test_decoder_reads_the_same_samples(tmp_path, rate):
    """The port's decoder (its own native library, built from the
    repository's native/ sources into birda_tpu_torch/_build, or the WAV
    fallback where that cannot build) reads what the JAX package's reads."""
    from birda_tpu.audio.decode import StreamingDecoder as JaxDecoder

    from birda_tpu_torch.audio.decode import StreamingDecoder
    from birda_tpu_torch.native import audio as native_audio

    x = np.random.default_rng(rate).normal(0, 0.2, rate * 2) \
        .astype(np.float32)
    wav = tmp_path / f"r{rate}.wav"
    write_wav(wav, x, rate)
    out = []
    for cls in (JaxDecoder, StreamingDecoder):
        with cls(wav) as dec:
            out.append((dec.sample_rate, dec.read(rate * 3)))
    (jr, js), (pr, ps) = out
    assert pr == jr == rate
    assert np.array_equal(ps, js)
    if native_audio.available():
        lib = Path(native_audio._lib._name)
        assert lib.parent == REPO / "birda_tpu_torch" / "_build"


@pytest.mark.parametrize("from_rate,to_rate",
                         [(44_100, 48_000), (48_000, 32_000)])
def test_host_resampler_is_identical(from_rate, to_rate):
    from birda_tpu.audio.resample import resample as jax_resample

    from birda_tpu_torch.audio.resample import resample

    x = np.random.default_rng(0).normal(0, 0.3, from_rate // 4) \
        .astype(np.float32)
    assert np.array_equal(resample(x, from_rate, to_rate),
                          jax_resample(x, from_rate, to_rate))


def test_port_modules_are_not_the_jax_modules():
    """Every copied module loads from the port's own tree."""
    import birda_tpu_torch.api  # noqa: F401 — loads the host layers
    import birda_tpu_torch.cli.main  # noqa: F401

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("birda_tpu_torch.") and m is not None]
    assert len(mods) > 40
    for m in mods:
        assert Path(m.__file__).is_relative_to(REPO / "birda_tpu_torch")


# -- the secondary heads' host code ---------------------------------------------

#: Modules (and the registry's data file) the port copies as they are; only
#: the registry loader names its own package, for its resource files. The
#: lock module's relative import of ``process_index`` resolves to the port's
#: own ``parallel/mesh.py``.
HEAD_COPIES = ["config/bat.py", "config/geomodel.py", "cli/species.py",
               "registry/__init__.py", "registry/schema.py",
               "registry/loader.py", "registry/installer.py",
               "registry/registry.json", "locking/file_lock.py"]


#: The host modules of ``config``, ``models``, ``clip``, ``update`` and
#: ``api.clip``, copied as they are (their imports are relative).
CLI_COPIES = ["audio/chunker.py", "cli/help.py", "registry/license.py",
              "registry/cleanup.py", "update/__init__.py", "update/mod.py",
              "clipper/__init__.py", "clipper/parser.py",
              "clipper/grouper.py", "clipper/extractor.py",
              "clipper/writer.py", "clipper/command.py"]


@pytest.mark.parametrize("rel", CLI_COPIES)
def test_cli_host_module_is_a_copy(rel):
    assert (REPO / "birda_tpu_torch" / rel).read_bytes() == \
        (REPO / "birda_tpu" / rel).read_bytes()
    assert f"birda_tpu_torch/{rel}" in PORT_SOURCES


def test_import_scan_covers_the_heads_modules():
    for rel in ("birda_tpu_torch/inference/range_filter.py",
                "birda_tpu_torch/models/custom.py",
                "birda_tpu_torch/models/regional.py",
                "birda_tpu_torch/registry/selection.py",
                *(f"birda_tpu_torch/{r}" for r in HEAD_COPIES
                  if r.endswith(".py"))):
        assert rel in PORT_SOURCES


@pytest.mark.parametrize("rel", HEAD_COPIES)
def test_heads_host_module_is_a_copy(rel):
    want = (REPO / "birda_tpu" / rel).read_bytes()
    got = (REPO / "birda_tpu_torch" / rel).read_bytes()
    assert got.replace(b'"birda_tpu_torch.registry"',
                       b'"birda_tpu.registry"') == want


def test_registry_is_read_from_the_port():
    from birda_tpu_torch.registry import loader

    text = (REPO / "birda_tpu_torch" / "registry" / "registry.json") \
        .read_text(encoding="utf-8")
    assert loader.embedded_registry_text() == text
    assert loader.load_embedded().range_filter.id == "birdnet-geomodel-v3"


def test_variant_selection_is_the_jax_packages():
    """The host pieces of registry/selection.py are copies; the probe asks
    torch for a card where the JAX module asks jax for its backend, and
    every model of the registry selects the same variant."""
    import torch

    from birda_tpu.registry import loader as jax_loader
    from birda_tpu.registry import selection as jax_selection

    from birda_tpu_torch.registry import loader, selection

    for name in ("_precision_order", "select_variant"):
        assert _source(selection, name) == _source(jax_selection, name)
    probe = selection.SystemProbe.detect()
    assert probe.backend == ("cuda" if torch.cuda.is_available() else "cpu")
    jax_models = {m.id: m for m in jax_loader.load_embedded().models}
    picked = 0
    for model in loader.load_embedded().models:
        if not model.has_variants or not any(
                v.region is None for v in model.variants):
            continue
        got = selection.select_variant(model, probe=probe)
        want = jax_selection.select_variant(
            jax_models[model.id], probe=jax_selection.SystemProbe("cpu"))
        assert got.id == want.id
        picked += 1
    assert picked


@pytest.mark.parametrize("configured", ["explicit", "missing", "registry"])
def test_geomodel_resolution_is_the_jax_packages(tmp_path, monkeypatch,
                                                 configured):
    """resolve_geomodel gives the same outcome and reason in both packages
    for explicit paths, a configured path that does not exist and the
    registry's install location with nothing installed (no download)."""
    from birda_tpu.config import geomodel as jax_geomodel
    from birda_tpu.config.types import Config as JaxConfig
    from birda_tpu.registry import loader as jax_loader

    from birda_tpu_torch.config import geomodel
    from birda_tpu_torch.config.types import Config
    from birda_tpu_torch.registry import loader

    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    geo, labels = tmp_path / "g.onnx", tmp_path / "g.txt"
    if configured == "explicit":
        geo.write_bytes(b"x")
        labels.write_text("A_a\n")
    out = []
    for cfg_cls, mod, reg in ((JaxConfig, jax_geomodel, jax_loader),
                              (Config, geomodel, loader)):
        cfg = cfg_cls()
        if configured != "registry":
            cfg.defaults.geomodel, cfg.defaults.geomodel_labels = geo, labels
        res = mod.resolve_geomodel(cfg, reg.load_embedded())
        out.append((type(res).__name__, vars(res)))
    assert out[0] == out[1]
