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
PORT_SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "birda_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


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
