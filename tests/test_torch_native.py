"""The native model family of the PyTorch port (``birda_tpu_torch.ops.melspec``,
``models/backbone.py`` and the native half of ``models/zoo.py``) against the
JAX package's flax modules, on the CPU, with inputs made from a seed with
numpy.

- The mel front-end: ``melspec`` and the hop-grid ``melspec_from_chunk``
  within ``MEL_BOUND`` of the JAX functions (float32 on both), and
  ``melspec_reference`` equal to the JAX package's.
- Each backbone module within ``MODULE_BOUND`` of its flax counterpart on
  the same carried-over variables, at odd and even sizes for stride 2.
- The synthesized weights: leaf for leaf and bit for bit the JAX package's,
  for the tiny and the full block tables and every family.
- The tiny model's scores, logits and embeddings within ``SCORE_BOUND`` of
  the JAX model's; the chunk runner's mel path and ``synthetic:tiny``
  through ``analyze`` the same.
"""

import csv

import numpy as np
import pytest
import torch

from fixtures_audio import write_wav

import birda_tpu.models.backbone as jb
from birda_tpu.models import zoo as jz
from birda_tpu.ops import melspec as jm

import birda_tpu_torch.models.backbone as tb
from birda_tpu_torch.models import zoo as tz
from birda_tpu_torch.ops import melspec as tm

#: Log-mel, absolute: float32 DFT products summed in another order (XLA's
#: and oneDNN's blocking) on a log scale whose smallest values are
#: log(1e-6).
MEL_BOUND = 1e-4
#: A backbone module's output, absolute, on activations of order one.
MODULE_BOUND = 1e-5
#: Scores, logits and embeddings of the tiny model, and confidences through
#: analyze, absolute.
SCORE_BOUND = 1e-5

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs in several
    processes at once, and torch's thread pools would oversubscribe the
    cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAMILIES = ["birdnet-v24", "birdnet-v30", "perch-v2", "bsg-fi-v44"]


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


# -- the mel front-end -----------------------------------------------------------

CONFIGS = {
    "v24": tm.MelSpecConfig(sample_rate=48_000, n_fft=1024, hop=576,
                            n_mels=128, fmax=15_000.0),
    "v30": tm.MelSpecConfig(sample_rate=32_000, n_fft=1024, hop=640,
                            n_mels=128, fmax=16_000.0),
    "odd_hop_power": tm.MelSpecConfig(sample_rate=16_000, n_fft=256, hop=97,
                                      n_mels=40, fmax=7_000.0,
                                      scale="power"),
    "linear": tm.MelSpecConfig(sample_rate=16_000, n_fft=512, hop=128,
                               n_mels=64, fmax=8_000.0, scale="linear"),
}


def _jax_cfg(cfg):
    return jm.MelSpecConfig(**vars(cfg))


@pytest.mark.parametrize("family", FAMILIES)
def test_mel_configs_are_the_jax_packages(family):
    want = jz.MEL_CONFIGS[jz.ModelFamily(family)]
    got = tz.MEL_CONFIGS[tz.ModelFamily(family)]
    assert vars(got) == vars(want)
    assert got.frames(144_000) == want.frames(144_000)
    assert hash(got) == hash(tm.MelSpecConfig(**vars(got)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_melspec_matches_jax(name):
    cfg = CONFIGS[name]
    x = np.random.default_rng(0).normal(0, 0.2, (3, 6 * cfg.n_fft + 33)) \
        .astype(np.float32)
    want = np.asarray(jm.melspec(_jnp(x), _jax_cfg(cfg)))
    got = tm.melspec(torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (3, cfg.frames(x.shape[1]),
                                              cfg.n_mels)
    got = got.numpy()
    if cfg.scale == "log":
        assert np.abs(got - want).max() <= MEL_BOUND
    else:  # power and magnitude: relative to the largest value
        assert np.abs(got - want).max() <= MEL_BOUND * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_melspec_reference_is_the_jax_packages(name):
    cfg = CONFIGS[name]
    x = np.random.default_rng(1).normal(0, 0.2, (2, 4 * cfg.n_fft)) \
        .astype(np.float32)
    want = jm.melspec_reference(x, _jax_cfg(cfg))
    assert np.array_equal(tm.melspec_reference(x, cfg), want)
    assert np.array_equal(tm.melspec_reference(x[0], cfg), want[0])
    # and the products agree with the FFT
    got = tm.melspec(torch.from_numpy(x), cfg).numpy()
    scale = 1.0 if cfg.scale == "log" else np.abs(want).max()
    assert np.abs(got - want).max() <= MEL_BOUND * scale


@pytest.mark.parametrize("name,batch,step_frames", [
    ("v24", 4, 250), ("v24", 3, 1), ("v30", 2, 100), ("odd_hop_power", 5, 3),
])
def test_melspec_from_chunk_matches_jax(name, batch, step_frames):
    cfg = CONFIGS[name]
    seg = 8 * cfg.n_fft + 5
    step = step_frames * cfg.hop
    chunk = np.random.default_rng(2).normal(
        0, 0.2, (batch - 1) * step + seg).astype(np.float32)
    want = np.asarray(jm.melspec_from_chunk(_jnp(chunk), _jax_cfg(cfg), batch,
                                            step, seg))
    got = tm.melspec_from_chunk(torch.from_numpy(chunk), cfg, batch, step,
                                seg).numpy()
    assert got.shape == want.shape == (batch, cfg.frames(seg), cfg.n_mels)
    scale = 1.0 if cfg.scale == "log" else np.abs(want).max()
    assert np.abs(got - want).max() <= MEL_BOUND * scale
    # and each window is the per-window front-end of its own samples
    windows = np.stack([chunk[b * step:b * step + seg] for b in range(batch)])
    per_window = tm.melspec(torch.from_numpy(windows), cfg).numpy()
    assert np.abs(got - per_window).max() <= MEL_BOUND * scale


def test_melspec_from_chunk_off_the_hop_grid_is_refused():
    cfg = CONFIGS["v24"]
    chunk = np.zeros(10 * cfg.n_fft, np.float32)
    with pytest.raises(ValueError, match="not a multiple of hop") as want:
        jm.melspec_from_chunk(_jnp(chunk), _jax_cfg(cfg), 2, cfg.hop + 1,
                              4 * cfg.n_fft)
    with pytest.raises(ValueError) as got:
        tm.melspec_from_chunk(torch.from_numpy(chunk), cfg, 2, cfg.hop + 1,
                              4 * cfg.n_fft)
    assert str(got.value) == str(want.value)


# -- the backbone modules -------------------------------------------------------

@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 2), (9, 3, 2), (8, 5, 2), (7, 5, 1), (8, 1, 2), (2, 3, 2),
    (1, 3, 2),
])
def test_same_pads_are_flax_padding(size, kernel, stride):
    """flax's SAME pads (0, 1) for an even input at k 3, s 2."""
    import jax
    import jax.numpy as jnp

    low, high = tb.same_pads(size, kernel, stride)
    x = jnp.arange(float(size)).reshape(1, size, 1, 1) + 1
    w = jnp.ones((kernel, 1, 1, 1))
    want = jax.lax.conv_general_dilated(
        x, w, (stride, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    padded = jnp.pad(x, ((0, 0), (low, high), (0, 0), (0, 0)))
    got = jax.lax.conv_general_dilated(
        padded, w, (stride, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert np.array_equal(np.asarray(got), np.asarray(want))
    if size % 2 == 0 and kernel == 3 and stride == 2:
        assert (low, high) == (0, 1)


def _random_variables(variables, seed):
    """Every leaf of a flax variables tree redrawn from ``seed``: variances
    in [0.5, 1.5], everything else normal with a fan-in scale."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 4
        return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _module_pair(kind, cin, args):
    """(flax module, port module) of one backbone block."""
    if kind == "ConvBNAct":
        features, kernel, strides, groups, act = args
        return (jb.ConvBNAct(features, kernel, strides, groups, act),
                tb.ConvBNAct(cin, features, kernel, strides, groups, act))
    if kind == "SqueezeExcite":
        return jb.SqueezeExcite(cin, args[0]), tb.SqueezeExcite(cin, args[0])
    features, expand, kernel, strides = args
    if kind == "MBConv":
        return (jb.MBConv(features, expand, kernel, strides),
                tb.MBConv(cin, features, expand, kernel, strides))
    return (jb.FusedMBConv(features, expand, kernel, strides),
            tb.FusedMBConv(cin, features, expand, kernel, strides))


MODULE_CASES = [
    ("ConvBNAct", 1, (8, (3, 3), (2, 2), 1, True)),      # the stem
    ("ConvBNAct", 6, (6, (5, 5), (2, 2), 6, True)),      # depthwise
    ("ConvBNAct", 4, (12, (1, 1), (1, 1), 1, False)),    # projection
    ("ConvBNAct", 4, (8, (3, 3), (1, 2), 1, True)),
    ("SqueezeExcite", 8, (2,)),
    ("MBConv", 8, (8, 1, (3, 3), (1, 1))),               # residual
    ("MBConv", 8, (16, 4, (5, 5), (2, 2))),
    ("MBConv", 6, (10, 6, (3, 3), (2, 2))),
    ("FusedMBConv", 8, (8, 1, (3, 3), (1, 1))),          # residual
    ("FusedMBConv", 8, (12, 4, (3, 3), (2, 2))),
    ("FusedMBConv", 4, (4, 4, (3, 3), (1, 1))),          # expand, residual
]


@pytest.mark.parametrize("hw", [(16, 12), (15, 13), (9, 10)],
                         ids=["even", "odd", "mixed"])
@pytest.mark.parametrize("kind,cin,args", MODULE_CASES,
                         ids=[f"{k}-{i}" for i, (k, _, _) in
                              enumerate(MODULE_CASES)])
def test_backbone_module_matches_flax(kind, cin, args, hw):
    import jax

    flax_mod, port_mod = _module_pair(kind, cin, args)
    x = np.random.default_rng(3).normal(0, 1, (2, *hw, cin)) \
        .astype(np.float32)
    variables = flax_mod.init(jax.random.PRNGKey(0), _jnp(x))
    variables = _random_variables(variables, seed=4)
    want = np.asarray(flax_mod.apply(variables, _jnp(x)))
    tz.native_params_from_flax(port_mod, variables)
    with torch.inference_mode():
        got = port_mod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= MODULE_BOUND * max(
        1.0, float(np.abs(want).max()))


def test_backbone_children_carry_flax_names():
    m = tb.MBConv(8, 16, 4, (3, 3), (2, 2))
    assert [n for n, _ in m.named_children()] == [
        "ConvBNAct_0", "ConvBNAct_1", "SqueezeExcite_0", "ConvBNAct_2"]
    leaves = {p: s for p, s, _ in tb.flax_leaves(m)}
    assert leaves["params/ConvBNAct_1/Conv_0/kernel"] == (3, 3, 1, 32)
    assert leaves["batch_stats/ConvBNAct_2/BatchNorm_0/var"] == (16,)
    assert leaves["params/SqueezeExcite_0/Conv_1/bias"] == (32,)


def test_a_leaf_of_the_wrong_shape_is_refused():
    m = tb.ConvBNAct(4, 8)
    with pytest.raises(ValueError, match="does not fit"):
        tb.load_flax_leaf(m.Conv_0.kernel, np.zeros((3, 3, 4, 9), np.float32))


# -- synthesized weights ---------------------------------------------------------

def _flat(variables) -> dict:
    import jax

    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(variables)[0]}


def _modules(family, blocks):
    from birda_tpu.models.contracts import contract_for

    cfg = contract_for(family)
    kw = dict(num_classes=cfg.num_classes,
              embedding_dim=cfg.embedding_dim or 1024,
              activation=cfg.activation.value, blocks=blocks)
    jax_mod = jb.AudioClassifier(
        mel=jz.MEL_CONFIGS[jz.ModelFamily(family)], **kw)
    port_mod = tb.AudioClassifier(
        mel=tz.MEL_CONFIGS[tz.ModelFamily(family)], **kw)
    return cfg, jax_mod, port_mod


@pytest.mark.parametrize("blocks", ["TINY_BLOCKS", "DEFAULT_BLOCKS"])
@pytest.mark.parametrize("family", FAMILIES)
def test_synthesized_weights_are_the_jax_packages_bit_for_bit(family, blocks):
    table = getattr(jz, blocks) if blocks == "TINY_BLOCKS" else jb.DEFAULT_BLOCKS
    assert table == (getattr(tz, blocks) if blocks == "TINY_BLOCKS"
                     else tb.DEFAULT_BLOCKS)
    cfg, jax_mod, port_mod = _modules(family, table)
    want = _flat(jz._synthesize_params(jax_mod, cfg.sample_count, seed=3))
    got = _flat(tz._synthesize_params(port_mod, seed=3))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype == np.float32, path
        assert np.array_equal(got[path], want[path]), path
    # and the module holds them after the carry-over
    tz.native_params_from_flax(port_mod, tz._synthesize_params(port_mod, 3))
    for path, shape, t in tb.flax_leaves(port_mod):
        arr = t.numpy() if t.ndim != 4 else t.permute(2, 3, 1, 0).numpy()
        assert arr.shape == shape and np.array_equal(arr, want[path]), path


@pytest.mark.parametrize("family", FAMILIES)
def test_tiny_model_matches_jax(family):
    jax_model = jz.tiny_model(family, seed=2)
    model = tz.tiny_model(family, seed=2)
    assert model.source == "native-synthetic"
    assert model.labels == jax_model.labels
    assert vars(model.mel_config) == vars(jax_model.mel_config)
    n = model.config.sample_count
    x = np.random.default_rng(5).normal(0, 0.1, (2, n)).astype(np.float32)
    want = jax_model.apply(_jnp(x))
    with torch.inference_mode():
        got = model.apply(torch.from_numpy(x))
    for key in ("scores", "logits", "embeddings"):
        assert got[key].dtype == torch.float32
        assert got[key].shape == want[key].shape
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() \
            <= SCORE_BOUND, key
    # precomputed mel takes the same path as the waveform
    mel = tm.melspec(torch.from_numpy(x), model.mel_config)
    with torch.inference_mode():
        again = model.apply(mel)
    assert np.abs(again["scores"].numpy() - got["scores"].numpy()).max() \
        <= SCORE_BOUND


def test_native_weights_carry_over_from_a_flax_tree():
    """native_model(params=...) takes a flax variables tree, as the JAX
    package's native_model does."""
    _, jax_mod, _ = _modules("birdnet-v24", jz.TINY_BLOCKS)
    variables = _random_variables(
        jz._synthesize_params(jax_mod, 144_000, seed=7), seed=8)
    jax_model = jz.native_model("birdnet-v24", params=variables,
                                blocks=jz.TINY_BLOCKS)
    model = tz.native_model("birdnet-v24", params=variables,
                            blocks=tz.TINY_BLOCKS)
    assert model.source == jax_model.source == "native-weights"
    x = np.random.default_rng(9).normal(0, 0.1, (2, 144_000)) \
        .astype(np.float32)
    want = np.asarray(jax_model.apply(_jnp(x))["scores"])
    with torch.inference_mode():
        got = model.apply(torch.from_numpy(x))["scores"].numpy()
    assert np.abs(got - want).max() <= SCORE_BOUND


def test_synthetic_full_is_the_default_backbone_in_fp32():
    from birda_tpu_torch.config.types import ModelConfig, ModelType
    from birda_tpu_torch.orchestrator import load_model_graph

    mc = ModelConfig(path="synthetic:full", labels="synthetic:full",
                     model_type=ModelType.BIRDNET_V24)
    model = load_model_graph(mc, "full", precision="bf16", device="cpu")
    assert model.source == "native-synthetic"
    assert model.precision_info is None
    leaves = tb.flax_leaves(model.bind_device(torch.device("cpu")))
    _, jax_mod, _ = _modules("birdnet-v24", jb.DEFAULT_BLOCKS)
    import jax

    want = jax.eval_shape(lambda: jax_mod.init(
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 144_000),
                                                    np.float32)))
    assert {p: s for p, s, _ in leaves} == {
        "/".join(k.key for k in path): tuple(v.shape)
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert all(t.dtype == torch.float32 for _, _, t in leaves)
    for flavor in ("tiny", ""):
        mc.path = f"synthetic:{flavor}"
        tiny = load_model_graph(mc, "tiny", device="cpu")
        assert len(tb.flax_leaves(tiny.bind_device(torch.device("cpu")))) \
            < len(leaves)


# -- the chunk runner's mel path and analyze --------------------------------------

def _full_rows(results, n):
    out = np.zeros((len(results), n), np.float64)
    for r, res in enumerate(results):
        for p in res.predictions:
            out[r, p.index] = p.confidence
    return out


@pytest.mark.parametrize("step,mel_path", [(72_000, True), (144_000, True),
                                           (100_001, False)],
                         ids=["overlap", "no_overlap", "off_grid"])
def test_chunk_runner_matches_jax(step, mel_path):
    from birda_tpu.inference.classifier import BirdClassifier as JaxClassifier

    from birda_tpu_torch.inference.classifier import BirdClassifier

    batch, k = 3, 6
    x = np.random.default_rng(6).normal(
        0, 0.2, (batch - 1) * step + 144_000).astype(np.float32)
    out = []
    for cls, zoo in ((JaxClassifier, jz), (BirdClassifier, tz)):
        clf = cls(zoo.tiny_model(), device="cpu", min_confidence=0.0,
                  top_k=k)
        runner = clf.chunk_runner(batch, step)
        out.append(_full_rows(runner.predict_chunk(x, batch), 6_522))
    assert (runner._mel_cfg is not None) == mel_path
    want, got = out
    assert np.abs(got - want).max() <= SCORE_BOUND
    assert np.array_equal(got > 0, want > 0)  # the same top-k classes


@pytest.fixture()
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    monkeypatch.setenv("BIRDA_NO_COMPILE_CACHE", "1")
    return tmp_path


def _recordings(home):
    rng = np.random.default_rng(0)
    wavs = []
    for rate in (48_000, 44_100):
        t = np.arange(int(rate * 7)) / rate
        x = 0.3 * np.sin(2 * np.pi * (2500 + 300 * t) * t) \
            + rng.normal(0, 0.05, t.shape)
        p = home / f"rec_{rate}.wav"
        write_wav(p, x.astype(np.float32), rate)
        wavs.append(p)
    return wavs


def _assert_same_windows(got, want):
    """Rows ``(start, end, name, confidence)`` of two runs: per window the
    same confidences within ``SCORE_BOUND`` in the same order, and the same
    species wherever the two runs' confidences are not within the bound of
    each other (the tiny model's sigmoid scores all lie near 0.5, so
    float32 rounding may swap near-ties)."""
    def windows(rows):
        out = {}
        for start, end, name, conf in rows:
            out.setdefault((start, end), []).append((name, conf))
        return out

    g, w = windows(got), windows(want)
    assert g.keys() == w.keys() and g
    for key in w:
        gc = [c for _, c in g[key]]
        wc = [c for _, c in w[key]]
        assert len(gc) == len(wc)
        assert max(abs(a - b) for a, b in zip(gc, wc)) <= SCORE_BOUND
        cut = min(wc)
        gd, wd = dict(g[key]), dict(w[key])
        for name in set(gd) ^ set(wd):
            assert abs(gd.get(name, wd.get(name)) - cut) <= 2 * SCORE_BOUND
        for name in set(gd) & set(wd):
            assert abs(gd[name] - wd[name]) <= SCORE_BOUND


@pytest.mark.parametrize("flavor", ["tiny", ""])
def test_synthetic_tiny_analyze_matches_jax(home, flavor):
    import birda_tpu.api as jax_api

    import birda_tpu_torch.api as torch_api

    wavs = _recordings(home)
    kw = dict(model_path=f"synthetic:{flavor}",
              labels_path=f"synthetic:{flavor}", model_type="birdnet-v24",
              min_confidence=0.01, device="cpu", overlap=1.5)
    want, got = jax_api.analyze(wavs, **kw), torch_api.analyze(wavs, **kw)
    assert got.exit_code == want.exit_code == 0
    assert len(got.files) == len(want.files) == 2
    for g, w in zip(got.files, want.files):
        assert g.path == w.path and len(g.detections) > 0
        _assert_same_windows(
            [(d.start_time, d.end_time, d.scientific_name, d.confidence)
             for d in g.detections],
            [(d.start_time, d.end_time, d.scientific_name, d.confidence)
             for d in w.detections])


def test_synthetic_tiny_cli_csv_matches_jax_cli(home):
    from click.testing import CliRunner

    from birda_tpu.cli.main import cli

    from birda_tpu_torch.cli.main import main

    wavs = _recordings(home)
    args = ["--model-path", "synthetic:tiny", "--labels-path",
            "synthetic:tiny", "--model-type", "perch-v2", "-c", "0",
            "--cpu", "-f", "csv", "-q"]
    for name, run in (("jax", lambda a: CliRunner().invoke(cli, a).exit_code),
                      ("torch", main)):
        assert run(["analyze", *map(str, wavs), *args,
                    "-o", str(home / name)]) == 0
    for wav in wavs:
        tables = []
        for name in ("jax", "torch"):
            (path,) = (home / name).glob(f"{wav.stem}*.csv")
            with open(path, encoding="utf-8-sig") as f:
                tables.append(list(csv.reader(f)))
        want, got = tables
        assert got[0] == want[0]
        conf = [h.lower() for h in want[0]].index("confidence")
        assert len(got) == len(want) > 1

        def rows(table):
            return [(r[0], r[1], r[2], float(r[conf])) for r in table[1:]]

        _assert_same_windows(rows(got), rows(want))
