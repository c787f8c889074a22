"""The public signatures of the PyTorch port against the JAX package's, and
the compute dtype of the native family (ROADMAP C10), on the CPU.

- Every public function and class that a module of both packages defines
  takes the same parameter names in the same order, but for the
  differences of :data:`DELIBERATE`, each named with the ROADMAP line that
  justifies it; every public name the JAX package defines and the port does
  not is one of :data:`NOT_PORTED`.
- The native backbone computes in the flax modules' ``dtype``: at bf16 each
  module returns the dtype the flax module returns, for float32 and for
  bf16 input, within ``BF16_MODULE_BOUND`` of it on the same variables; the
  tiny bf16 model's scores, logits and embeddings are within their bounds
  of the JAX tiny bf16 model's on the same seeded input, for v2.4 and v3.0.
- float32 (the default, or ``dtype=None``) is the route the port ran
  before it took a ``dtype``, bit for bit: the model's outputs equal those
  of that route's forward rebuilt here from the same buffers.
- ``melspec_from_chunk(compute_dtype=torch.bfloat16)`` is within
  ``BF16_MEL_BOUND`` of the JAX function at ``jnp.bfloat16``; None is
  float32 bit for bit.
- ``calibrate(params=...)`` runs on the caller's weights, as the JAX
  function does, and ``min_weight_bytes`` changes nothing.
"""

import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent

#: A bf16 backbone module's output against flax's at bf16, absolute, on
#: activations of order one: a few bf16 roundings (2^-8 relative each) taken
#: in another order.
BF16_MODULE_BOUND = 3e-2
#: The tiny bf16 model against the JAX one: scores absolute (sigmoid and
#: softmax scores of random weights), logits and embeddings relative to the
#: largest magnitude of the JAX output.
BF16_SCORE_BOUND = 1e-4
BF16_REL_BOUND = 3e-2
#: Log-mel at bf16 operands and float32 sums, absolute, against the JAX
#: function at bf16 (the same roundings; sums in another order).
BF16_MEL_BOUND = 2e-3

#: (module, public name) -> (JAX parameters, port parameters, the ROADMAP
#: line that justifies the difference). Each is held exactly.
DELIBERATE = {
    ("api", "AnalyzeResult"): (
        ["files", "exit_code"],
        ["files", "exit_code", "backend", "summary", "precision",
         "range_filter"],
        "`AnalyzeResult` carries the run's backend, summary, precision"),
    ("api", "species"): (
        ["lat", "lon", "week", "month", "day", "threshold", "sort", "model",
         "geomodel_path", "geomodel_labels_path"],
        ["lat", "lon", "week", "month", "day", "threshold", "sort", "model",
         "geomodel_path", "geomodel_labels_path", "device"],
        "The `device` arguments"),
    ("inference.backend", "ensure_runtime_available"): (
        [], ["requested"], "The `device` arguments"),
    ("models.custom", "CustomClassifier"): (
        ["head_fn", "labels", "min_confidence", "top_k"],
        ["head_fn", "labels", "min_confidence", "top_k", "device"],
        "The `device` arguments"),
    ("onnx.parity", "capture_activations"): (
        ["fn", "args", "params"], ["fn", "args", "params", "device"],
        "The `device` arguments"),
    ("onnx.parity", "find_first_divergence"): (
        ["fn", "inputs", "recorded", "tol", "params"],
        ["fn", "inputs", "recorded", "tol", "params", "device"],
        "The `device` arguments"),
    ("onnx.quantize", "calibrate"): (
        ["model", "batches", "params", "method", "percentile",
         "min_weight_bytes"],
        ["model", "batches", "params", "method", "percentile",
         "min_weight_bytes", "device"],
        "The `device` arguments"),
    ("onnx.quantize", "cached_calibration"): (
        ["model_bytes", "sample_count"],
        ["model_bytes", "sample_count", "device"],
        "The `device` arguments"),
    ("orchestrator", "build_range_filter_data"): (
        ["request", "installed", "classifier_labels"],
        ["request", "installed", "classifier_labels", "device"],
        "The `device` arguments"),
    ("orchestrator", "load_model_graph"): (
        ["mc", "name", "precision", "backend", "calibration_audio"],
        ["mc", "name", "precision", "device", "calibration_audio"],
        "The `device` arguments"),
    ("ops.stft_conv", "conv1d_stft"): (
        ["x", "w", "hop", "interpret"], ["x", "w", "hop", "prepared"],
        "`interpret` becomes `prepared`"),
    ("ops.stft_conv", "fused_logmel"): (
        ["x", "w", "fb", "hop", "eps", "interpret"],
        ["x", "w", "fb", "hop", "eps", "prepared"],
        "`interpret` becomes `prepared`"),
}
#: The torch backbone modules name their input width (``cin``) where flax
#: infers it, and take no flax ``parent``/``name``.
BACKBONE = {"ConvBNAct", "SqueezeExcite", "MBConv", "FusedMBConv",
            "AudioClassifier"}
BACKBONE_LINE = "explicit `cin`"
#: (module, public name) the JAX package defines and the port does not,
#: with the ROADMAP line that says why.
NOT_PORTED = {
    ("inference.backend", "probe_accelerator_bounded"): "Not to port",
    ("inference.backend", "available_backends_bounded"): "Not to port",
    ("inference.classifier", "enable_persistent_cache"): "Not to port",
    ("parallel.mesh", "make_mesh"): "Not to port",
    ("parallel.mesh", "mesh_over"): "Not to port",
    ("ops.stft_conv", "kernel_enabled"): "`kernel_enabled`, `enabled`",
    ("ops.stft_conv", "enabled"): "`kernel_enabled`, `enabled`",
    ("ops.stft_conv", "fused_fits"): "`kernel_enabled`, `enabled`",
}


def _modules():
    """Dotted module names under ``birda_tpu`` (``""`` for the package)."""
    out = []
    for p in sorted((REPO / "birda_tpu").rglob("*.py")):
        parts = list(p.relative_to(REPO / "birda_tpu").with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


MODULES = _modules()


def _public(mod) -> dict:
    """The public functions and classes ``mod`` itself defines."""
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


def _params(obj):
    try:
        return [p.name for p in inspect.signature(obj).parameters.values()]
    except (TypeError, ValueError):  # a class whose signature is C's
        return None


def _pair(name):
    jax_mod = importlib.import_module("birda_tpu" + (f".{name}" if name
                                                     else ""))
    port_mod = importlib.import_module("birda_tpu_torch" + (f".{name}" if name
                                                           else ""))
    return _public(jax_mod), _public(port_mod)


@pytest.mark.parametrize("name", MODULES, ids=lambda m: m or "package")
def test_public_signatures_match_the_jax_packages(name):
    jax_names, port_names = _pair(name)
    for key in sorted(jax_names.keys() & port_names.keys()):
        want, got = _params(jax_names[key]), _params(port_names[key])
        if (name, key) in DELIBERATE:
            assert (want, got) == DELIBERATE[name, key][:2], (name, key)
        elif name == "models.backbone" and key in BACKBONE:
            assert [p for p in want if p not in ("parent", "name")] == \
                [p for p in got if p != "cin"], key
        else:
            assert got == want, (name, key)
    missing = {(name, k) for k in jax_names.keys() - port_names.keys()}
    assert missing <= NOT_PORTED.keys(), missing


def test_every_deliberate_difference_names_its_roadmap_line():
    roadmap = (REPO / "ROADMAP.md").read_text()
    lines = {v[2] for v in DELIBERATE.values()} | set(NOT_PORTED.values()) \
        | {BACKBONE_LINE}
    for line in lines:
        assert line in roadmap, line
    # and each entry is still a difference the scan meets
    seen = set()
    for name in MODULES:
        jax_names, port_names = _pair(name)
        seen |= {(name, k) for k in jax_names.keys() ^ port_names.keys()}
        seen |= {(name, k) for k in jax_names.keys() & port_names.keys()
                 if (name, k) in DELIBERATE}
    assert DELIBERATE.keys() <= seen and NOT_PORTED.keys() <= seen


def test_the_scan_sees_the_c10_parameters():
    """The parameters C10 repaired are in the port's signatures."""
    from birda_tpu_torch.models import backbone, zoo
    from birda_tpu_torch.onnx import quantize
    from birda_tpu_torch.ops import melspec

    assert _params(zoo.native_model)[:5] == [
        "family", "params", "labels", "dtype", "seed"]
    assert _params(zoo.tiny_model) == ["family", "seed", "dtype"]
    assert "compute_dtype" in _params(melspec.melspec_from_chunk)
    for cls in BACKBONE:
        assert _params(getattr(backbone, cls))[-1] == "dtype", cls
    assert {"params", "min_weight_bytes"} <= set(_params(quantize.calibrate))


# -- the backbone at bf16 ---------------------------------------------------------

def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def _module_pair(kind, cin, args, bf16: bool):
    import jax.numpy as jnp

    import birda_tpu.models.backbone as jb
    import birda_tpu_torch.models.backbone as tb

    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
    if kind == "ConvBNAct":
        features, kernel, strides, groups, act = args
        return (jb.ConvBNAct(features, kernel, strides, groups, act, jd),
                tb.ConvBNAct(cin, features, kernel, strides, groups, act, td))
    if kind == "SqueezeExcite":
        return (jb.SqueezeExcite(cin, args[0], jd),
                tb.SqueezeExcite(cin, args[0], td))
    features, expand, kernel, strides = args
    if kind == "MBConv":
        return (jb.MBConv(features, expand, kernel, strides, dtype=jd),
                tb.MBConv(cin, features, expand, kernel, strides, dtype=td))
    return (jb.FusedMBConv(features, expand, kernel, strides, jd),
            tb.FusedMBConv(cin, features, expand, kernel, strides, td))


MODULE_CASES = [
    ("ConvBNAct", 1, (8, (3, 3), (2, 2), 1, True)),      # the stem
    ("ConvBNAct", 6, (6, (5, 5), (2, 2), 6, True)),      # depthwise
    ("ConvBNAct", 4, (12, (1, 1), (1, 1), 1, False)),    # projection
    ("SqueezeExcite", 8, (2,)),
    ("MBConv", 8, (8, 1, (3, 3), (1, 1))),               # residual
    ("MBConv", 8, (16, 4, (5, 5), (2, 2))),
    ("FusedMBConv", 8, (8, 1, (3, 3), (1, 1))),          # residual
    ("FusedMBConv", 8, (12, 4, (3, 3), (2, 2))),
    ("FusedMBConv", 4, (4, 4, (3, 3), (1, 1))),          # expand, residual
]


def _random_variables(variables, seed):
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = np.shape(leaf)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 4
        return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("input_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,cin,args", MODULE_CASES,
                         ids=[f"{k}-{i}" for i, (k, _, _) in
                              enumerate(MODULE_CASES)])
def test_bf16_backbone_module_matches_flax(kind, cin, args, input_dtype):
    """Each module at ``dtype=bf16`` returns what the flax module returns,
    in its dtype: bf16 where the block ends in a conv, BatchNorm or a
    product of bf16 values, float32 where a float32 input is added or
    multiplied in."""
    import jax
    import jax.numpy as jnp

    from birda_tpu_torch.models import zoo as tz

    flax_mod, port_mod = _module_pair(kind, cin, args, bf16=True)
    x = np.random.default_rng(3).normal(0, 1, (2, 11, 10, cin)) \
        .astype(np.float32)
    jx = _jnp(x).astype(getattr(jnp, input_dtype))
    variables = _random_variables(
        flax_mod.init(jax.random.PRNGKey(0), jx), seed=4)
    assert {np.asarray(v).dtype for v in jax.tree_util.tree_leaves(
        variables)} == {np.dtype(np.float32)}
    want = flax_mod.apply(variables, jx)
    tz.native_params_from_flax(port_mod, variables)
    assert {t.dtype for t in port_mod.state_dict().values()} == \
        {torch.float32}
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(
        getattr(torch, input_dtype))
    with torch.inference_mode():
        got = port_mod.eval()(tx)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BF16_MODULE_BOUND * max(
        1.0, float(np.abs(want).max()))


def _stage_dtypes_port(model, x):
    """The dtype out of each top-level stage of the port's classifier."""
    module = model.bind_device(torch.device("cpu"))
    out = []
    hooks = [layer.register_forward_hook(
        lambda m, i, o: out.append(str(o.dtype).removeprefix("torch.")))
        for layer in module.layers]
    try:
        with torch.inference_mode():
            model.apply(x)
    finally:
        for h in hooks:
            h.remove()
    return out


def _stage_dtypes_flax(family, x, dtype):
    """The dtype out of each top-level stage of the flax classifier, from
    its captured intermediates."""
    import jax
    import jax.numpy as jnp

    import birda_tpu.models.backbone as jb
    from birda_tpu.models import zoo as jz
    from birda_tpu.models.contracts import contract_for

    cfg = contract_for(family)
    mod = jb.AudioClassifier(
        mel=jz.MEL_CONFIGS[jz.ModelFamily(family)],
        num_classes=cfg.num_classes, embedding_dim=cfg.embedding_dim or 1024,
        activation=cfg.activation.value, blocks=jz.TINY_BLOCKS, dtype=dtype)
    variables = jz._synthesize_params(mod, cfg.sample_count, seed=2)
    _, state = mod.apply(variables, _jnp(x), capture_intermediates=True,
                         mutable=["intermediates"])
    inter = state["intermediates"]
    # The stem, the blocks and the head conv, in the order they ran.
    order = [k for k in inter
             if k not in ("__call__", "embedding", "classifier")]
    return [str(inter[k]["__call__"][0].dtype) for k in order]


@pytest.mark.parametrize("family", ["birdnet-v24", "birdnet-v30"])
def test_tiny_bf16_model_matches_jax(family):
    import jax.numpy as jnp

    from birda_tpu.models import zoo as jz
    from birda_tpu_torch.models import zoo as tz

    jax_model = jz.tiny_model(family, seed=2, dtype=jnp.bfloat16)
    model = tz.tiny_model(family, seed=2, dtype=torch.bfloat16)
    n = model.config.sample_count
    x = np.random.default_rng(5).normal(0, 0.1, (2, n)).astype(np.float32)
    # the same seeded mel input through both
    from birda_tpu.ops import melspec as jm

    mel = np.asarray(jm.melspec(_jnp(x), jax_model.mel_config))
    want = jax_model.apply(_jnp(mel))
    with torch.inference_mode():
        got = model.apply(torch.from_numpy(mel))
    for key in ("scores", "logits", "embeddings"):
        assert got[key].dtype == torch.float32
        assert got[key].shape == want[key].shape
        w = np.asarray(want[key])
        err = np.abs(got[key].numpy() - w).max()
        bound = BF16_SCORE_BOUND if key == "scores" \
            else BF16_REL_BOUND * np.abs(w).max()
        assert err <= bound, (key, err, bound)
    # The head computed in bf16 on both: the embeddings are bf16 values.
    for emb in (got["embeddings"], torch.from_numpy(
            np.asarray(want["embeddings"]))):
        assert torch.equal(emb, emb.bfloat16().float())
    assert _stage_dtypes_port(model, torch.from_numpy(mel)) == \
        _stage_dtypes_flax(family, mel, jnp.bfloat16) == \
        ["bfloat16"] * (2 + len(tz.TINY_BLOCKS))


def _fp32_forward(module, x):
    """The port's float32 forward as it ran before the modules took a
    ``dtype``, rebuilt from the same buffers."""
    import birda_tpu_torch.models.backbone as tb

    if isinstance(module, tb.Conv):
        kh, kw = module.kernel.shape[2:]
        (t, b), (l, r) = (tb.same_pads(x.shape[2], kh, module.strides[0]),
                          tb.same_pads(x.shape[3], kw, module.strides[1]))
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, module.kernel, module.bias, module.strides,
                        groups=module.groups)
    if isinstance(module, tb.BatchNorm):
        def c(v):
            return v.reshape(1, -1, 1, 1)

        mul = torch.rsqrt(c(module.var) + tb.BN_EPSILON) * c(module.scale)
        return (x - c(module.mean)) * mul + c(module.bias)
    if isinstance(module, tb.Dense):
        return torch.matmul(x, module.kernel) + module.bias
    if isinstance(module, tb.ConvBNAct):
        x = _fp32_forward(module.BatchNorm_0, _fp32_forward(module.Conv_0, x))
        return F.silu(x) if module.act else x
    if isinstance(module, tb.SqueezeExcite):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = _fp32_forward(module.Conv_1,
                          F.silu(_fp32_forward(module.Conv_0, s)))
        return x * torch.sigmoid(s)
    h = x
    for layer in module.layers:
        h = _fp32_forward(layer, h)
    return h + x if module.residual else h


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("family", ["birdnet-v24", "birdnet-v30"])
def test_fp32_is_the_previous_route_bit_for_bit(family, dtype):
    from birda_tpu_torch.models import zoo as tz
    from birda_tpu_torch.ops.melspec import melspec

    kw = {} if dtype == "float32" else {"dtype": None}
    model = tz.tiny_model(family, seed=2, **kw)
    module = model.bind_device(torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 0.1, (2, model.config.sample_count)).astype(np.float32))
    with torch.inference_mode():
        got = model.apply(x)
        m = melspec(x, module.mel)
        mu = m.mean(dim=(1, 2), keepdim=True)
        sd = m.std(dim=(1, 2), keepdim=True, correction=0) + 1e-6
        h = ((m - mu) / sd)[:, None]
        for layer in module.layers:
            h = _fp32_forward(layer, h)
        emb = F.silu(_fp32_forward(module.embedding, h.mean(dim=(2, 3))))
        logits = _fp32_forward(module.classifier, emb)
    assert torch.equal(got["logits"], logits)
    assert torch.equal(got["embeddings"], emb)


# -- the mel front-end's compute dtype ------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,mels,batch,step_frames", [
    (1024, 576, 128, 3, 250), (1024, 640, 128, 2, 100), (256, 97, 40, 4, 3)])
def test_melspec_from_chunk_in_bf16_matches_jax(n_fft, hop, mels, batch,
                                                step_frames):
    import jax.numpy as jnp

    from birda_tpu.ops import melspec as jm
    from birda_tpu_torch.ops import melspec as tm

    cfg = tm.MelSpecConfig(sample_rate=32_000, n_fft=n_fft, hop=hop,
                           n_mels=mels, fmax=15_000.0)
    seg = 8 * n_fft + 5
    step = step_frames * hop
    chunk = np.random.default_rng(2).normal(
        0, 0.2, (batch - 1) * step + seg).astype(np.float32)
    want = np.asarray(jm.melspec_from_chunk(
        _jnp(chunk), jm.MelSpecConfig(**vars(cfg)), batch, step, seg,
        compute_dtype=jnp.bfloat16))
    t = torch.from_numpy(chunk)
    got = tm.melspec_from_chunk(t, cfg, batch, step, seg,
                                compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= BF16_MEL_BOUND
    # bf16 is its own route: float32 differs from it
    fp32 = tm.melspec_from_chunk(t, cfg, batch, step, seg)
    assert torch.equal(fp32, tm.melspec_from_chunk(
        t, cfg, batch, step, seg, compute_dtype=torch.float32))
    assert np.abs(fp32.numpy() - want).max() > 0


# -- calibrate's params and min_weight_bytes ---------------------------------------------

def test_calibrate_takes_the_callers_params_as_jax_does():
    from birda_tpu.onnx import quantize as jq
    from birda_tpu_torch.onnx import fullscale as fs
    from birda_tpu_torch.onnx import quantize as tq
    from birda_tpu_torch.onnx.lowering import lower

    g = fs.cached_build(fs.tiny_spec(fs.BIRDNET_V24_SPEC), seed=1)
    batches = list(tq.calibration_signals(g.spec.sample_count, batch=2,
                                          n_batches=1))
    params = {k: (v * 0.5).astype(v.dtype)
              for k, v in lower(g.model_bytes).params.items()}
    assert params
    want = jq.calibrate(g.model_bytes, batches, params=params)
    got = tq.calibrate(g.model_bytes, batches, params={
        k: torch.from_numpy(v) for k, v in params.items()}, device="cpu")
    plain = tq.calibrate(g.model_bytes, batches, device="cpu")
    assert got.stats.keys() == want.stats.keys() == plain.stats.keys()
    moved = 0
    for name, w in want.stats.items():
        assert got.stats[name]["amax"] == pytest.approx(w["amax"], rel=1e-5)
        moved += got.stats[name]["amax"] != plain.stats[name]["amax"]
    assert moved > 0  # the caller's weights were the ones used
    # min_weight_bytes is accepted and changes nothing, as in JAX
    again = tq.calibrate(g.model_bytes, batches, min_weight_bytes=1,
                         device="cpu")
    assert again.stats == plain.stats
