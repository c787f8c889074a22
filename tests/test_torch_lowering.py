"""ONNX lowering of the PyTorch port (birda_tpu_torch/onnx/lowering.py)
against the JAX package's lowering, on the tiny full-scale graphs.

- fp32: the same graph and inputs through both evaluators agree to fp32
  rounding (bound 1e-4, same top-5).
- bf16 with the fused front-end: the port's plain version on the CPU
  against JAX bf16 through the Pallas kernel in interpret mode (bound
  2e-2 on scores, same argmax), and the same dtype at every node — which
  pins jax.numpy's promotion of bf16 by 0-d float32 constants.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fixtures_onnx as fo
from birda_tpu.onnx import fullscale as fs
from birda_tpu.onnx import fuse as jax_fuse
from birda_tpu.onnx import lowering as jl
from birda_tpu.onnx import proto as jax_proto

from birda_tpu_torch.errors import OnnxGraphUnsupported
from birda_tpu_torch.models import zoo
from birda_tpu_torch.models.contracts import ModelFamily, contract_for
from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.onnx.fuse import FUSED_OP, fuse_mel_frontend
from birda_tpu_torch.onnx.proto import load_model

SPECS = {"v24": fs.BIRDNET_V24_SPEC, "v30": fs.BIRDNET_V30_SPEC}


@pytest.fixture(scope="module")
def graphs():
    return {k: fs.cached_build(fs.tiny_spec(s), seed=1)
            for k, s in SPECS.items()}


def _signal(g, seed=0):
    return np.random.default_rng(seed).normal(
        0, 0.1, (2, g.spec.sample_count)).astype(np.float32)


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v, np.float32)


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype) if not hasattr(v, "dtype") \
        else str(v.dtype)


def _jax_bf16_params(fn):
    return {k: np.asarray(v, jnp.bfloat16) for k, v in fn.params.items()}


@pytest.mark.parametrize("key", ["v24", "v30"])
def test_fp32_matches_jax(graphs, key):
    g = graphs[key]
    x = _signal(g)
    jfn = jl.lower(g.model_bytes)
    j_scores, j_emb = (_np(v) for v in jfn(x, params=jfn.params))
    tfn = tl.lower(g.model_bytes)
    assert not any(n.op_type == FUSED_OP for n in tfn.graph.nodes)
    t_scores, t_emb = (_np(v) for v in tfn(torch.from_numpy(x)))
    assert t_scores.shape == (2, g.spec.num_classes)
    assert t_emb.shape == (2, g.spec.embedding_dim)
    assert np.abs(t_scores - j_scores).max() <= 1e-4
    assert np.abs(t_emb - j_emb).max() <= 1e-4
    top5 = np.argsort(-t_scores, axis=1)[:, :5]
    assert np.array_equal(top5, np.argsort(-j_scores, axis=1)[:, :5])


class _JaxRecorder(jl._Evaluator):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.dtypes = {}

    def _store(self, name, val):
        self.dtypes[name] = _dtype_name(val)
        return val


class _TorchRecorder(tl._Evaluator):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.dtypes = {}

    def _store(self, name, val):
        self.dtypes[name] = _dtype_name(val)
        return val


def _fused(g):
    """The graph with the fused front-end spliced in by the port's pass."""
    model = load_model(g.model_bytes)
    assert fuse_mel_frontend(model.graph) == 1
    return model


def _fused_jax(g):
    """The same, parsed and spliced by the JAX package's own modules."""
    model = jax_proto.load_model(g.model_bytes)
    assert jax_fuse.fuse_mel_frontend(model.graph) == 1
    return model


@pytest.fixture(scope="module")
def jax_bf16_v24(graphs):
    """JAX bf16 on the fused tiny v2.4 graph, the front-end through the
    Pallas kernel in interpret mode, with every node's dtype recorded."""
    g = graphs["v24"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIRDA_STFT_KERNEL", "pallas")
        model = _fused_jax(g)
        ev = _JaxRecorder(model.graph, compute_dtype=jnp.bfloat16,
                          opset=model.opset)
        fn = jl.OnnxFunction(model, evaluator=ev)
        scores, emb = fn(_signal(g), params=_jax_bf16_params(fn))
    return _np(scores), _np(emb), ev.dtypes


def _torch_bf16(g, evaluator_cls=tl._Evaluator):
    model = _fused(g)
    ev = evaluator_cls(model.graph, compute_dtype=torch.bfloat16,
                       opset=model.opset)
    fn = tl.OnnxFunction(model, evaluator=ev)
    params = zoo.params_from_numpy(fn.params, "cpu", torch.bfloat16)
    scores, emb = fn(torch.from_numpy(_signal(g)), params=params)
    return _np(scores), _np(emb), ev


def _assert_bf16_close(t_scores, j_scores):
    assert t_scores.shape == j_scores.shape
    assert np.abs(t_scores - j_scores).max() <= 2e-2
    assert np.array_equal(t_scores.argmax(-1), j_scores.argmax(-1))


def test_bf16_fused_matches_jax_pallas_v24(graphs, jax_bf16_v24):
    j_scores, _, _ = jax_bf16_v24
    t_scores, _, _ = _torch_bf16(graphs["v24"])
    _assert_bf16_close(t_scores, j_scores)


def test_bf16_fused_matches_jax_pallas_v30(graphs, monkeypatch):
    g = graphs["v30"]
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    jfn = jl.lower(g.model_bytes, compute_dtype=jnp.bfloat16)
    assert any(n.op_type == FUSED_OP for n in jfn.graph.nodes)
    j_scores = _np(jfn(_signal(g), params=_jax_bf16_params(jfn))[0])
    t_scores, _, _ = _torch_bf16(g)
    _assert_bf16_close(t_scores, j_scores)


def test_bf16_node_dtypes_match_jax(graphs, jax_bf16_v24):
    _, _, j_dtypes = jax_bf16_v24
    _, _, ev = _torch_bf16(graphs["v24"], _TorchRecorder)
    assert ev.dtypes == j_dtypes
    # The fused front-end is bf16; the standardization after it adds the
    # 0-d float32 std_eps and so turns float32, as in jax.numpy.
    by_op = {}
    for node in load_model(graphs["v24"].model_bytes).graph.nodes:
        by_op.setdefault(node.op_type, []).append(node.outputs[0])
    fused = next(n for n in _fused(graphs["v24"]).graph.nodes
                 if n.op_type == FUSED_OP)
    assert ev.dtypes[fused.outputs[0]] == "bfloat16"
    assert ev.dtypes[by_op["Sqrt"][0]] == "float32"
    assert ev.dtypes[by_op["Conv"][1]] == "bfloat16"


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_weights_carried_from_jax_params(graphs, monkeypatch, precision):
    """params_from_numpy carries the JAX OnnxFunction's params into the
    port: both packages then compute the same function."""
    g = graphs["v24"]
    x = torch.from_numpy(_signal(g, seed=4))
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    bf16 = precision == "bf16"
    jfn = jl.lower(g.model_bytes, compute_dtype=jnp.bfloat16 if bf16
                   else None)
    dtype = torch.bfloat16 if bf16 else None
    own = zoo.onnx_model(g.model_bytes, contract_for(ModelFamily.BIRDNET_V24),
                         zoo.synthetic_labels(g.spec.num_classes),
                         dtype=dtype).apply(x)
    tfn = tl.lower(g.model_bytes, compute_dtype=dtype)
    assert set(tfn.params) == set(jfn.params)
    carried = tfn(x, params=zoo.params_from_numpy(jfn.params, "cpu", dtype))
    assert torch.equal(own["scores"], carried[0].float())
    assert torch.equal(own["embeddings"], carried[1].float())


def test_preflight_lists_every_unsupported_op():
    """Three op types that neither evaluator has (dynamic output shapes)
    are named together in one error; the supported ops are not."""
    w = np.random.default_rng(0).normal(0, 0.1, (4, 1, 3, 3)) \
        .astype(np.float32)
    mb = fo.model(
        [
            fo.node("Conv", ["x", "w"], ["c"],
                    attrs=[fo.attr_ints("kernel_shape", [3, 3])]),
            fo.node("NonZero", ["c"], ["r"]),
            fo.node("Softmax", ["r"], ["s"]),
            fo.node("Unique", ["s"], ["e"]),
            fo.node("NonMaxSuppression", ["e"], ["y"]),
        ],
        inputs=[fo.value_info("x", ["batch", 1, 8, 8])],
        outputs=[fo.value_info("y", ["batch", 4, 6, 6])],
        initializers=[fo.tensor("w", w)],
    )
    with pytest.raises(OnnxGraphUnsupported) as e:
        tl.lower(mb)
    msg = str(e.value)
    assert "3 issue(s)" in msg
    for op in ("NonZero", "Unique", "NonMaxSuppression"):
        assert op in msg
    for op in ("Conv", "Softmax"):
        assert op not in msg


def test_fusion_gate_is_bf16_and_leaves_caller_models_alone(graphs):
    g = graphs["v24"]
    assert not any(n.op_type == FUSED_OP
                   for n in tl.lower(g.model_bytes).graph.nodes)
    assert any(n.op_type == FUSED_OP for n in tl.lower(
        g.model_bytes, compute_dtype=torch.bfloat16).graph.nodes)
    model = load_model(g.model_bytes)
    before = [n.op_type for n in model.graph.nodes]
    tl.lower(model, compute_dtype=torch.bfloat16)
    assert [n.op_type for n in model.graph.nodes] == before


# -- the ops Perch v2 adds: DFT, Squeeze, Softmax -----------------------------

def _both(mb, x, compute=None):
    """The same graph bytes and input through the JAX evaluator and the
    port's (both with the input on the device, so nothing folds on the
    host); float32 numpy outputs of each, and the raw outputs."""
    jfn = jl.lower(mb, compute_dtype=jnp.bfloat16 if compute else None)
    want = jfn(jnp.asarray(x), params=jfn.params)
    tfn = tl.lower(mb, compute_dtype=compute)
    got = tfn(torch.from_numpy(x))
    return _np(got), _np(want), got, want


def _unary_model(op, x_shape, attrs=(), extra_inputs=(), inits=(),
                 opset=17):
    return fo.model(
        [fo.node(op, ["x", *extra_inputs], ["y"], attrs=list(attrs))],
        inputs=[fo.value_info("x", x_shape)],
        outputs=[fo.value_info("y", ["n"])],
        initializers=list(inits), opset=opset)


DFT_CASES = [
    pytest.param((2, 5, 16), [fo.attr_int("axis", 2),
                              fo.attr_int("onesided", 1)], (), (), 17,
                 id="onesided-axis-attribute"),
    pytest.param((2, 5, 16), [fo.attr_int("axis", 2)], (), (), 17,
                 id="two-sided"),
    pytest.param((2, 16, 1), [fo.attr_int("onesided", 1)], ["n"],
                 [fo.tensor("n", np.array(24, np.int64))], 17,
                 id="real-pair-input-with-dft-length"),
    pytest.param((2, 12, 5), [fo.attr_int("onesided", 1)], ["", "ax"],
                 [fo.tensor("ax", np.array(1, np.int64))], 20,
                 id="axis-input"),
]


@pytest.mark.parametrize("shape,attrs,extra,inits,opset", DFT_CASES)
def test_dft_matches_jax(shape, attrs, extra, inits, opset):
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    mb = _unary_model("DFT", list(shape), attrs, extra, inits, opset)
    got, want, t, _ = _both(mb, x)
    assert t.dtype == torch.float32
    assert got.shape == want.shape and got.shape[-1] == 2
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_inverse_dft_is_refused():
    """At load by the preflight, and by the handler itself."""
    mb = _unary_model("DFT", [2, 8, 1], [fo.attr_int("inverse", 1)])
    with pytest.raises(OnnxGraphUnsupported, match="inverse DFT"):
        tl.lower(mb)
    model = load_model(mb)
    ev = tl._Evaluator(model.graph, opset=model.opset)
    with pytest.raises(tl.UnsupportedOnnxOp, match="inverse"):
        ev.op_DFT(model.graph.nodes[0], torch.zeros(2, 8, 1))


@pytest.mark.parametrize("opset,attrs,extra,inits", [
    pytest.param(11, [fo.attr_ints("axes", [1, 3])], (), (),
                 id="axes-attribute-before-13"),
    pytest.param(13, [], ["axes"],
                 [fo.tensor("axes", np.array([-1], np.int64))],
                 id="axes-input-from-13"),
    pytest.param(13, [], (), (), id="every-unit-axis"),
])
def test_squeeze_matches_jax(opset, attrs, extra, inits):
    x = np.random.default_rng(1).normal(0, 1, (2, 1, 3, 1)) \
        .astype(np.float32)
    mb = _unary_model("Squeeze", [2, 1, 3, 1], attrs, extra, inits, opset)
    got, want, _, _ = _both(mb, x)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("opset,attrs", [
    pytest.param(11, [], id="coerced-2d-before-13"),
    pytest.param(11, [fo.attr_int("axis", 2)], id="axis-2-before-13"),
    pytest.param(13, [], id="last-axis-from-13"),
    pytest.param(13, [fo.attr_int("axis", 1)], id="axis-1-from-13"),
])
def test_softmax_matches_jax(opset, attrs):
    x = np.random.default_rng(2).normal(0, 3, (2, 3, 4)).astype(np.float32)
    mb = _unary_model("Softmax", [2, 3, 4], attrs, opset=opset)
    got, want, _, _ = _both(mb, x)
    assert np.abs(got - want).max() <= 1e-6


def test_softmax_keeps_bf16():
    """A bf16 input gives a bf16 softmax, as in jax.numpy, within bf16
    rounding of the JAX result."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.5, (8, 6)).astype(np.float32)
    mb = fo.model(
        [fo.node("MatMul", ["x", "w"], ["h"]),
         fo.node("Softmax", ["h"], ["y"])],
        inputs=[fo.value_info("x", ["n", 8])],
        outputs=[fo.value_info("y", ["n", 6])],
        initializers=[fo.tensor("w", w)])
    x = rng.normal(0, 1, (4, 8)).astype(np.float32)
    jm, tm = jax_proto.load_model(mb), load_model(mb)
    jev = _JaxRecorder(jm.graph, compute_dtype=jnp.bfloat16, opset=jm.opset)
    tev = _TorchRecorder(tm.graph, compute_dtype=torch.bfloat16,
                         opset=tm.opset)
    want = _np(jl.OnnxFunction(jm, evaluator=jev)(jnp.asarray(x)))
    got = _np(tl.OnnxFunction(tm, evaluator=tev)(torch.from_numpy(x)))
    assert tev.dtypes == jev.dtypes
    assert tev.dtypes["y"] == "bfloat16"
    assert np.abs(got - want).max() <= 2e-2


# -- the Conv1d-STFT node in bf16, and tiny Perch v2 end to end --------------

def test_conv1d_stft_node_matches_jax_pallas(monkeypatch):
    """A bf16 single-channel long-kernel Conv with a bias goes through the
    port's conv1d_stft (its plain version here) and matches the JAX
    lowering through the Pallas kernel: bias added after the kernel, bf16
    out."""
    from birda_tpu_torch.ops import stft_conv

    rng = np.random.default_rng(4)
    k, c, s, hop = 512, 34, 8000, 160
    w = rng.normal(0, 0.05, (c, 1, k)).astype(np.float32)
    bias = rng.normal(0, 0.5, c).astype(np.float32)
    t = (s - k) // hop + 1
    mb = fo.model(
        [fo.node("Conv", ["x", "w", "b"], ["y"], attrs=[
            fo.attr_ints("strides", [hop]), fo.attr_ints("kernel_shape", [k])])],
        inputs=[fo.value_info("x", ["batch", 1, s])],
        outputs=[fo.value_info("y", ["batch", c, t])],
        initializers=[fo.tensor("w", w), fo.tensor("b", bias)])
    x = rng.normal(0, 1, (2, 1, s)).astype(np.float32)
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    before = stft_conv.LAUNCHES["conv1d_stft"]
    got, want, tt, jj = _both(mb, x, compute=torch.bfloat16)
    assert stft_conv.LAUNCHES["conv1d_stft"] == before  # CPU: plain version
    assert tt.dtype == torch.bfloat16 and str(jj.dtype) == "bfloat16"
    assert got.shape == want.shape == (2, c, t)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


@pytest.fixture(scope="module")
def perch():
    return fs.cached_build(fs.tiny_spec(fs.PERCH_V2_SPEC), seed=1)


def _row_rel_err(got, want):
    return float((np.abs(got - want).max(-1) / want.max(-1)).max())


def test_perch_fp32_matches_jax(perch):
    x = _signal(perch)
    jfn = jl.lower(perch.model_bytes)
    j_scores, j_emb = (_np(v) for v in jfn(x, params=jfn.params))
    tfn = tl.lower(perch.model_bytes)
    t_scores, t_emb = (_np(v) for v in tfn(torch.from_numpy(x)))
    assert t_scores.shape == (2, perch.spec.num_classes)
    assert _row_rel_err(t_scores, j_scores) <= 1e-4
    assert np.abs(t_emb - j_emb).max() <= 1e-4 * np.abs(j_emb).max()
    top5 = np.argsort(-t_scores, axis=1)[:, :5]
    assert np.array_equal(top5, np.argsort(-j_scores, axis=1)[:, :5])


def test_perch_bf16_matches_jax_pallas(perch, monkeypatch):
    """bf16: the port's framer through conv1d_stft (plain version on the
    CPU) against JAX bf16 with its Pallas kernel in interpret mode; the
    same dtype at every node (the bf16 framer output turns float32 at the
    float32 window, and the DFT runs in float32, as in jax.numpy)."""
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    x = _signal(perch)
    jmodel = jax_proto.load_model(perch.model_bytes)
    jev = _JaxRecorder(jmodel.graph, compute_dtype=jnp.bfloat16,
                       opset=jmodel.opset)
    jfn = jl.OnnxFunction(jmodel, evaluator=jev)
    j_scores = _np(jfn(x, params=_jax_bf16_params(jfn))[0])

    model = load_model(perch.model_bytes)
    tev = _TorchRecorder(model.graph, compute_dtype=torch.bfloat16,
                         opset=model.opset)
    tfn = tl.OnnxFunction(model, evaluator=tev)
    assert not any(n.op_type == FUSED_OP for n in tfn.graph.nodes)
    params = zoo.params_from_numpy(tfn.params, "cpu", torch.bfloat16)
    t_scores = _np(tfn(torch.from_numpy(x), params=params)[0])

    assert t_scores.shape == j_scores.shape
    assert _row_rel_err(t_scores, j_scores) <= 2e-2
    assert np.array_equal(t_scores.argmax(-1), j_scores.argmax(-1))
    assert tev.dtypes == jev.dtypes
    by_op = {}
    for node in model.graph.nodes:
        by_op.setdefault(node.op_type, []).append(node.outputs[0])
    assert tev.dtypes[by_op["Conv"][0]] == "bfloat16"  # the framer
    assert tev.dtypes[by_op["Mul"][0]] == "float32"  # times the window
    assert tev.dtypes[by_op["DFT"][0]] == "float32"
    assert tev.dtypes["predictions"] == "bfloat16"
