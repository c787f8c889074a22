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
from birda_tpu.errors import OnnxGraphUnsupported
from birda_tpu.onnx import fullscale as fs
from birda_tpu.onnx import lowering as jl
from birda_tpu.onnx.fuse import FUSED_OP, fuse_mel_frontend
from birda_tpu.onnx.proto import load_model

from birda_tpu_torch.models import zoo
from birda_tpu_torch.models.contracts import ModelFamily, contract_for
from birda_tpu_torch.onnx import lowering as tl

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
    model = load_model(g.model_bytes)
    assert fuse_mel_frontend(model.graph) == 1
    return model


@pytest.fixture(scope="module")
def jax_bf16_v24(graphs):
    """JAX bf16 on the fused tiny v2.4 graph, the front-end through the
    Pallas kernel in interpret mode, with every node's dtype recorded."""
    g = graphs["v24"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIRDA_STFT_KERNEL", "pallas")
        model = _fused(g)
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
    w = np.random.default_rng(0).normal(0, 0.1, (4, 1, 3, 3)) \
        .astype(np.float32)
    mb = fo.model(
        [
            fo.node("Conv", ["x", "w"], ["c"],
                    attrs=[fo.attr_ints("kernel_shape", [3, 3])]),
            fo.node("Relu", ["c"], ["r"]),
            fo.node("Softmax", ["r"], ["s"]),
            fo.node("Tanh", ["s"], ["y"]),
        ],
        inputs=[fo.value_info("x", ["batch", 1, 8, 8])],
        outputs=[fo.value_info("y", ["batch", 4, 6, 6])],
        initializers=[fo.tensor("w", w)],
    )
    with pytest.raises(OnnxGraphUnsupported) as e:
        tl.lower(mb)
    msg = str(e.value)
    assert "3 issue(s)" in msg
    for op in ("Relu", "Softmax", "Tanh"):
        assert op in msg
    assert "Conv" not in msg


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
