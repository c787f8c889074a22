"""The preflight <-> execute consistency property for the port's evaluator
(the grid of ``tests/test_preflight_property.py``, both sides of every
static rule, and the rules of the families this port added).

The port's preflight is a byte copy of the JAX package's, so it is right
only if the port's evaluator raises where the JAX evaluator raises: every
configuration that preflights clean must execute in the port without an
``UnsupportedOnnxOp``, and every configuration preflight flags must be
refused by the port's ``lower`` with the aggregate ``OnnxGraphUnsupported``
(never a raw first-op raise). A case of an op neither evaluator has (the
grid's unknown op, a dynamic output shape) is refused on both sides.
"""

import numpy as np
import pytest
import torch

import fixtures_onnx as fo
import test_preflight_property as jax_grid

from birda_tpu_torch.errors import OnnxGraphUnsupported
from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.onnx.preflight import preflight
from birda_tpu_torch.onnx.proto import load_model

_vi = jax_grid._vi


def _resize(attrs, opset=17):
    mb = fo.model(
        [fo.node("Resize", ["x", "", "sc"], ["y"], attrs=attrs)],
        inputs=[_vi("x", [1, 1, 4, 4])], outputs=[_vi("y", [1, 1, 8, 8])],
        initializers=[fo.tensor("sc", np.array([1, 1, 2.0, 2.0],
                                               np.float32))], opset=opset)
    return mb, (np.random.default_rng(11).normal(
        size=(1, 1, 4, 4)).astype(np.float32),)


def _pad(mode):
    return jax_grid._case_pad(mode)


def _argmin(sli=0):
    attrs = [fo.attr_int("select_last_index", 1)] if sli else []
    mb = fo.model(
        [fo.node("ArgMin", ["x"], ["y"], attrs=attrs)],
        inputs=[_vi("x", [3, 4])], outputs=[_vi("y", [1, 4], et=7)],
        opset=17)
    return mb, (np.random.default_rng(12).normal(
        size=(3, 4)).astype(np.float32),)


def _upsample_attr():
    mb = fo.model(
        [fo.node("Upsample", ["x"], ["y"], attrs=[
            fo.attr_str("mode", "nearest"),
            fo._str(1, "scales") + fo._float(7, 1.0) + fo._float(7, 1.0)
            + fo._float(7, 2.0) + fo._float(7, 2.0) + fo._int(20, 6)])],
        inputs=[_vi("x", [1, 1, 2, 2])], outputs=[_vi("y", [1, 1, 4, 4])],
        opset=7)
    return mb, (np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2),)


def _attention(kv_cache=False, qk_mode=0):
    """Opset-23 Attention over 4-D Q/K/V, with past K/V inputs or the raw
    Q·Kᵀ output in a given mode."""
    ins = ["q", "k", "v"] + (["", "pk", "pv"] if kv_cache else [])
    outs = ["y", "pres_k", "pres_v", "qk"] if qk_mode is not None else ["y"]
    feeds = ["q", "k", "v"] + (["pk", "pv"] if kv_cache else [])
    mb = fo.model(
        [fo.node("Attention", ins, outs,
                 attrs=[fo.attr_int("qk_matmul_output_mode", qk_mode or 0)])],
        inputs=[_vi(n, [1, 2, 3, 4]) for n in feeds],
        outputs=[_vi(o, [1, 2, 3, 4]) for o in outs], opset=23)
    rng = np.random.default_rng(13)
    return mb, tuple(rng.normal(size=(1, 2, 3, 4)).astype(np.float32)
                     for _ in feeds)


def _mha_key_padding_mask():
    mb = fo.model(
        [fo.node("MultiHeadAttention", ["q", "k", "v", "", "m"], ["y"],
                 attrs=[fo.attr_int("num_heads", 2)],
                 domain="com.microsoft")],
        inputs=[_vi("q", [1, 3, 8]), _vi("k", [1, 3, 8]),
                _vi("v", [1, 3, 8]), _vi("m", [1, 3], et=6)],
        outputs=[_vi("y", [1, 3, 8])], opset=17)
    rng = np.random.default_rng(14)
    return mb, tuple(rng.normal(size=(1, 3, 8)).astype(np.float32)
                     for _ in range(3)) + (np.ones((1, 3), np.int32),)


def _scan(opset):
    """A running-sum Scan at ``opset`` (8 is the refused batch form)."""
    body = fo.graph(
        [fo.node("Add", ["s", "xi"], ["s_out"]),
         fo.node("Identity", ["s_out"], ["yi"])],
        inputs=[_vi("s", []), _vi("xi", [])],
        outputs=[_vi("s_out", []), _vi("yi", [])])
    mb = fo.model(
        [fo.node("Scan", ["s0", "xs"], ["sf", "ys"],
                 attrs=[fo.attr_graph("body", body),
                        fo.attr_int("num_scan_inputs", 1)])],
        inputs=[_vi("xs", [4])], outputs=[_vi("sf", []), _vi("ys", [4])],
        initializers=[fo.tensor("s0", np.float32(0.0))], opset=opset)
    return mb, (np.arange(4, dtype=np.float32),)


S = fo.attr_str
PORT_CASES = [
    ("resize-cubic", True, lambda: _resize([S("mode", "cubic")])),
    ("resize-nearest-ceil", True,
     lambda: _resize([S("mode", "nearest"), S("nearest_mode", "ceil")])),
    ("resize-linear-align-corners", True,
     lambda: _resize([S("mode", "linear"),
                      S("coordinate_transformation_mode", "align_corners")])),
    ("resize-cubic-asymmetric", False,
     lambda: _resize([S("mode", "cubic"),
                      S("coordinate_transformation_mode", "asymmetric")])),
    ("resize-bogus-nearest-mode", False,
     lambda: _resize([S("mode", "nearest"),
                      S("nearest_mode", "round_half_up")])),
    ("resize-exclude-outside", False,
     lambda: _resize([S("mode", "linear"),
                      fo.attr_int("exclude_outside", 1)])),
    ("resize-keep-aspect-ratio", False,
     lambda: _resize([S("mode", "linear"),
                      S("keep_aspect_ratio_policy", "not_larger")], 18)),
    ("pad-reflect", True, lambda: _pad("reflect")),
    ("pad-edge", True, lambda: _pad("edge")),
    ("pad-wrap", True, lambda: _pad("wrap")),
    ("cast-int8", True, lambda: jax_grid._case_cast(to=3)),
    ("cast-double", True, lambda: jax_grid._case_cast(to=11)),
    ("cast-bfloat16", False, lambda: jax_grid._case_cast(to=16)),
    ("argmin", True, _argmin),
    ("argmin-select-last", False, lambda: _argmin(sli=1)),
    ("upsample-opset7-attribute", True, _upsample_attr),
    ("attention", True, _attention),
    ("attention-qk-mode-0", True, lambda: _attention(qk_mode=0)),
    ("attention-kv-cache", False, lambda: _attention(kv_cache=True)),
    ("attention-qk-mode-1", False, lambda: _attention(qk_mode=1)),
    ("mha-key-padding-mask", False, _mha_key_padding_mask),
    ("scan-opset9", True, lambda: _scan(9)),
    ("scan-opset8", False, lambda: _scan(8)),
]

CASES = [(name, ok, build) for name, ok, build in jax_grid.CASES] \
    + PORT_CASES


@pytest.mark.parametrize("expect_ok,build", [(e, b) for _, e, b in CASES],
                         ids=[i for i, _, _ in CASES])
def test_preflight_execute_consistency(expect_ok, build):
    mb, args = build()
    findings = preflight(mb, evaluator=tl._Evaluator)
    if expect_ok:
        assert findings == [], "\n".join(f.render() for f in findings)
        out = tl.lower(mb)(*(torch.from_numpy(np.array(a)) for a in args))
        for o in (out if isinstance(out, tuple) else (out,)):
            a = o.float().numpy() if isinstance(o, torch.Tensor) \
                else np.asarray(o)
            assert a.size > 0
            if a.dtype.kind == "f":
                assert np.all(np.isfinite(a))
    else:
        assert findings, "a refused configuration passes preflight"
        with pytest.raises(OnnxGraphUnsupported):
            tl.lower(mb)(*(torch.from_numpy(np.array(a)) for a in args))


def test_every_ported_static_raise_has_a_case():
    """Each family of this port with a preflight rule has both sides in
    the grid."""
    ops = {load_model(b()[0]).graph.nodes[0].op_type: set()
           for _, _, b in CASES}
    for _, ok, b in CASES:
        ops[load_model(b()[0]).graph.nodes[0].op_type].add(ok)
    for op in ("CumSum", "TopK", "Resize", "MaxPool", "DFT", "ArgMax",
               "ArgMin", "Pad", "Cast", "STFT", "QLinearAveragePool",
               "Upsample", "Attention", "MultiHeadAttention", "GridSample",
               "FusedMatMul", "BitShift", "GatherND", "GroupNormalization",
               "If", "Loop", "Scan"):
        assert ops[op] == {True, False}, op
