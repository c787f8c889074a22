"""The preflight <-> execute consistency property for the port's evaluator
(the grid of ``tests/test_preflight_property.py``, both sides of every
static rule, and the rules of the families this port added).

The port's preflight is a byte copy of the JAX package's, so it is right
only if the port's evaluator raises where the JAX evaluator raises: every
configuration that preflights clean must execute in the port without an
``UnsupportedOnnxOp``, and every configuration preflight flags must be
refused by the port's ``lower`` with the aggregate ``OnnxGraphUnsupported``
(never a raw first-op raise). A case of an op the port does not have yet is
refused on both sides.
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


def _ported(mb) -> bool:
    return all(hasattr(tl._Evaluator, f"op_{n.op_type}")
               for n in load_model(mb).graph.nodes if n.op_type != "Constant")


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
]

CASES = [(name, ok, build) for name, ok, build in jax_grid.CASES] \
    + PORT_CASES


@pytest.mark.parametrize("expect_ok,build", [(e, b) for _, e, b in CASES],
                         ids=[i for i, _, _ in CASES])
def test_preflight_execute_consistency(expect_ok, build):
    mb, args = build()
    expect_ok = expect_ok and _ported(mb)
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
        mb = b()[0]
        if _ported(mb):
            ops[load_model(mb).graph.nodes[0].op_type].add(ok)
    for op in ("CumSum", "TopK", "Resize", "MaxPool", "DFT", "ArgMax",
               "ArgMin", "Pad", "Cast", "STFT", "QLinearAveragePool",
               "Upsample"):
        assert ops[op] == {True, False}, op
