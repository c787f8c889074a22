"""The case table of the ported ONNX op families: one small seeded graph per
opset branch and attribute configuration that the JAX evaluator branches
on, for every handler from the elementwise ops through the quantized and
signal ops.

The CPU tests (``tests/test_torch_ops*.py``, ``tests/test_torch_quantized.py``)
run each case through the JAX evaluator and the port and hold them together;
``chip_smoke.py``'s ``ops_breadth`` phase runs each through the port on the
card against its CPU run. It imports numpy and the port's own encoder only,
so that the card's machine, which has no jax, can import it.

Bounds (by a case's ``family``), for float outputs:

- ``elementwise``: rtol and atol 1e-6 (fp32 elementwise ops, reductions);
- ``transcendental``: 1e-5 (Erf, Gelu, Mish, the trigonometric ops);
- ``spatial``: 1e-4 (pooling, normalization, Resize, ConvTranspose,
  Einsum, STFT);
- ``exact``: bit for bit (data movement, and every output of an integer,
  bool, shape, index or quantized kind, in every family);
- ``requant``: the QLinear ops that requantize a float intermediate: at most
  one quantization step, on at most ``REQUANT_SHARE`` of the elements;
- the bf16 route: 2e-2 of the largest magnitude (``BF16_BOUND``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from birda_tpu_torch.onnx import encode as E

BOUNDS = {"elementwise": 1e-6, "transcendental": 1e-5, "spatial": 1e-4,
          "exact": 0.0, "requant": 0.0}
BF16_BOUND = 2e-2
#: Share of a requantized output allowed one step off: a float intermediate
#: that lands within float rounding of a rounding boundary.
REQUANT_SHARE = 0.05

_ELEM = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
         np.dtype(np.int8): 3, np.dtype(np.uint16): 4,
         np.dtype(np.int16): 5, np.dtype(np.int32): 6,
         np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
         np.dtype(np.float16): 10, np.dtype(np.float64): 11,
         np.dtype(np.uint32): 12, np.dtype(np.uint64): 13}


@dataclass(frozen=True)
class Case:
    """One graph and its inputs. ``feeds`` are the graph inputs (device
    values in both evaluators), in order; ``family`` picks the bound."""

    id: str
    family: str
    model: bytes
    feeds: tuple = field(default=())
    #: Whether the bf16 variant (:func:`bf16_model`) applies.
    bf16: bool = False
    #: A typed refusal both evaluators make: ``"preflight"`` (``lower``
    #: raises ``OnnxGraphUnsupported``) or ``"run"`` (the call raises
    #: ``UnsupportedOnnxOp``); empty for a case that runs.
    refused: str = ""


def graph(op, ins, feeds=None, inits=None, attrs=(), outs=1, opset=17,
          domain="", extra_nodes=()):
    """A one-node graph (plus ``extra_nodes`` after it): ``ins`` are the
    node's input names ('' for an absent one), ``feeds`` and ``inits``
    name -> array for the graph inputs and the initializers; ``outs`` is
    the output count or the list of output names ('' for an absent one).
    Returns the model bytes and the feeds in order."""
    feeds = dict(feeds or {})
    inits = dict(inits or {})
    out_names = [f"y{i}" for i in range(outs)] if isinstance(outs, int) \
        else list(outs)
    nodes = [E.node(op, list(ins), out_names, name=f"{op.lower()}_0",
                    attrs=list(attrs), domain=domain)]
    nodes += list(extra_nodes)
    final = [n for n in out_names if n] if not extra_nodes else ["z"]
    mb = E.model(
        nodes,
        inputs=[E.value_info(n, list(a.shape), elem_type=_ELEM[a.dtype])
                for n, a in feeds.items()],
        outputs=[E.value_info(n, ["n"]) for n in final],
        initializers=[tensor(n, a) for n, a in inits.items()],
        opset=opset)
    return mb, tuple(feeds.values())


def tensor(name: str, arr) -> bytes:
    """An initializer of any dtype of ``_ELEM`` (the port's encoder writes
    no 16- or 32-bit unsigned and no int16 tensor)."""
    arr = np.asarray(arr)
    body = b"".join(E._int(1, d) for d in arr.shape)
    body += E._int(2, _ELEM[arr.dtype]) + E._str(8, name)
    return body + E._msg(9, np.ascontiguousarray(arr).tobytes())


def case(cid, family, op, ins, feeds=None, inits=None, attrs=(), outs=1,
         opset=17, domain="", bf16=False, refused=""):
    mb, fv = graph(op, ins, feeds, inits, attrs, outs, opset, domain)
    return Case(cid, family, mb, fv, bf16, refused)


def bf16_model(c: Case) -> tuple[bytes, tuple]:
    """``c``'s graph with its first input through an identity MatMul, so
    that on the bf16 route the op reads a bf16 tensor (the dtype a matmul
    or conv output has there)."""
    from birda_tpu_torch.onnx.proto import load_model

    model = load_model(c.model)
    g = model.graph
    first = g.inputs[0].name
    x = c.feeds[0]
    eye = np.eye(x.shape[-1], dtype=np.float32)
    nodes = [E.node("MatMul", [first + "_in", "bf16_eye"], [first],
                    name="bf16_matmul")]
    for n in g.nodes:
        attrs = [encode_attribute(name, a) for name, a in n.attrs.items()]
        nodes.append(E.node(n.op_type, list(n.inputs), list(n.outputs),
                            name=n.name, attrs=attrs, domain=n.domain))
    inits = [E.tensor(name, t.array) for name, t in g.initializers.items()]
    inits.append(E.tensor("bf16_eye", eye))
    inputs = [E.value_info(first + "_in", list(x.shape))]
    inputs += [E.value_info(vi.name, list(a.shape), elem_type=_ELEM[a.dtype])
               for vi, a in zip(g.inputs[1:], c.feeds[1:])]
    mb = E.model(nodes, inputs=inputs,
                 outputs=[E.value_info(vi.name, ["n"]) for vi in g.outputs],
                 initializers=inits, opset=model.opset)
    return mb, c.feeds


def attr_floats(name: str, vs) -> bytes:
    """A FLOATS attribute (the port's encoder has none)."""
    return (E._str(1, name) + b"".join(E._float(7, float(v)) for v in vs)
            + E._int(20, 6))


def encode_attribute(name: str, a) -> bytes:
    """A parsed attribute (``proto.Attribute``) encoded again."""
    if a.t is not None:
        return E.attr_tensor(name, a.t.array)
    if a.i is not None:
        return E.attr_int(name, a.i)
    if a.f is not None:
        return E.attr_float(name, a.f)
    if a.s is not None:
        return E.attr_str(name, a.s.decode())
    if a.floats:
        return attr_floats(name, a.floats)
    return E.attr_ints(name, list(a.ints))


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).normal(0, scale, shape)).astype(np.float32)


def _uniform(seed, shape, lo, hi):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


A, I, F, S = E.attr_int, E.attr_ints, E.attr_float, E.attr_str


# -- 1. structure and shape ---------------------------------------------------

def structure_cases() -> list[Case]:
    x = _normal(1, (2, 3, 4))
    x4 = _normal(2, (2, 8, 4, 6))
    ints = _rng(3).integers(-50, 50, (3, 5)).astype(np.int64)
    out = [
        case("identity", "exact", "Identity", ["x"], {"x": x}),
        case("identity-host", "exact", "Identity", ["c"], inits={"c": x}),
    ]
    casts = [(1, ints, "int64-to-float"), (6, x * 10, "float-to-int32"),
             (7, x * 10, "float-to-int64"), (9, x, "float-to-bool"),
             (10, x, "float-to-float16"), (11, x, "float-to-double"),
             (2, np.abs(x) * 50, "float-to-uint8"),
             (3, x * 40, "float-to-int8"), (1, x > 0, "bool-to-float"),
             (5, ints, "int64-to-int16")]
    for to, v, name in casts:
        out.append(case(f"cast-{name}", "exact", "Cast", ["x"], {"x": v},
                        attrs=[A("to", to)]))
    out.append(case("cast-host", "exact", "Cast", ["c"], inits={"c": x * 10},
                    attrs=[A("to", 7)]))
    for name, attrs in (("plain", []), ("start", [A("start", 1)]),
                        ("start-end-negative", [A("start", -2),
                                                A("end", -1)]),
                        ("clamped", [A("start", -9), A("end", 9)])):
        out.append(case(f"shape-{name}", "exact", "Shape", ["x"], {"x": x4},
                        attrs=attrs, opset=15))
    out.append(case("size", "exact", "Size", ["x"], {"x": x4}))
    out += [
        case("reshape-zero-and-minus-one", "exact", "Reshape", ["x", "s"],
             {"x": x4}, {"s": np.array([0, -1, 6], np.int64)}),
        case("reshape-allowzero", "exact", "Reshape", ["x", "s"], {"x": x4},
             {"s": np.array([2, 8, 24], np.int64)},
             attrs=[A("allowzero", 1)], opset=14),
        case("reshape-host", "exact", "Reshape", ["c", "s"],
             inits={"c": x, "s": np.array([6, -1], np.int64)}),
        case("split-equal", "exact", "Split", ["x"], {"x": x4},
             attrs=[A("axis", 1)], outs=4, opset=13),
        case("split-input", "exact", "Split", ["x", "sp"], {"x": x4},
             {"sp": np.array([1, 5, 2], np.int64)}, attrs=[A("axis", 1)],
             outs=3, opset=13),
        case("split-attr", "exact", "Split", ["x"], {"x": x4},
             attrs=[A("axis", -1), I("split", [2, 4])], outs=2, opset=11),
        case("split-host", "exact", "Split", ["c"], inits={"c": x},
             attrs=[A("axis", 2)], outs=2, opset=13),
        case("gather-axis0-negative", "exact", "Gather", ["x", "i"],
             {"x": x4}, {"i": np.array([[1, -1], [0, -2]], np.int64)}),
        case("gather-axis2-scalar", "exact", "Gather", ["x", "i"],
             {"x": x4}, {"i": np.array(-1, np.int64)}, attrs=[A("axis", 2)]),
        case("gather-scalar-out-of-range", "exact", "Gather", ["x", "i"],
             {"x": x4}, {"i": np.array(9, np.int64)}, attrs=[A("axis", 1)]),
        case("gather-device-indices", "exact", "Gather", ["x", "i"],
             {"x": x4, "i": np.array([3, 0, 5, -8], np.int64)},
             attrs=[A("axis", 1)]),
        case("gather-host", "exact", "Gather", ["c", "i"],
             inits={"c": np.arange(12, dtype=np.int64),
                    "i": np.array([2, -1], np.int64)}),
        case("gatherelements-axis0", "exact", "GatherElements", ["x", "i"],
             {"x": x}, {"i": _rng(4).integers(-2, 2, (2, 3, 4))
                        .astype(np.int64)}),
        case("gatherelements-axis-last", "exact", "GatherElements",
             ["x", "i"], {"x": x, "i": _rng(5).integers(0, 4, (2, 3, 2))
                          .astype(np.int64)}, attrs=[A("axis", -1)]),
        case("expand", "exact", "Expand", ["x", "s"],
             {"x": _normal(6, (3, 1))},
             {"s": np.array([2, 1, 4], np.int64)}),
        case("expand-host", "exact", "Expand", ["c", "s"],
             inits={"c": np.arange(3, dtype=np.float32).reshape(3, 1),
                    "s": np.array([3, 2], np.int64)}),
        case("tile", "exact", "Tile", ["x", "r"], {"x": x},
             {"r": np.array([1, 2, 3], np.int64)}),
        case("spacetodepth", "exact", "SpaceToDepth", ["x"],
             {"x": _normal(7, (2, 3, 4, 6))}, attrs=[A("blocksize", 2)]),
        case("depthtospace-dcr", "exact", "DepthToSpace", ["x"], {"x": x4},
             attrs=[A("blocksize", 2)]),
        case("depthtospace-crd", "exact", "DepthToSpace", ["x"], {"x": x4},
             attrs=[A("blocksize", 2), S("mode", "CRD")]),
        case("trilu-upper", "exact", "Trilu", ["x"], {"x": x4},
             opset=14),
        case("trilu-lower-k", "exact", "Trilu", ["x", "k"], {"x": x4},
             {"k": np.array(-1, np.int64)}, attrs=[A("upper", 0)],
             opset=14),
        case("trilu-upper-k", "exact", "Trilu", ["x", "k"], {"x": x4},
             {"k": np.array(2, np.int64)}, opset=14),
        case("range", "exact", "Range", ["a", "b", "d"],
             inits={"a": np.array(2, np.int64), "b": np.array(17, np.int64),
                    "d": np.array(3, np.int64)}),
        case("range-negative-delta", "exact", "Range", ["a", "b", "d"],
             inits={"a": np.array(10, np.int64), "b": np.array(-3, np.int64),
                    "d": np.array(-4, np.int64)}),
        case("constantofshape-value", "exact", "ConstantOfShape", ["s"],
             inits={"s": np.array([2, 3], np.int64)},
             attrs=[E.attr_tensor("value", np.array([7], np.int32))]),
        case("constantofshape-default", "exact", "ConstantOfShape", ["s"],
             inits={"s": np.array([4], np.int64)}),
    ]
    pad = np.array([1, 0, 2, 2, 1, 3], np.int64)
    for mode in ("constant", "reflect", "edge", "wrap"):
        out.append(case(f"pad-{mode}", "exact", "Pad", ["x", "p"], {"x": x},
                        {"p": pad}, attrs=[S("mode", mode)]))
    out += [
        case("pad-constant-value", "exact", "Pad", ["x", "p", "v"], {"x": x},
             {"p": pad, "v": np.array(2.5, np.float32)}),
        case("pad-axes", "exact", "Pad", ["x", "p", "", "ax"], {"x": x4},
             {"p": np.array([1, 2, 3, 1], np.int64),
              "ax": np.array([-1, 1], np.int64)},
             attrs=[S("mode", "reflect")], opset=18),
        case("pad-wrap-beyond-size", "exact", "Pad", ["x", "p"], {"x": x},
             {"p": np.array([0, 0, 5, 0, 0, 6], np.int64)},
             attrs=[S("mode", "wrap")]),
        case("pad-reflect-beyond-size", "exact", "Pad", ["x", "p"], {"x": x},
             {"p": np.array([0, 0, 7, 0, 0, 5], np.int64)},
             attrs=[S("mode", "reflect")]),
        case("pad-attr-opset2", "exact", "Pad", ["x"], {"x": x},
             attrs=[I("pads", [0, 1, 1, 0, 1, 1]), S("mode", "edge")],
             opset=2),
        case("pad-int", "exact", "Pad", ["x", "p"], {"x": ints},
             {"p": np.array([1, 1, 0, 2], np.int64)}),
        case("pad-host", "exact", "Pad", ["c", "p"],
             inits={"c": x, "p": pad}, attrs=[S("mode", "edge")]),
    ]
    return out


# -- 2. elementwise, activations, logic ---------------------------------------

UNARY = {  # op: (family, input domain)
    "Sqrt": ("elementwise", "positive"), "Exp": ("elementwise", "normal"),
    "Log": ("elementwise", "positive"), "Neg": ("exact", "normal"),
    "Abs": ("exact", "normal"), "Floor": ("exact", "wide"),
    "Ceil": ("exact", "wide"), "Reciprocal": ("elementwise", "positive"),
    "Erf": ("transcendental", "normal"), "Relu": ("exact", "normal"),
    "Tanh": ("transcendental", "normal"),
    "Softplus": ("elementwise", "wide"), "HardSwish": ("elementwise", "wide"),
    "Mish": ("transcendental", "wide"), "Softsign": ("elementwise", "wide"),
    "Sin": ("transcendental", "wide"), "Cos": ("transcendental", "wide"),
    "Tan": ("transcendental", "normal"),
    "Asin": ("transcendental", "unit"), "Acos": ("transcendental", "unit"),
    "Atan": ("transcendental", "wide"), "Sinh": ("transcendental", "normal"),
    "Cosh": ("transcendental", "normal"),
    "Asinh": ("transcendental", "wide"),
    "Acosh": ("transcendental", "above-one"),
    "Atanh": ("transcendental", "unit"), "Sign": ("exact", "signs"),
    "Round": ("exact", "halves"), "IsNaN": ("exact", "specials"),
    "Sigmoid": ("elementwise", "normal"),
}


def _domain(kind, seed, shape=(2, 3, 5)):
    if kind == "positive":
        return _uniform(seed, shape, 0.05, 4.0)
    if kind == "unit":
        return _uniform(seed, shape, -0.95, 0.95)
    if kind == "above-one":
        return _uniform(seed, shape, 1.0, 5.0)
    if kind == "wide":
        return _normal(seed, shape, 3.0)
    if kind == "signs":
        v = _normal(seed, shape)
        v.reshape(-1)[::4] = 0.0
        return v
    if kind == "halves":
        return (np.round(_normal(seed, shape, 3.0) * 2) / 2).astype(
            np.float32)
    if kind == "specials":
        v = _normal(seed, shape)
        flat = v.reshape(-1)
        flat[::5] = np.nan
        flat[1::7] = np.inf
        flat[2::7] = -np.inf
        return v
    return _normal(seed, shape)


def elementwise_cases() -> list[Case]:
    out = []
    for i, (op, (family, kind)) in enumerate(UNARY.items()):
        x = _domain(kind, 100 + i)
        out.append(case(op.lower(), family, op, ["x"], {"x": x},
                        bf16=kind not in ("specials",)))
    out += [
        case("exp-host", "elementwise", "Exp", ["c"],
             inits={"c": _normal(140, (4,))}),
        case("relu-host", "exact", "Relu", ["c"],
             inits={"c": _normal(141, (4,))}),
        case("erf-host", "transcendental", "Erf", ["c"],
             inits={"c": _normal(142, (4,))}),
        case("neg-int", "exact", "Neg", ["x"],
             {"x": np.arange(-4, 4, dtype=np.int32)}),
        case("abs-int", "exact", "Abs", ["x"],
             {"x": np.arange(-4, 4, dtype=np.int32)}),
        case("relu-int8", "exact", "Relu", ["x"],
             {"x": np.arange(-4, 4, dtype=np.int8)}),
        case("sign-int", "exact", "Sign", ["x"],
             {"x": np.arange(-4, 4, dtype=np.int32)}),
        case("reciprocal-int", "elementwise", "Reciprocal", ["x"],
             {"x": np.arange(1, 9, dtype=np.int32)}),
        case("not", "exact", "Not", ["x"], {"x": _normal(143, (3, 4)) > 0}),
        case("isnan-host", "exact", "IsNaN", ["c"],
             inits={"c": np.array([np.nan, 1.0], np.float32)}),
    ]
    specials = _domain("specials", 150)
    for name, attrs in (("both", []),
                        ("positive", [A("detect_negative", 0)]),
                        ("negative", [A("detect_positive", 0)]),
                        ("neither", [A("detect_negative", 0),
                                     A("detect_positive", 0)])):
        out.append(case(f"isinf-{name}", "exact", "IsInf", ["x"],
                        {"x": specials}, attrs=attrs, opset=10))
    x = _normal(151, (2, 3, 5), 2.0)
    acts = [
        ("leakyrelu", "LeakyRelu", [], "elementwise"),
        ("leakyrelu-alpha", "LeakyRelu", [F("alpha", 0.2)], "elementwise"),
        ("elu", "Elu", [], "elementwise"),
        ("elu-alpha", "Elu", [F("alpha", 0.5)], "elementwise"),
        ("hardsigmoid", "HardSigmoid", [], "elementwise"),
        ("hardsigmoid-alpha-beta", "HardSigmoid",
         [F("alpha", 0.3), F("beta", 0.4)], "elementwise"),
        ("celu", "Celu", [], "elementwise"),
        ("celu-alpha", "Celu", [F("alpha", 2.0)], "elementwise"),
        ("selu", "Selu", [], "elementwise"),
        ("selu-alpha-gamma", "Selu", [F("alpha", 1.5), F("gamma", 1.2)],
         "elementwise"),
        ("thresholdedrelu", "ThresholdedRelu", [], "exact"),
        ("thresholdedrelu-alpha", "ThresholdedRelu", [F("alpha", 0.3)],
         "exact"),
        ("shrink", "Shrink", [], "exact"),
        ("shrink-bias-lambd", "Shrink", [F("bias", 0.5), F("lambd", 1.5)],
         "elementwise"),
        ("gelu", "Gelu", [], "transcendental"),
        ("gelu-tanh", "Gelu", [S("approximate", "tanh")], "transcendental"),
    ]
    for cid, op, attrs, family in acts:
        out.append(case(cid, family, op, ["x"], {"x": x}, attrs=attrs,
                        opset=20 if op == "Gelu" else 17, bf16=True))
    out.append(case("gelu-host", "transcendental", "Gelu", ["c"],
                    inits={"c": _normal(152, (5,))}, opset=20))
    out.append(case("dropout", "exact", "Dropout", ["x"], {"x": x},
                    outs=2, opset=12))
    out.append(case("dropout-training-false", "exact", "Dropout",
                    ["x", "r", "t"], {"x": x},
                    {"r": np.array(0.5, np.float32),
                     "t": np.array(False)}, opset=12))
    for cid, op, opset, attrs in (
            ("logsoftmax-coerced", "LogSoftmax", 11, []),
            ("logsoftmax-axis1-coerced", "LogSoftmax", 11, [A("axis", 1)]),
            ("logsoftmax", "LogSoftmax", 13, []),
            ("logsoftmax-axis1", "LogSoftmax", 13, [A("axis", 1)]),
            ("hardmax-coerced", "Hardmax", 11, []),
            ("hardmax-axis2-coerced", "Hardmax", 11, [A("axis", 2)]),
            ("hardmax", "Hardmax", 13, []),
            ("hardmax-axis1", "Hardmax", 13, [A("axis", 1)])):
        out.append(case(cid, "elementwise" if op == "LogSoftmax" else "exact",
                        op, ["x"], {"x": _normal(153, (2, 3, 4), 3.0)},
                        attrs=attrs, opset=opset, bf16=op == "LogSoftmax"))
    ties = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, -1.0, 2.0]],
                    np.float32)
    out.append(case("hardmax-ties", "exact", "Hardmax", ["x"], {"x": ties},
                    opset=13))
    # Binary and variadic ops.
    a, b = _normal(160, (2, 3, 4)), _normal(161, (3, 4))
    pos = _uniform(162, (2, 3, 4), 0.1, 3.0)
    out += [
        case("pow", "elementwise", "Pow", ["x", "e"], {"x": pos, "e": b},
             bf16=True),
        case("pow-int-exponent", "elementwise", "Pow", ["x", "e"],
             {"x": a}, {"e": np.array(2, np.int64)}, bf16=True),
        case("pow-float-exponent", "elementwise", "Pow", ["x", "e"],
             {"x": pos}, {"e": np.array(0.5, np.float32)}, bf16=True),
        case("min-two", "exact", "Min", ["x", "b"], {"x": a, "b": b},
             bf16=True),
        case("min-three-const", "exact", "Min", ["x", "b", "c"],
             {"x": a, "b": b}, {"c": np.array(0.25, np.float32)}, bf16=True),
        case("max-two", "exact", "Max", ["x", "b"], {"x": a, "b": b},
             bf16=True),
        case("max-one", "exact", "Max", ["x"], {"x": a}),
        case("max-int", "exact", "Max", ["x", "c"],
             {"x": np.arange(-3, 3, dtype=np.int32)},
             {"c": np.array([0], np.int32)}),
        case("prelu-channel", "exact", "PRelu", ["x", "s"],
             {"x": _normal(163, (2, 3, 4, 4))},
             {"s": np.array([0.1, -0.2, 0.3], np.float32).reshape(3, 1, 1)},
             bf16=True),
        case("prelu-scalar", "exact", "PRelu", ["x", "s"], {"x": a},
             {"s": np.array(0.25, np.float32)}, bf16=True),
        case("where", "exact", "Where", ["c", "x", "b"],
             {"c": _normal(164, (3, 4)) > 0, "x": a}, {"b": b}),
        case("where-scalar", "exact", "Where", ["c", "x", "b"],
             {"c": _normal(165, (2, 3, 4)) > 0, "x": a},
             {"b": np.array(-1.0, np.float32)}),
        case("sum-one", "exact", "Sum", ["x"], {"x": a}),
        case("sum-three", "elementwise", "Sum", ["x", "b", "c"],
             {"x": a, "b": b}, {"c": np.array(0.5, np.float32)}, bf16=True),
        case("mean-two", "elementwise", "Mean", ["x", "b"], {"x": a, "b": b},
             bf16=True),
        case("mean-three", "elementwise", "Mean", ["x", "b", "c"],
             {"x": a, "b": b, "c": pos}),
        case("mod-float", "elementwise", "Mod", ["x", "b"],
             {"x": a * 5, "b": b + np.sign(b) * 0.5}, attrs=[A("fmod", 1)]),
        case("mod-int", "exact", "Mod", ["x", "b"],
             {"x": np.arange(-7, 8, dtype=np.int32)},
             {"b": np.array(3, np.int32)}),
        case("mod-int-negative-divisor", "exact", "Mod", ["x", "b"],
             {"x": np.arange(-7, 8, dtype=np.int32)},
             {"b": np.array(-4, np.int32)}),
        case("mod-fmod-int", "exact", "Mod", ["x", "b"],
             {"x": np.arange(-7, 8, dtype=np.int32)},
             {"b": np.array(3, np.int32)}, attrs=[A("fmod", 1)]),
        case("mod-float-floor", "elementwise", "Mod", ["x", "b"],
             {"x": a * 5}, {"b": np.array(-1.5, np.float32)},
             attrs=[A("fmod", 0)]),
    ]
    for op in ("Equal", "Greater", "Less", "GreaterOrEqual", "LessOrEqual"):
        tied = np.round(a * 2).astype(np.float32)
        out.append(case(op.lower(), "exact", op, ["x", "b"],
                        {"x": tied}, {"b": np.round(b * 2).astype(
                            np.float32)}, bf16=True))
        out.append(case(f"{op.lower()}-int", "exact", op, ["x", "b"],
                        {"x": np.arange(-3, 3, dtype=np.int32)},
                        {"b": np.array([1], np.int64)}))
    p, q = _normal(170, (3, 4)) > 0, _normal(171, (3, 4)) > 0
    for op in ("And", "Or", "Xor"):
        out.append(case(op.lower(), "exact", op, ["x", "b"],
                        {"x": p, "b": q}))
    for cid, ins, inits, attrs, opset in (
            ("clip-inputs", ["x", "lo", "hi"], {"lo": np.array(-0.5,
                                                              np.float32),
                                               "hi": np.array(0.7,
                                                              np.float32)},
             [], 13),
            ("clip-min-only", ["x", "lo"], {"lo": np.array(0.0, np.float32)},
             [], 13),
            ("clip-max-only", ["x", "", "hi"],
             {"hi": np.array(0.0, np.float32)}, [], 13),
            ("clip-none", ["x"], {}, [], 13),
            ("clip-attrs", ["x"], {}, [F("min", -0.2), F("max", 0.3)], 6)):
        out.append(case(cid, "exact", "Clip", ins, {"x": a}, inits,
                        attrs=attrs, opset=opset, bf16=True))
    out.append(case("clip-int", "exact", "Clip", ["x", "lo", "hi"],
                    {"x": np.arange(-5, 5, dtype=np.int32)},
                    {"lo": np.array(-2, np.int32),
                     "hi": np.array(3, np.int32)}, opset=13))
    out.append(case("clip-int-no-bounds", "exact", "Clip", ["x"],
                    {"x": np.arange(-5, 5, dtype=np.int32)}, opset=13))
    return out


# -- 3. reductions and selection ----------------------------------------------

REDUCE = {"ReduceSum": "elementwise", "ReduceMean": "elementwise",
          "ReduceMax": "exact", "ReduceMin": "exact",
          "ReduceProd": "elementwise", "ReduceL1": "elementwise",
          "ReduceL2": "elementwise", "ReduceSumSquare": "elementwise",
          "ReduceLogSum": "elementwise", "ReduceLogSumExp": "elementwise"}


def reduction_cases() -> list[Case]:
    out = []
    for i, (op, family) in enumerate(REDUCE.items()):
        x = (_uniform(200 + i, (2, 3, 4), 0.5, 1.5) if op in (
            "ReduceProd", "ReduceLogSum") else _normal(200 + i, (2, 3, 4)))
        low = op.lower()
        out += [
            case(f"{low}-attr-keepdims", family, op, ["x"], {"x": x},
                 attrs=[I("axes", [1])], opset=11, bf16=True),
            case(f"{low}-attr-negative-no-keepdims", family, op, ["x"],
                 {"x": x}, attrs=[I("axes", [-1, 0]), A("keepdims", 0)],
                 opset=11),
            case(f"{low}-all-axes", family, op, ["x"], {"x": x},
                 attrs=[A("keepdims", 0)], opset=11),
            case(f"{low}-axes-input", family, op, ["x", "ax"], {"x": x},
                 {"ax": np.array([0, 2], np.int64)}, opset=18, bf16=True),
            case(f"{low}-empty-axes-noop", family, op, ["x"], {"x": x},
                 attrs=[A("noop_with_empty_axes", 1)], opset=18),
            case(f"{low}-empty-axes-all", family, op, ["x", "ax"], {"x": x},
                 {"ax": np.array([], np.int64)}, attrs=[A("keepdims", 1)],
                 opset=18),
        ]
    out += [
        case("reducesum-int", "exact", "ReduceSum", ["x", "ax"],
             {"x": np.arange(24, dtype=np.int32).reshape(2, 3, 4)},
             {"ax": np.array([1], np.int64)}, opset=13),
        case("reducemean-host", "elementwise", "ReduceMean", ["c"],
             inits={"c": _normal(220, (3, 4))}, attrs=[I("axes", [0])],
             opset=13),
    ]
    x = _normal(230, (3, 4, 5))
    ties = np.array([[1, 5, 5, 0], [7, 7, 7, 2], [0, 0, 1, 1]], np.float32)
    for op in ("ArgMax", "ArgMin"):
        low = op.lower()
        out += [
            case(f"{low}", "exact", op, ["x"], {"x": x}),
            case(f"{low}-axis2-no-keepdims", "exact", op, ["x"], {"x": x},
                 attrs=[A("axis", 2), A("keepdims", 0)]),
            case(f"{low}-negative-axis", "exact", op, ["x"], {"x": x},
                 attrs=[A("axis", -2)]),
            case(f"{low}-ties", "exact", op, ["x"], {"x": ties},
                 attrs=[A("axis", 1)]),
            case(f"{low}-host", "exact", op, ["c"], inits={"c": ties}),
        ]
    out += [
        case("cumsum-axis0", "elementwise", "CumSum", ["x", "ax"], {"x": x},
             {"ax": np.array(0, np.int64)}, bf16=True),
        case("cumsum-negative-axis", "elementwise", "CumSum", ["x", "ax"],
             {"x": x}, {"ax": np.array(-1, np.int32)}),
        case("cumsum-int", "exact", "CumSum", ["x", "ax"],
             {"x": np.arange(12, dtype=np.int32).reshape(3, 4)},
             {"ax": np.array(1, np.int64)}),
        case("cumsum-host", "elementwise", "CumSum", ["c", "ax"],
             inits={"c": _normal(231, (5,)),
                    "ax": np.array(0, np.int64)}),
    ]
    tk = _normal(232, (3, 8))
    tk_ties = np.array([[1, 3, 3, 0, 3, 2], [5, 5, 5, 5, 1, 1]], np.float32)
    out += [
        case("topk", "exact", "TopK", ["x", "k"], {"x": tk},
             {"k": np.array([3], np.int64)}, outs=2),
        case("topk-axis0", "exact", "TopK", ["x", "k"], {"x": tk},
             {"k": np.array([2], np.int64)}, attrs=[A("axis", 0)], outs=2),
        case("topk-ties", "exact", "TopK", ["x", "k"], {"x": tk_ties},
             {"k": np.array([4], np.int64)}, outs=2),
        case("topk-ties-bf16", "exact", "TopK", ["x", "k"], {"x": tk_ties},
             {"k": np.array([3], np.int64)}, outs=2, bf16=True),
        case("topk-host", "exact", "TopK", ["c", "k"],
             inits={"c": tk_ties, "k": np.array([2], np.int64)}, outs=2),
    ]
    return out


# -- 4. spatial ---------------------------------------------------------------

def spatial_cases() -> list[Case]:
    out = []
    x = _normal(300, (2, 3, 7, 9))
    x1 = _normal(301, (2, 3, 11))
    w2 = _normal(302, (3, 4, 3, 3), 0.3)
    w1 = _normal(303, (3, 2, 4), 0.3)
    out += [
        case("convtranspose-2d", "spatial", "ConvTranspose", ["x", "w"],
             {"x": x}, {"w": w2}),
        case("convtranspose-2d-stride-pads-bias", "spatial", "ConvTranspose",
             ["x", "w", "b"], {"x": x},
             {"w": w2, "b": np.array([0.1, -0.2, 0.3, 0.4], np.float32)},
             attrs=[I("strides", [2, 2]), I("pads", [1, 0, 0, 2])]),
        case("convtranspose-2d-dilation", "spatial", "ConvTranspose",
             ["x", "w"], {"x": x}, {"w": w2},
             attrs=[I("dilations", [2, 1]), I("strides", [1, 3])]),
        case("convtranspose-1d", "spatial", "ConvTranspose", ["x", "w"],
             {"x": x1}, {"w": w1}, attrs=[I("strides", [3]),
                                          I("pads", [1, 2])]),
    ]
    pools = [
        ("2x2-s2", [I("kernel_shape", [2, 2]), I("strides", [2, 2])]),
        ("3x3-pads", [I("kernel_shape", [3, 3]), I("pads", [1, 1, 1, 1])]),
        ("3x3-s2-ceil", [I("kernel_shape", [3, 3]), I("strides", [2, 2]),
                         A("ceil_mode", 1)]),
        ("s3-k2-ceil-pads", [I("kernel_shape", [2, 2]),
                             I("strides", [3, 3]), I("pads", [1, 0, 1, 1]),
                             A("ceil_mode", 1)]),
        ("dilated", [I("kernel_shape", [2, 3]), I("dilations", [2, 2])]),
        ("same-upper", [I("kernel_shape", [3, 2]), I("strides", [2, 2]),
                        S("auto_pad", "SAME_UPPER")]),
        ("same-lower", [I("kernel_shape", [3, 2]), I("strides", [2, 1]),
                        S("auto_pad", "SAME_LOWER")]),
        ("valid", [I("kernel_shape", [2, 2]), S("auto_pad", "VALID")]),
    ]
    for name, attrs in pools:
        out.append(case(f"maxpool-{name}", "exact", "MaxPool", ["x"],
                        {"x": x}, attrs=attrs, opset=12, bf16=True))
        out.append(case(f"averagepool-{name}", "spatial", "AveragePool",
                        ["x"], {"x": x}, attrs=attrs, opset=19, bf16=True))
    for name, attrs in (
            ("count-include-pad", [I("kernel_shape", [3, 3]),
                                   I("pads", [1, 1, 1, 1]),
                                   A("count_include_pad", 1)]),
            ("count-include-pad-ceil", [I("kernel_shape", [3, 3]),
                                        I("strides", [2, 2]),
                                        I("pads", [1, 0, 1, 0]),
                                        A("count_include_pad", 1),
                                        A("ceil_mode", 1)])):
        out.append(case(f"averagepool-{name}", "spatial", "AveragePool",
                        ["x"], {"x": x}, attrs=attrs, opset=19))
    out += [
        case("maxpool-1d", "exact", "MaxPool", ["x"], {"x": x1},
             attrs=[I("kernel_shape", [3]), I("strides", [2])]),
        case("averagepool-1d", "spatial", "AveragePool", ["x"], {"x": x1},
             attrs=[I("kernel_shape", [4]), I("pads", [2, 1])]),
        case("maxpool-host", "exact", "MaxPool", ["c"],
             inits={"c": _normal(304, (1, 1, 4, 4))},
             attrs=[I("kernel_shape", [2, 2])]),
        case("globalmaxpool", "exact", "GlobalMaxPool", ["x"], {"x": x},
             bf16=True),
        case("globalmaxpool-1d", "exact", "GlobalMaxPool", ["x"],
             {"x": x1}),
    ]
    ln = _normal(305, (2, 5, 6), 2.0)
    out += [
        case("layernorm", "spatial", "LayerNormalization", ["x", "s", "b"],
             {"x": ln}, {"s": _normal(306, (6,)), "b": _normal(307, (6,))},
             bf16=True),
        case("layernorm-axis1-no-bias", "spatial", "LayerNormalization",
             ["x", "s"], {"x": ln}, {"s": _normal(308, (5, 6))},
             attrs=[A("axis", 1), F("epsilon", 1e-3)]),
        case("instancenorm", "spatial", "InstanceNormalization",
             ["x", "s", "b"], {"x": x},
             {"s": _normal(309, (3,)), "b": _normal(310, (3,))}, bf16=True),
        case("instancenorm-1d", "spatial", "InstanceNormalization",
             ["x", "s", "b"], {"x": x1},
             {"s": _normal(311, (3,)), "b": _normal(312, (3,))},
             attrs=[F("epsilon", 1e-2)]),
        case("lrn", "spatial", "LRN", ["x"], {"x": _normal(313, (2, 6, 4, 5))},
             attrs=[A("size", 3)]),
        case("lrn-even-size", "spatial", "LRN", ["x"],
             {"x": _normal(314, (2, 6, 4, 5))},
             attrs=[A("size", 4), F("alpha", 1e-2), F("beta", 0.5),
                    F("bias", 2.0)]),
    ]
    img = _normal(320, (1, 2, 4, 5))
    up = np.array([1, 1, 2.0, 1.5], np.float32)
    down = np.array([1, 1, 0.5, 0.6], np.float32)
    for nm in ("round_prefer_floor", "round_prefer_ceil", "floor", "ceil"):
        out.append(case(f"resize-nearest-{nm}", "exact", "Resize",
                        ["x", "", "sc"], {"x": img}, {"sc": up},
                        attrs=[S("mode", "nearest"), S("nearest_mode", nm)],
                        bf16=True))
    for ct in ("half_pixel", "pytorch_half_pixel", "asymmetric",
               "align_corners", "tf_half_pixel_for_nn"):
        out.append(case(f"resize-nearest-{ct}", "exact", "Resize",
                        ["x", "", "sc"], {"x": img}, {"sc": up},
                        attrs=[S("mode", "nearest"),
                               S("coordinate_transformation_mode", ct)]))
        if ct != "tf_half_pixel_for_nn":
            out.append(case(f"resize-linear-{ct}", "spatial", "Resize",
                            ["x", "", "sc"], {"x": img}, {"sc": up},
                            attrs=[S("mode", "linear"),
                                   S("coordinate_transformation_mode", ct)],
                            bf16=True))
    out += [
        case("resize-linear-down", "spatial", "Resize", ["x", "", "sc"],
             {"x": img}, {"sc": down}, attrs=[S("mode", "linear")]),
        case("resize-cubic-up", "spatial", "Resize", ["x", "", "sc"],
             {"x": img}, {"sc": up}, attrs=[S("mode", "cubic")]),
        case("resize-cubic-down", "spatial", "Resize", ["x", "", "sc"],
             {"x": _normal(321, (1, 2, 8, 10))}, {"sc": down},
             attrs=[S("mode", "cubic")]),
        case("resize-sizes", "spatial", "Resize", ["x", "", "", "sz"],
             {"x": img}, {"sz": np.array([1, 2, 7, 3], np.int64)},
             attrs=[S("mode", "linear")]),
        case("resize-axes", "exact", "Resize", ["x", "", "sc"], {"x": img},
             {"sc": np.array([3.0, 2.0], np.float32)},
             attrs=[I("axes", [-1, 2])], opset=18),
        case("resize-opset10", "exact", "Resize", ["x", "sc"], {"x": img},
             {"sc": up}, opset=10),
        case("resize-host", "exact", "Resize", ["c", "", "sc"],
             inits={"c": img, "sc": up}),
        case("upsample-nearest", "exact", "Upsample", ["x", "sc"],
             {"x": img}, {"sc": np.array([1, 1, 2, 3], np.float32)},
             opset=9),
        case("upsample-linear", "spatial", "Upsample", ["x", "sc"],
             {"x": img}, {"sc": np.array([1, 1, 2, 1.5], np.float32)},
             attrs=[S("mode", "linear")], opset=9),
        case("upsample-attr", "exact", "Upsample", ["x"], {"x": img},
             attrs=[attr_floats("scales", [1, 1, 3, 2])], opset=7),
        case("upsample-fractional", "exact", "Upsample", ["x", "sc"],
             {"x": img}, {"sc": np.array([1, 1, 1.5, 2.5], np.float32)},
             opset=9),
    ]
    a, b = _normal(330, (3, 4)), _normal(331, (4, 5))
    out += [
        case("einsum-matmul", "spatial", "Einsum", ["x", "b"], {"x": a},
             {"b": b}, attrs=[S("equation", "ij,jk->ik")], opset=12,
             bf16=True),
        case("einsum-batched", "spatial", "Einsum", ["x", "b"],
             {"x": _normal(332, (2, 3, 4)), "b": _normal(333, (2, 4, 5))},
             attrs=[S("equation", "bij,bjk->bik")], opset=12),
        case("einsum-transpose", "spatial", "Einsum", ["x"], {"x": a},
             attrs=[S("equation", "ij->ji")], opset=12),
        case("einsum-diagonal-sum", "spatial", "Einsum", ["x"],
             {"x": _normal(334, (4, 4))}, attrs=[S("equation", "ii->i")],
             opset=12),
        case("einsum-host", "spatial", "Einsum", ["c", "b"],
             inits={"c": a, "b": b}, attrs=[S("equation", "ij,jk->ik")],
             opset=12),
    ]
    return out


# -- 6. signal ----------------------------------------------------------------

def signal_cases() -> list[Case]:
    sig = _normal(400, (2, 256))
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(64) / 64)).astype(
        np.float32)
    out = [
        case("stft-window", "spatial", "STFT", ["x", "st", "w"], {"x": sig},
             {"st": np.array(32, np.int64), "w": win}),
        case("stft-frame-length", "spatial", "STFT", ["x", "st", "", "fl"],
             {"x": sig}, {"st": np.array(40, np.int64),
                          "fl": np.array(48, np.int64)}),
        case("stft-signal-3d", "spatial", "STFT", ["x", "st", "w"],
             {"x": sig[..., None]}, {"st": np.array(16, np.int64), "w": win}),
    ]
    for op in ("HannWindow", "HammingWindow", "BlackmanWindow"):
        low = op.lower()
        out += [
            case(f"{low}-periodic", "exact", op, ["n"],
                 inits={"n": np.array(10, np.int64)}),
            case(f"{low}-symmetric", "exact", op, ["n"],
                 inits={"n": np.array(9, np.int64)},
                 attrs=[A("periodic", 0)]),
            case(f"{low}-double", "exact", op, ["n"],
                 inits={"n": np.array(8, np.int64)},
                 attrs=[A("output_datatype", 11)]),
        ]
    out.append(case("hannwindow-one-sample", "exact", "HannWindow", ["n"],
                    inits={"n": np.array(1, np.int64)},
                    attrs=[A("periodic", 0)]))
    mel = {"b": np.array(8, np.int64), "d": np.array(64, np.int64),
           "r": np.array(16000, np.int64),
           "lo": np.array(20.0, np.float32),
           "hi": np.array(7600.0, np.float32)}
    out.append(case("melweightmatrix", "exact", "MelWeightMatrix",
                    ["b", "d", "r", "lo", "hi"], inits=mel))
    return out


# -- comparison ----------------------------------------------------------------

def to_numpy(v) -> np.ndarray:
    """An output (numpy, jax or torch) as numpy; bf16 as float32."""
    import torch

    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.kind == "V" else a


def mismatch(got, want, family: str, bf16: bool = False) -> str | None:
    """Why ``got`` is not ``want`` within ``family``'s bound (None when it
    is). Integer, bool and exact-family outputs must be equal (NaN equal to
    NaN); a ``requant`` output may be one step off on at most
    ``REQUANT_SHARE`` of its elements; bf16 floats within ``BF16_BOUND`` of
    the largest magnitude."""
    g, w = to_numpy(got), to_numpy(want)
    if g.shape != w.shape:
        return f"shape {g.shape} against {w.shape}"
    if g.size == 0:
        return None
    if g.dtype.kind in "biu" or w.dtype.kind in "biu":
        if family == "requant":
            off = np.abs(g.astype(np.int64) - w.astype(np.int64))
            share = float(np.mean(off > 0))
            if off.max() > 1 or share > REQUANT_SHARE:
                return (f"requantized: {int(off.max())} steps off on "
                        f"{share:.3%} of the elements")
            return None
        if not np.array_equal(g, w):
            return f"{int(np.sum(g != w))} of {g.size} elements differ"
        return None
    g64, w64 = g.astype(np.float64), w.astype(np.float64)
    if bf16:
        scale = max(1.0, float(np.nanmax(np.abs(w64))))
        err = np.nan_to_num(np.abs(g64 - w64), nan=np.inf)
        err[np.isnan(g64) & np.isnan(w64)] = 0
        err[(g64 == w64)] = 0
        if err.max() > BF16_BOUND * scale:
            return f"bf16: {err.max()} over {BF16_BOUND} x {scale}"
        return None
    if family in ("exact", "requant"):
        if not np.array_equal(g64, w64, equal_nan=True):
            return f"not bit-exact: largest difference " \
                f"{np.nanmax(np.abs(g64 - w64))}"
        return None
    tol = BOUNDS[family]
    if not np.allclose(g64, w64, rtol=tol, atol=tol, equal_nan=True):
        bad = ~np.isclose(g64, w64, rtol=tol, atol=tol, equal_nan=True)
        return (f"{int(bad.sum())} elements beyond {tol}: largest "
                f"difference {np.nanmax(np.abs(g64 - w64)[bad])}")
    return None


def all_cases() -> list[Case]:
    """Every case of the table (the quantized ones are in
    ``quantized_cases``)."""
    return (structure_cases() + elementwise_cases() + reduction_cases()
            + spatial_cases() + signal_cases() + quantized_cases()
            + late_cases())


# -- 5. quantized -------------------------------------------------------------

MS = "com.microsoft"


def _u8(seed, shape, lo=0, hi=256):
    return _rng(seed).integers(lo, hi, shape).astype(np.uint8)


def _i8(seed, shape, lo=-128, hi=128):
    v = _rng(seed).integers(lo, hi, shape).astype(np.int8)
    v.reshape(-1)[0] = -128 if lo <= -128 else v.reshape(-1)[0]
    return v


def _f(v):
    return np.asarray(v, np.float32)


def qlinear_conv_cases() -> list[Case]:
    """QLinearConv and ConvInteger: uint8 activations with nonzero zero
    points, int8 weights holding -128, per-channel weight scales and zero
    points, padding, strides and a depthwise group."""
    x = _u8(500, (2, 4, 7, 6))
    w = _i8(501, (5, 4, 3, 3))
    wd = _i8(502, (4, 1, 3, 3))
    x8 = _i8(503, (1, 3, 6, 6))
    w8 = _i8(504, (2, 3, 1, 1))
    b = _rng(505).integers(-3000, 3000, 5).astype(np.int32)

    def qc(cid, xv, wv, xs, xz, ws, wz, ys, yz, attrs, bias=None):
        ins = ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz"]
        inits = {"xs": _f(xs), "xz": xz, "w": wv, "ws": _f(ws), "wz": wz,
                 "ys": _f(ys), "yz": yz}
        if bias is not None:
            ins.append("b")
            inits["b"] = bias
        return case(cid, "exact", "QLinearConv", ins, {"x": xv}, inits,
                    attrs=attrs, opset=13)

    pad = [I("pads", [1, 1, 1, 1]), I("kernel_shape", [3, 3])]
    out = [
        qc("qlinearconv-uint8-pad-bias", x, w, 0.02, np.uint8(131), 0.01,
           np.int8(0), 0.35, np.uint8(120), pad, bias=b),
        qc("qlinearconv-per-channel-stride", x, w, 0.02, np.uint8(7),
           _f([0.01, 0.02, 0.005, 0.03, 0.015]),
           np.array([0, 3, -2, 1, -128], np.int8), 0.5, np.uint8(128),
           [I("pads", [0, 1, 2, 1]), I("strides", [2, 2])]),
        qc("qlinearconv-depthwise", x, wd, 0.02, np.uint8(200), 0.01,
           np.int8(-1), 0.05, np.uint8(100),
           pad + [A("group", 4)]),
        qc("qlinearconv-int8-x", x8, w8, 0.05, np.int8(-5), 0.02,
           np.int8(2), 0.1, np.int8(-3), [I("kernel_shape", [1, 1])]),
    ]
    out += [
        case("convinteger-x-zero-point", "exact", "ConvInteger",
             ["x", "w", "xz"], {"x": x}, {"w": w, "xz": np.uint8(128)},
             attrs=pad, opset=10),
        case("convinteger-both-zero-points", "exact", "ConvInteger",
             ["x", "w", "xz", "wz"], {"x": x},
             {"w": w, "xz": np.uint8(3),
              "wz": np.array([1, -2, 0, 5, -128], np.int8)},
             attrs=[I("strides", [1, 2])], opset=10),
        case("convinteger-no-zero-points", "exact", "ConvInteger",
             ["x", "w"], {"x": x8}, {"w": w8}, opset=10),
    ]
    return out


def qlinear_matmul_cases() -> list[Case]:
    a = _u8(510, (3, 16))
    b = _u8(511, (16, 5))
    a8 = _i8(512, (4, 24))
    b8 = _i8(513, (24, 6))
    out = [
        case("qlinearmatmul-uint8", "exact", "QLinearMatMul",
             ["a", "as", "az", "b", "bs", "bz", "ys", "yz"], {"a": a},
             {"as": _f(0.02), "az": np.uint8(128), "b": b, "bs": _f(0.04),
              "bz": np.uint8(120), "ys": _f(0.5), "yz": np.uint8(128)},
             opset=10),
        case("qlinearmatmul-int8-per-column", "exact", "QLinearMatMul",
             ["a", "as", "az", "b", "bs", "bz", "ys", "yz"], {"a": a8},
             {"as": _f(0.05), "az": np.int8(0), "b": b8,
              "bs": _f([0.01, 0.02, 0.03, 0.015, 0.025, 0.005]),
              "bz": np.zeros(6, np.int8), "ys": _f(0.3), "yz": np.int8(-4)},
             opset=10),
        case("qlinearmatmul-batched", "exact", "QLinearMatMul",
             ["a", "as", "az", "b", "bs", "bz", "ys", "yz"],
             {"a": _u8(514, (2, 3, 16))},
             {"as": _f(0.02), "az": np.uint8(100), "b": b, "bs": _f(0.04),
              "bz": np.uint8(3), "ys": _f(0.4), "yz": np.uint8(90)},
             opset=10),
        case("matmulinteger-a-zero-point", "exact", "MatMulInteger",
             ["a", "b", "az"], {"a": a},
             {"b": b8[:16, :3], "az": np.uint8(100)}, opset=10),
        case("matmulinteger-both-zero-points", "exact", "MatMulInteger",
             ["a", "b", "az", "bz"], {"a": a8},
             {"b": b8, "az": np.int8(-7),
              "bz": np.array([0, 1, -1, 2, -128, 5], np.int8)}, opset=10),
        case("matmulinteger-no-zero-points", "exact", "MatMulInteger",
             ["a", "b"], {"a": a8, "b": b8}, opset=10),
    ]
    return out


def quantized_cases() -> list[Case]:
    x = _normal(520, (2, 3, 5), 2.0)
    ties = (np.arange(-12, 12, dtype=np.float32) * 0.25).reshape(2, 3, 4)
    out = [
        case("quantize-uint8-default", "exact", "QuantizeLinear",
             ["x", "s"], {"x": x}, {"s": _f(0.05)}, opset=13),
        case("quantize-uint8-ties-zero-point", "exact", "QuantizeLinear",
             ["x", "s", "z"], {"x": ties}, {"s": _f(0.5),
                                            "z": np.uint8(128)}, opset=13),
        case("quantize-int8-saturate", "exact", "QuantizeLinear",
             ["x", "s", "z"], {"x": x * 40}, {"s": _f(0.2),
                                              "z": np.int8(-3)}, opset=13),
        case("quantize-per-axis-1", "exact", "QuantizeLinear",
             ["x", "s", "z"], {"x": x},
             {"s": _f([0.01, 0.05, 0.1]),
              "z": np.array([0, -5, 7], np.int8)}, opset=13),
        case("quantize-per-axis-0", "exact", "QuantizeLinear",
             ["x", "s", "z"], {"x": x},
             {"s": _f([0.02, 0.04]), "z": np.array([10, 250], np.uint8)},
             attrs=[A("axis", 0)], opset=13),
        case("quantize-host", "exact", "QuantizeLinear", ["c", "s", "z"],
             inits={"c": x, "s": _f(0.05), "z": np.uint8(128)}, opset=13),
        case("quantize-bf16", "exact", "QuantizeLinear", ["x", "s", "z"],
             {"x": x}, {"s": _f(0.05), "z": np.uint8(128)}, opset=13,
             bf16=True),
        case("dequantize-uint8", "exact", "DequantizeLinear",
             ["x", "s", "z"], {"x": _u8(521, (3, 4))},
             {"s": _f(0.03), "z": np.uint8(140)}, opset=13),
        case("dequantize-int8-per-axis-host", "exact", "DequantizeLinear",
             ["w", "s", "z"],
             inits={"w": _i8(522, (4, 3, 2)), "s": _f([0.1, 0.2, 0.3, 0.4]),
                    "z": np.array([0, 1, -1, -128], np.int8)},
             attrs=[A("axis", 0)], opset=13),
        case("dequantize-int8-per-axis-device", "exact", "DequantizeLinear",
             ["x", "s", "z"], {"x": _i8(523, (2, 3, 4))},
             {"s": _f([0.1, 0.2, 0.3]), "z": np.array([0, 9, -9], np.int8)},
             opset=13),
        case("dequantize-int32-bias", "exact", "DequantizeLinear",
             ["x", "s"], {"x": _rng(524).integers(-9000, 9000, 6).astype(
                 np.int32)}, {"s": _f(1e-4)}, opset=13),
        case("dequantize-int32-per-channel-zero-point", "exact",
             "DequantizeLinear", ["b", "s", "z"],
             inits={"b": _rng(525).integers(-9000, 9000, 4).astype(np.int32),
                    "s": _f([1e-4, 2e-4, 3e-4, 4e-4]),
                    "z": np.zeros(4, np.int32)},
             attrs=[A("axis", 0)], opset=13),
        case("dynamicquantizelinear", "exact", "DynamicQuantizeLinear",
             ["x"], {"x": x}, outs=3, opset=11),
        case("dynamicquantizelinear-positive", "exact",
             "DynamicQuantizeLinear", ["x"],
             {"x": _uniform(526, (3, 4), 0.5, 2.0)}, outs=3, opset=11),
    ]
    out += qlinear_conv_cases() + qlinear_matmul_cases()
    qa, qb = _i8(530, (2, 10)), _i8(531, (1, 10))
    ua = _u8(532, (2, 10))
    out += [
        case("qlinearadd-int8-broadcast", "requant", "QLinearAdd",
             ["a", "as", "az", "b", "bs", "bz", "ys", "yz"], {"a": qa},
             {"as": _f(0.05), "az": np.int8(2), "b": qb, "bs": _f(0.07),
              "bz": np.int8(-3), "ys": _f(0.09), "yz": np.int8(1)},
             domain=MS),
        case("qlinearadd-uint8", "requant", "QLinearAdd",
             ["a", "as", "az", "b", "bs", "bz", "ys", "yz"],
             {"a": ua, "b": _u8(533, (2, 10))},
             {"as": _f(0.02), "az": np.uint8(128), "bs": _f(0.03),
              "bz": np.uint8(100), "ys": _f(0.05), "yz": np.uint8(110)},
             domain=MS),
        case("qlinearmul", "requant", "QLinearMul",
             ["a", "as", "az", "b", "bs", "bz", "ys", "yz"], {"a": qa},
             {"as": _f(0.05), "az": np.int8(0), "b": qb, "bs": _f(0.07),
              "bz": np.int8(4), "ys": _f(0.2), "yz": np.int8(-2)},
             domain=MS),
        case("qlinearsigmoid", "requant", "QLinearSigmoid",
             ["x", "xs", "xz", "ys", "yz"], {"x": qa},
             {"xs": _f(0.05), "xz": np.int8(0), "ys": _f(1 / 256),
              "yz": np.int8(-128)}, domain=MS),
        case("qlinearleakyrelu", "requant", "QLinearLeakyRelu",
             ["x", "xs", "xz", "ys", "yz"], {"x": ua},
             {"xs": _f(0.04), "xz": np.uint8(128), "ys": _f(0.03),
              "yz": np.uint8(60)}, attrs=[F("alpha", 0.1)], domain=MS),
        case("qlinearsoftmax", "requant", "QLinearSoftmax",
             ["x", "xs", "xz", "ys", "yz"], {"x": qa},
             {"xs": _f(0.05), "xz": np.int8(0), "ys": _f(1 / 255),
              "yz": np.uint8(0)}, attrs=[A("axis", -1)], domain=MS),
        case("qlinearaveragepool", "requant", "QLinearAveragePool",
             ["x", "xs", "xz", "ys", "yz"], {"x": _i8(534, (1, 2, 4, 4))},
             {"xs": _f(0.02), "xz": np.int8(0), "ys": _f(0.02),
              "yz": np.int8(0)},
             attrs=[I("kernel_shape", [2, 2]), I("strides", [2, 2])],
             domain=MS),
        case("qlinearaveragepool-pads-count", "requant",
             "QLinearAveragePool", ["x", "xs", "xz", "ys", "yz"],
             {"x": _u8(535, (1, 2, 5, 5))},
             {"xs": _f(0.02), "xz": np.uint8(128), "ys": _f(0.015),
              "yz": np.uint8(120)},
             attrs=[I("kernel_shape", [3, 3]), I("pads", [1, 1, 1, 1]),
                    A("count_include_pad", 1)], domain=MS),
        case("qlinearconcat", "requant", "QLinearConcat",
             ["ys", "yz", "a", "as", "az", "b", "bs", "bz"],
             {"a": qa, "b": _i8(536, (2, 4))},
             {"ys": _f(0.1), "yz": np.int8(0), "as": _f(0.1),
              "az": np.int8(0), "bs": _f(0.2), "bz": np.int8(3)},
             attrs=[A("axis", 1)], domain=MS),
        case("qgemm-float-out", "spatial", "QGemm",
             ["a", "as", "az", "b", "bs", "bz", "c"],
             {"a": _i8(537, (3, 6), -127)},
             {"as": _f(0.02), "az": np.int8(0), "b": _i8(538, (6, 4), -127),
              "bs": _f(0.05), "bz": np.int8(0),
              "c": _rng(539).integers(-100, 100, 4).astype(np.int32)},
             domain=MS),
        case("qgemm-transb-per-channel", "spatial", "QGemm",
             ["a", "as", "az", "b", "bs", "bz"],
             {"a": _i8(540, (3, 6), -127)},
             {"as": _f(0.05), "az": np.int8(0), "b": _i8(541, (4, 6), -127),
              "bs": _f([0.01, 0.02, 0.03, 0.04]),
              "bz": np.zeros(4, np.int8)},
             attrs=[A("transB", 1)], domain=MS),
        case("qgemm-quantized-out", "requant", "QGemm",
             ["a", "as", "az", "b", "bs", "bz", "c", "ys", "yz"],
             {"a": _u8(542, (6, 3))},
             {"as": _f(0.02), "az": np.uint8(128), "b": _i8(543, (6, 5)),
              "bs": _f(0.03), "bz": np.int8(0),
              "c": _rng(544).integers(-50, 50, 5).astype(np.int32),
              "ys": _f(0.1), "yz": np.uint8(128)},
             attrs=[A("transA", 1), F("alpha", 0.5)], domain=MS),
        case("qlinearglobalaveragepool", "requant",
             "QLinearGlobalAveragePool", ["x", "xs", "xz", "ys", "yz"],
             {"x": _u8(545, (2, 3, 4, 5))},
             {"xs": _f(0.02), "xz": np.uint8(128), "ys": _f(0.01),
              "yz": np.uint8(128)}, domain=MS),
        case("qlinearglobalaveragepool-channels-last", "requant",
             "QLinearGlobalAveragePool", ["x", "xs", "xz", "ys", "yz"],
             {"x": _i8(546, (2, 4, 5, 3))},
             {"xs": _f(0.02), "xz": np.int8(0), "ys": _f(0.01),
              "yz": np.int8(0)}, attrs=[A("channels_last", 1)], domain=MS),
    ]
    return out


# -- 6. index and scatter, normalization, spatial extras, bitwise ----------------

def _i64(v):
    return np.asarray(v, np.int64)


def index_cases() -> list[Case]:
    """CastLike through the bitwise ops (``lowering.py:1789-2120`` of the
    JAX package): index, scatter (``none``) and bitwise outputs exactly;
    a float scatter ``add`` over duplicate indices within ``elementwise``
    (its order is not fixed on the card; a ``mul`` over duplicates is
    exact only on integers, so its float case has unique indices);
    normalization, GridSample,
    AffineGrid, Col2Im and Det within ``spatial``."""
    x = _normal(601, (3, 5))
    x3 = _normal(602, (2, 3, 4))
    ints = _rng(603).integers(-9, 9, (3, 5)).astype(np.int32)
    out = [
        case("castlike-device-to-host-int64", "exact", "CastLike",
             ["x", "t"], {"x": x * 10}, {"t": _i64([1])}),
        case("castlike-device-to-device", "exact", "CastLike", ["x", "t"],
             {"x": x * 10, "t": ints[:1, :1]}),
        case("castlike-host-to-device", "exact", "CastLike", ["c", "t"],
             {"t": np.zeros(2, np.int8)}, {"c": x * 10}),
        case("castlike-host-to-host", "exact", "CastLike", ["c", "t"],
             inits={"c": ints, "t": np.zeros(1, np.float16)}),
        case("castlike-to-bool", "exact", "CastLike", ["x", "t"], {"x": x},
             {"t": np.array([True])}),
        case("eyelike", "exact", "EyeLike", ["x"], {"x": x}),
        case("eyelike-k-dtype", "exact", "EyeLike", ["x"], {"x": x},
             attrs=[A("k", 2), A("dtype", 6)]),
        case("eyelike-negative-k-int", "exact", "EyeLike", ["x"],
             {"x": ints}, attrs=[A("k", -1)]),
        case("eyelike-host", "exact", "EyeLike", ["c"], inits={"c": x.T}),
        case("eyelike-bf16", "exact", "EyeLike", ["x"], {"x": x}, bf16=True),
    ]
    idx = _i64([[0, -1, 3], [5, -4, 2]])
    out += [
        case("onehot-wrap-and-out-of-range", "exact", "OneHot",
             ["i", "d", "v"], {"i": idx},
             {"d": _i64(4), "v": np.array([0.5, 2.0], np.float32)}),
        case("onehot-axis0", "exact", "OneHot", ["i", "d", "v"], {"i": idx},
             {"d": _i64([3]), "v": _i64([0, 7])}, attrs=[A("axis", 0)]),
        case("onehot-float-indices-device-values", "exact", "OneHot",
             ["i", "d", "v"], {"i": np.array([0.0, 2.0, -1.0], np.float32),
                               "v": np.array([-1.0, 1.0], np.float32)},
             {"d": np.array(3.0, np.float32)}, attrs=[A("axis", 1)]),
        case("onehot-host", "exact", "OneHot", ["i", "d", "v"],
             inits={"i": idx, "d": _i64(5),
                    "v": np.array([0, 1], np.int32)}),
    ]
    data = _normal(604, (4, 3, 5))
    gi = _i64([[[0, 1], [-1, 2]], [[3, -3], [1, 0]]])
    out += [
        case("gathernd-slices", "exact", "GatherND", ["x", "i"],
             {"x": data}, {"i": gi}),
        case("gathernd-scalars", "exact", "GatherND", ["x", "i"],
             {"x": data}, {"i": _i64([[0, 1, 2], [-1, -1, -1], [2, 0, 4]])}),
        case("gathernd-device-indices", "exact", "GatherND", ["x", "i"],
             {"x": data, "i": _i64([[1], [3], [-2]])}),
        case("gathernd-host-data", "exact", "GatherND", ["c", "i"],
             {"i": _i64([[2, 1]])}, {"c": data}),
        case("gathernd-host", "exact", "GatherND", ["c", "i"],
             inits={"c": data, "i": gi}),
        case("gathernd-batch-dims", "exact", "GatherND", ["x", "i"],
             {"x": data}, {"i": _i64([[0], [1], [2], [0]])},
             attrs=[A("batch_dims", 1)], refused="preflight"),
    ]
    upd = _normal(605, (2, 5))
    uniq = _i64([[2, 1], [-1, 0]])
    dup = _i64([[1, 2], [1, 2]])
    out += [
        case("scatternd-none", "exact", "ScatterND", ["x", "i", "u"],
             {"x": data, "u": upd}, {"i": uniq}),
        case("scatternd-none-rows", "exact", "ScatterND", ["x", "i", "u"],
             {"x": data}, {"i": _i64([[3], [0]]),
                           "u": _normal(606, (2, 3, 5))}),
        case("scatternd-none-device-indices", "exact", "ScatterND",
             ["x", "i", "u"], {"x": data, "i": uniq, "u": upd}),
        case("scatternd-add-duplicates", "elementwise", "ScatterND",
             ["x", "i", "u"], {"x": data, "u": upd}, {"i": dup},
             attrs=[S("reduction", "add")], opset=16),
        case("scatternd-add-int", "exact", "ScatterND", ["x", "i", "u"],
             {"x": ints}, {"i": _i64([[1], [1], [0]]),
                           "u": _rng(607).integers(-5, 5, (3, 5))
                           .astype(np.int32)},
             attrs=[S("reduction", "add")], opset=16),
        case("scatternd-mul", "exact", "ScatterND", ["x", "i", "u"],
             {"x": data, "u": upd}, {"i": uniq},
             attrs=[S("reduction", "mul")], opset=16),
        case("scatternd-mul-duplicates-int", "exact", "ScatterND",
             ["x", "i", "u"], {"x": ints}, {"i": _i64([[2], [2], [0]]),
                                            "u": _rng(612).integers(
                                                -3, 4, (3, 5))
                                            .astype(np.int32)},
             attrs=[S("reduction", "mul")], opset=16),
        case("scatternd-max", "exact", "ScatterND", ["x", "i", "u"],
             {"x": data, "u": upd}, {"i": dup},
             attrs=[S("reduction", "max")], opset=18),
        case("scatternd-min", "exact", "ScatterND", ["x", "i", "u"],
             {"x": data, "u": upd}, {"i": uniq},
             attrs=[S("reduction", "min")], opset=18),
        case("scatternd-host", "exact", "ScatterND", ["c", "i", "u"],
             inits={"c": data, "i": uniq, "u": upd}),
        case("scatternd-reduction-unknown", "exact", "ScatterND",
             ["x", "i", "u"], {"x": data, "u": upd}, {"i": uniq},
             attrs=[S("reduction", "mean")], refused="run"),
    ]
    sx = _normal(608, (3, 4))
    si = _i64([[1, 0, 2, -1], [0, 2, 1, 0]])
    su = _normal(609, (2, 4))
    out += [
        case("scatterelements-none", "exact", "ScatterElements",
             ["x", "i", "u"], {"x": sx, "u": su}, {"i": si}),
        case("scatterelements-axis1", "exact", "ScatterElements",
             ["x", "i", "u"], {"x": sx, "u": _normal(610, (3, 2))},
             {"i": _i64([[0, 3], [-1, 1], [2, 0]])}, attrs=[A("axis", 1)]),
        case("scatterelements-host", "exact", "ScatterElements",
             ["c", "i", "u"], inits={"c": sx, "i": si, "u": su}),
        case("scatterelements-add", "elementwise", "ScatterElements",
             ["x", "i", "u"], {"x": sx, "u": su},
             {"i": _i64([[1, 1, 1, 1], [1, 1, 1, 1]])},
             attrs=[S("reduction", "add")], opset=16),
        case("scatterelements-mul-host", "exact", "ScatterElements",
             ["c", "i", "u"], inits={"c": sx, "i": si, "u": su},
             attrs=[S("reduction", "mul")], opset=16),
        case("scatterelements-max", "exact", "ScatterElements",
             ["x", "i", "u"], {"x": sx, "u": su},
             {"i": _i64([[0, 0, 0, 0], [0, 0, 0, 0]])},
             attrs=[S("reduction", "max")], opset=18),
        case("scatterelements-min", "exact", "ScatterElements",
             ["x", "i", "u"], {"x": sx, "u": su}, {"i": si},
             attrs=[S("reduction", "min")], opset=18),
        case("scatter-opset9", "exact", "Scatter", ["x", "i", "u"],
             {"x": sx, "u": su}, {"i": si}, opset=9),
    ]
    g4 = _normal(611, (2, 6, 3, 4))
    out += [
        case("groupnorm-per-channel", "spatial", "GroupNormalization",
             ["x", "s", "b"], {"x": g4},
             {"s": _uniform(612, (6,), 0.5, 1.5), "b": _normal(613, (6,))},
             attrs=[A("num_groups", 3)], opset=21, bf16=True),
        case("groupnorm-per-group", "spatial", "GroupNormalization",
             ["x", "s", "b"], {"x": g4},
             {"s": _uniform(614, (2,), 0.5, 1.5), "b": _normal(615, (2,))},
             attrs=[A("num_groups", 2), F("epsilon", 1e-3)], opset=18),
        case("groupnorm-3d-host", "spatial", "GroupNormalization",
             ["c", "s", "b"],
             inits={"c": _normal(616, (2, 4, 5)),
                    "s": np.ones(4, np.float32), "b": np.zeros(4, np.float32)},
             attrs=[A("num_groups", 4)], opset=21),
        case("groupnorm-uneven-groups", "spatial", "GroupNormalization",
             ["x", "s", "b"], {"x": g4},
             {"s": np.ones(6, np.float32), "b": np.zeros(6, np.float32)},
             attrs=[A("num_groups", 4)], opset=21, refused="run"),
        case("rmsnorm", "spatial", "RMSNormalization", ["x", "s"],
             {"x": x3}, {"s": _uniform(617, (4,), 0.5, 1.5)}, opset=23,
             bf16=True),
        case("rmsnorm-axis1", "spatial", "RMSNormalization", ["x", "s"],
             {"x": x3}, {"s": _uniform(618, (3, 4), 0.5, 1.5)},
             attrs=[A("axis", 1), F("epsilon", 1e-2)], opset=23),
        case("rmsnorm-host", "spatial", "RMSNormalization", ["c", "s"],
             inits={"c": x3, "s": np.ones(4, np.float32)}, opset=23),
        case("simplifiedlayernorm", "spatial",
             "SimplifiedLayerNormalization", ["x", "s"], {"x": x3},
             {"s": _uniform(619, (4,), 0.5, 1.5)}, bf16=True),
    ]
    rs = _normal(620, (5, 3, 2))
    out += [
        case("reversesequence-time-major", "exact", "ReverseSequence",
             ["x", "l"], {"x": rs}, {"l": _i64([5, 2, 1])}, bf16=True),
        case("reversesequence-batch-major", "exact", "ReverseSequence",
             ["x", "l"], {"x": rs, "l": _i64([3, 4, 0, 5, 1])},
             attrs=[A("batch_axis", 0), A("time_axis", 1)]),
        case("reversesequence-host", "exact", "ReverseSequence", ["c", "l"],
             inits={"c": rs, "l": _i64([1, 5, 3])}),
        case("centercroppad", "exact", "CenterCropPad", ["x", "s"],
             {"x": _normal(621, (5, 4, 6))}, {"s": _i64([3, 7, 6])},
             opset=18, bf16=True),
        case("centercroppad-axes", "exact", "CenterCropPad", ["x", "s"],
             {"x": _normal(622, (2, 5, 4))}, {"s": _i64([8, 2])},
             attrs=[I("axes", [-1, 1])], opset=18),
        case("centercroppad-host", "exact", "CenterCropPad", ["c", "s"],
             inits={"c": x, "s": _i64([4, 4])}, opset=18),
    ]
    out += [
        case("col2im", "spatial", "Col2Im", ["x", "img", "blk"],
             {"x": _normal(623, (2, 3 * 4, 12))},
             {"img": _i64([4, 5]), "blk": _i64([2, 2])}, opset=18,
             bf16=True),
        case("col2im-strides-pads-dilations", "spatial", "Col2Im",
             ["x", "img", "blk"], {"x": _normal(624, (1, 2 * 9, 9))},
             {"img": _i64([5, 5]), "blk": _i64([3, 3])},
             attrs=[I("strides", [2, 2]), I("pads", [1, 1, 1, 1]),
                    I("dilations", [1, 1])], opset=18),
        case("col2im-dilated", "spatial", "Col2Im", ["x", "img", "blk"],
             {"x": _normal(625, (1, 4, 12))},
             {"img": _i64([5, 6]), "blk": _i64([2, 2])},
             attrs=[I("dilations", [2, 2])], opset=18),
        case("col2im-3d", "spatial", "Col2Im", ["x", "img", "blk"],
             {"x": _normal(626, (1, 8, 8))},
             {"img": _i64([3, 3, 3]), "blk": _i64([2, 2, 2])}, opset=18,
             refused="run"),
    ]
    img = _normal(627, (2, 3, 5, 6))
    grid = _uniform(628, (2, 4, 7, 2), -1.3, 1.3)
    out += [
        case("gridsample-bilinear-zeros", "spatial", "GridSample",
             ["x", "g"], {"x": img, "g": grid}, opset=16, bf16=True),
        case("gridsample-linear-border-align", "spatial", "GridSample",
             ["x", "g"], {"x": img}, {"g": grid},
             attrs=[S("mode", "linear"), S("padding_mode", "border"),
                    A("align_corners", 1)], opset=20),
        case("gridsample-nearest", "spatial", "GridSample", ["x", "g"],
             {"x": img, "g": grid}, attrs=[S("mode", "nearest")], opset=20),
        case("gridsample-bicubic", "spatial", "GridSample", ["x", "g"],
             {"x": img, "g": grid}, attrs=[S("mode", "cubic")], opset=20,
             refused="preflight"),
        case("gridsample-reflection", "spatial", "GridSample", ["x", "g"],
             {"x": img, "g": grid}, attrs=[S("padding_mode", "reflection")],
             opset=16, refused="preflight"),
        case("gridsample-3d", "spatial", "GridSample", ["x", "g"],
             {"x": _normal(629, (1, 2, 3, 4, 5)),
              "g": _uniform(630, (1, 2, 2, 2, 3), -1, 1)}, opset=20,
             refused="run"),
    ]
    theta = _normal(631, (2, 2, 3), 0.5)
    out += [
        case("affinegrid", "spatial", "AffineGrid", ["t", "s"],
             {"t": theta}, {"s": _i64([2, 3, 4, 5])}, opset=20),
        case("affinegrid-align-corners", "spatial", "AffineGrid", ["t", "s"],
             {"t": theta}, {"s": _i64([2, 1, 3, 1])},
             attrs=[A("align_corners", 1)], opset=20),
        case("affinegrid-host", "spatial", "AffineGrid", ["t", "s"],
             inits={"t": theta, "s": _i64([2, 1, 2, 3])}, opset=20),
        case("affinegrid-3d", "spatial", "AffineGrid", ["t", "s"],
             {"t": _normal(632, (1, 3, 4))}, {"s": _i64([1, 1, 2, 2, 2])},
             opset=20, refused="run"),
        case("det-2x2", "spatial", "Det", ["x"],
             {"x": _normal(633, (3, 2, 2))}),
        case("det-3x3", "spatial", "Det", ["x"], {"x": _normal(634, (3, 3))}),
        case("det-batched-4x4", "spatial", "Det", ["x"],
             {"x": _normal(635, (2, 3, 4, 4))}),
        case("det-singular", "spatial", "Det", ["x"],
             {"x": np.array([[1, 2, 3], [2, 4, 6], [1, 0, 1]], np.float32)}),
        case("det-host", "spatial", "Det", ["c"],
             inits={"c": _normal(636, (2, 5, 5))}),
    ]
    shifts = {np.uint8: 7, np.uint16: 15, np.uint32: 31}
    for dt, top in shifts.items():
        name = np.dtype(dt).name
        v = _rng(637).integers(0, np.iinfo(dt).max, (3, 4), dtype=np.uint64) \
            .astype(dt)
        sh = _rng(638).integers(0, top + 1, (3, 4)).astype(dt)
        for d in ("LEFT", "RIGHT"):
            out.append(case(f"bitshift-{d.lower()}-{name}", "exact",
                            "BitShift", ["a", "b"], {"a": v, "b": sh},
                            attrs=[S("direction", d)], opset=11))
        out += [
            case(f"bitwiseand-{name}", "exact", "BitwiseAnd", ["a", "b"],
                 {"a": v, "b": sh[::-1].copy()}, opset=18),
            case(f"bitwiseor-{name}", "exact", "BitwiseOr", ["a", "b"],
                 {"a": v, "b": sh}, opset=18),
            case(f"bitwisexor-{name}", "exact", "BitwiseXor", ["a", "b"],
                 {"a": v, "b": v[::-1].copy()}, opset=18),
            case(f"bitwisenot-{name}", "exact", "BitwiseNot", ["a"],
                 {"a": v}, opset=18),
        ]
    u64 = _rng(639).integers(0, 2**32, (5,), dtype=np.uint64)
    out += [
        case("bitshift-right-uint64", "exact", "BitShift", ["a", "b"],
             {"a": u64}, {"b": np.array([3], np.uint64)},
             attrs=[S("direction", "RIGHT")], opset=11),
        case("bitshift-left-host", "exact", "BitShift", ["a", "b"],
             inits={"a": np.array([1, 3, 255], np.uint8),
                    "b": np.array([1, 7, 0], np.uint8)},
             attrs=[S("direction", "LEFT")], opset=11),
        case("bitshift-bogus-direction", "exact", "BitShift", ["a", "b"],
             {"a": np.array([1, 2], np.uint8)},
             {"b": np.array([1], np.uint8)}, attrs=[S("direction", "UP")],
             opset=11, refused="preflight"),
        case("bitwiseand-int32", "exact", "BitwiseAnd", ["a", "b"],
             {"a": ints, "b": ints[::-1].copy()}, opset=18),
        case("bitwiseor-int8-host", "exact", "BitwiseOr", ["a", "b"],
             inits={"a": np.array([-1, 5, 64], np.int8),
                    "b": np.array([3, -8, 1], np.int8)}, opset=18),
        case("bitwisexor-int64", "exact", "BitwiseXor", ["a", "b"],
             {"a": _rng(640).integers(-99, 99, (4,)).astype(np.int64),
              "b": _rng(641).integers(-99, 99, (4,)).astype(np.int64)},
             opset=18),
        case("bitwisenot-int16", "exact", "BitwiseNot", ["a"],
             {"a": np.array([0, -1, 300, -32768], np.int16)}, opset=18),
    ]
    return out


# -- 7. the transformer family --------------------------------------------------

def transformer_cases() -> list[Case]:
    """Opset-23 Attention, com.microsoft MultiHeadAttention and the fused
    ops of ORT-optimizer exports (``lowering.py:2118-2370``): attention
    and the layer norms within ``spatial``, the gelu forms within
    ``transcendental``."""
    b, h, s, d = 2, 4, 5, 8
    q = _normal(701, (b, h, s, d))
    k = _normal(702, (b, h, 7, d))
    v = _normal(703, (b, h, 7, d))
    q3 = _normal(704, (b, s, h * d))
    k3 = _normal(705, (b, 7, 2 * d))
    v3 = _normal(706, (b, 7, 2 * d))
    bool_mask = _rng(707).random((s, 7)) > 0.3
    bool_mask[:, 0] = True
    add_mask = _normal(708, (1, 1, s, 7))
    out = [
        case("attention-4d", "spatial", "Attention", ["q", "k", "v"],
             {"q": q, "k": k, "v": v}, opset=23, bf16=True),
        case("attention-3d-gqa", "spatial", "Attention", ["q", "k", "v"],
             {"q": q3, "k": k3, "v": v3},
             attrs=[A("q_num_heads", h), A("kv_num_heads", 2)], opset=23,
             bf16=True),
        case("attention-bool-mask", "spatial", "Attention",
             ["q", "k", "v", "m"], {"q": q, "k": k, "v": v},
             {"m": bool_mask}, opset=23),
        case("attention-additive-mask-scale", "spatial", "Attention",
             ["q", "k", "v", "m"], {"q": q, "k": k, "v": v, "m": add_mask},
             attrs=[F("scale", 0.2)], opset=23),
        case("attention-causal-square", "spatial", "Attention",
             ["q", "k", "v"], {"q": q, "k": q, "v": q},
             attrs=[A("is_causal", 1)], opset=23),
        case("attention-causal-upper-left", "spatial", "Attention",
             ["q", "k", "v", "m"], {"q": q, "k": k, "v": v},
             {"m": add_mask}, attrs=[A("is_causal", 1)], opset=23),
        case("attention-softcap-after-mask", "spatial", "Attention",
             ["q", "k", "v", "m"], {"q": q * 3, "k": k, "v": v,
                                    "m": add_mask},
             attrs=[F("softcap", 2.0)], opset=23),
        case("attention-present-and-qk", "spatial", "Attention",
             ["q", "k", "v", "m"], {"q": q, "k": k, "v": v},
             {"m": bool_mask}, outs=4, opset=23),
        case("attention-present-3d", "spatial", "Attention",
             ["q", "k", "v"], {"q": q3, "k": k3, "v": v3},
             attrs=[A("q_num_heads", h), A("kv_num_heads", 2)], outs=3,
             opset=23),
        case("attention-host", "spatial", "Attention", ["q", "k", "v"],
             inits={"q": q, "k": k, "v": v}, opset=23),
        case("attention-kv-cache", "spatial", "Attention",
             ["q", "k", "v", "", "pk", "pv"],
             {"q": q, "k": k, "v": v, "pk": k, "pv": v}, opset=23,
             refused="preflight"),
        case("attention-qk-mode", "spatial", "Attention", ["q", "k", "v"],
             {"q": q, "k": k, "v": v},
             attrs=[A("qk_matmul_output_mode", 1)], outs=4, opset=23,
             refused="preflight"),
        case("attention-3d-without-heads", "spatial", "Attention",
             ["q", "k", "v"], {"q": q3, "k": k3, "v": v3}, opset=23,
             refused="run"),
        case("attention-gqa-not-a-multiple", "spatial", "Attention",
             ["q", "k", "v"], {"q": _normal(709, (1, 3, 4, 8)),
                               "k": _normal(710, (1, 2, 4, 8)),
                               "v": _normal(711, (1, 2, 4, 8))}, opset=23,
             refused="run"),
    ]
    hid = h * d
    qs, ks, vs = (_normal(712 + i, (b, n, hid)) for i, n in
                  enumerate((s, 7, 7)))
    bias = _normal(715, (3 * hid,), 0.3)
    packed_qkv = _normal(716, (b, s, h, 3, d))
    packed_kv = _normal(717, (b, 7, h, 2, d))
    ms = "com.microsoft"
    out += [
        case("mha-separate-bias", "spatial", "MultiHeadAttention",
             ["q", "k", "v", "b"], {"q": qs, "k": ks, "v": vs}, {"b": bias},
             attrs=[A("num_heads", h)], domain=ms, bf16=True),
        case("mha-separate-attention-bias", "spatial", "MultiHeadAttention",
             ["q", "k", "v", "", "", "ab"], {"q": qs, "k": ks, "v": vs},
             {"ab": _normal(718, (1, h, s, 7))},
             attrs=[A("num_heads", h), F("scale", 0.1)], domain=ms),
        case("mha-packed-qkv", "spatial", "MultiHeadAttention", ["q"],
             {"q": packed_qkv}, attrs=[A("num_heads", h)], domain=ms),
        case("mha-packed-kv", "spatial", "MultiHeadAttention", ["q", "k"],
             {"q": qs, "k": packed_kv}, attrs=[A("num_heads", h)], domain=ms),
        case("mha-key-padding-mask", "spatial", "MultiHeadAttention",
             ["q", "k", "v", "", "kpm"], {"q": qs, "k": ks, "v": vs},
             {"kpm": np.ones((b, 7), np.int32)}, attrs=[A("num_heads", h)],
             domain=ms, refused="preflight"),
        case("mha-without-num-heads", "spatial", "MultiHeadAttention",
             ["q", "k", "v"], {"q": qs, "k": ks, "v": vs}, domain=ms,
             refused="preflight"),
        case("mha-past-kv", "spatial", "MultiHeadAttention",
             ["q", "k", "v", "", "", "", "pk", "pv"],
             {"q": qs, "k": ks, "v": vs, "pk": k, "pv": v},
             attrs=[A("num_heads", h)], domain=ms, refused="preflight"),
        case("mha-packed-qkv-with-bias", "spatial", "MultiHeadAttention",
             ["q", "", "", "b"], {"q": packed_qkv}, {"b": bias},
             attrs=[A("num_heads", h)], domain=ms, refused="run"),
        case("mha-packed-query-rank", "spatial", "MultiHeadAttention", ["q"],
             {"q": qs}, attrs=[A("num_heads", h)], domain=ms, refused="run"),
    ]
    a3 = _normal(719, (2, 3, 6))
    out += [
        case("fusedmatmul", "spatial", "FusedMatMul", ["a", "b"],
             {"a": a3}, {"b": _normal(720, (6, 4))}, domain=ms, bf16=True),
        case("fusedmatmul-transb-alpha", "spatial", "FusedMatMul",
             ["a", "b"], {"a": a3}, {"b": _normal(721, (4, 6))},
             attrs=[A("transB", 1), F("alpha", 0.5)], domain=ms, bf16=True),
        case("fusedmatmul-transa-batched", "spatial", "FusedMatMul",
             ["a", "b"], {"a": a3, "b": _normal(722, (2, 3, 5))},
             attrs=[A("transA", 1)], domain=ms),
        case("fusedmatmul-host", "spatial", "FusedMatMul", ["a", "b"],
             inits={"a": a3, "b": _normal(723, (6, 2))}, domain=ms),
        case("fusedmatmul-trans-batch", "spatial", "FusedMatMul",
             ["a", "b"], {"a": a3, "b": a3}, attrs=[A("transBatchA", 1)],
             domain=ms, refused="preflight"),
    ]
    g = _normal(724, (2, 3, 8))
    gb = _normal(725, (8,), 0.5)
    out += [
        case("fastgelu", "transcendental", "FastGelu", ["x"], {"x": g},
             domain=ms, bf16=True),
        case("fastgelu-bias", "transcendental", "FastGelu", ["x", "b"],
             {"x": g}, {"b": gb}, domain=ms, bf16=True),
        case("fastgelu-host", "transcendental", "FastGelu", ["c"],
             inits={"c": g}, domain=ms),
        case("biasgelu", "transcendental", "BiasGelu", ["x", "b"], {"x": g},
             {"b": gb}, domain=ms, bf16=True),
        case("biasgelu-host", "transcendental", "BiasGelu", ["c", "b"],
             inits={"c": g, "b": gb}, domain=ms),
        case("quickgelu", "transcendental", "QuickGelu", ["x"], {"x": g},
             domain=ms, bf16=True),
        case("quickgelu-alpha-host", "transcendental", "QuickGelu", ["c"],
             inits={"c": g}, attrs=[F("alpha", 1.5)], domain=ms),
    ]
    skip = _normal(726, (2, 3, 8))
    gamma = _uniform(727, (8,), 0.5, 1.5)
    beta = _normal(728, (8,), 0.1)
    out += [
        case("skiplayernorm", "spatial", "SkipLayerNormalization",
             ["x", "s", "g", "b", "bias"], {"x": g, "s": skip},
             {"g": gamma, "b": beta, "bias": gb}, domain=ms, bf16=True),
        case("skiplayernorm-no-beta", "spatial", "SkipLayerNormalization",
             ["x", "s", "g"], {"x": g, "s": skip}, {"g": gamma},
             attrs=[F("epsilon", 1e-5)], domain=ms),
        case("skiplayernorm-sum-output", "spatial",
             "SkipLayerNormalization", ["x", "s", "g", "b", "bias"],
             {"x": g, "s": skip}, {"g": gamma, "b": beta, "bias": gb},
             outs=["y0", "", "", "y3"], domain=ms),
        case("skiplayernorm-host", "spatial", "SkipLayerNormalization",
             ["x", "s", "g"], inits={"x": g, "s": skip, "g": gamma},
             domain=ms),
        case("skiplayernorm-mean-consumed", "spatial",
             "SkipLayerNormalization", ["x", "s", "g"], {"x": g, "s": skip},
             {"g": gamma}, outs=2, domain=ms, refused="run"),
        case("skipsimplifiedlayernorm", "spatial",
             "SkipSimplifiedLayerNormalization", ["x", "s", "g", "bias"],
             {"x": g, "s": skip}, {"g": gamma, "bias": gb}, domain=ms,
             bf16=True),
        case("skipsimplifiedlayernorm-no-bias", "spatial",
             "SkipSimplifiedLayerNormalization", ["x", "s", "g"],
             {"x": g, "s": skip}, {"g": gamma}, outs=["y0", "", "", "y3"],
             domain=ms),
    ]
    return out


# -- 8. control flow -------------------------------------------------------------

def _vi(name, shape, et=1):
    return E.value_info(name, shape, elem_type=et)


def _body(nodes, inputs, outputs, inits=()):
    return E.graph(nodes, inputs=inputs, outputs=outputs,
                   initializers=[tensor(n, a) for n, a in inits])


def _loop_body(nodes, carried, scans=(), inits=()):
    """A Loop body over (iteration ``it``, condition ``cond_in``, carried
    names): outputs the condition ``cond_out``, the carried ``<name>_out``
    and the scan outputs."""
    return _body(
        nodes,
        [_vi("it", [], 7), _vi("cond_in", [], 9)]
        + [_vi(c, ["n"]) for c in carried],
        [_vi("cond_out", [], 9)] + [_vi(f"{c}_out", ["n"]) for c in carried]
        + [_vi(s_, ["n"]) for s_ in scans], inits)


def _if_case(cid, cond, then_nodes, else_nodes, feeds=None, inits=None,
             then_inits=(), family="exact"):
    then_g = _body(then_nodes, [], [_vi("t", ["n"])], then_inits)
    else_g = _body(else_nodes, [], [_vi("e", ["n"])])
    return case(cid, family, "If", [cond], feeds, inits,
                attrs=[E.attr_graph("then_branch", then_g),
                       E.attr_graph("else_branch", else_g)])


def control_cases() -> list[Case]:
    """If, Loop and Scan (``lowering.py:2373-2540``): static conditions
    and trip counts, bodies unrolled, outer-scope closure and shadowing,
    the lift of large body initializers; data-dependent control flow and
    the unroll cap are refused. Bodies of elementwise ops are held
    exactly; the branch with a matrix product within ``spatial``."""
    x = _normal(801, (2, 3))
    big = _normal(802, (128, 256), 0.1)  # 128 KiB: lifted into the params
    true, false = np.array(True), np.array(False)
    ident = [E.node("Identity", ["cond_in"], ["cond_out"])]
    out = [
        _if_case("if-then", "c", [E.node("Mul", ["x", "two"], ["t"])],
                 [E.node("Neg", ["x"], ["e"])], {"x": x},
                 {"c": true, "two": np.full(3, 2.0, np.float32)}),
        _if_case("if-else", "c", [E.node("Mul", ["x", "x"], ["t"])],
                 [E.node("Neg", ["x"], ["e"])], {"x": x}, {"c": false}),
        _if_case("if-shadowing", "c", [E.node("Mul", ["x", "k"], ["t"])],
                 [E.node("Identity", ["x"], ["e"])], {"x": x},
                 {"c": true, "k": np.full(3, 2.0, np.float32)},
                 then_inits=[("k", np.full(3, 10.0, np.float32))]),
        _if_case("if-lifted-branch-weight", "c",
                 [E.node("MatMul", ["x", "w_big"], ["t"])],
                 [E.node("Slice", ["x", "z", "o"], ["e"])],
                 {"x": _normal(803, (2, 128))},
                 {"c": true, "z": _i64([0]), "o": _i64([1])},
                 then_inits=[("w_big", big)], family="spatial"),
    ]
    # A data-dependent condition: a Greater over the graph input.
    then_g = _body([E.node("Identity", ["x"], ["t"])], [], [_vi("t", ["n"])])
    else_g = _body([E.node("Neg", ["x"], ["e"])], [], [_vi("e", ["n"])])
    mb = E.model(
        [E.node("ReduceMax", ["x"], ["mx"], attrs=[A("keepdims", 0)]),
         E.node("Greater", ["mx", "zero"], ["c"]),
         E.node("If", ["c"], ["y0"], name="if_0",
                attrs=[E.attr_graph("then_branch", then_g),
                       E.attr_graph("else_branch", else_g)])],
        inputs=[_vi("x", list(x.shape))], outputs=[_vi("y0", ["n"])],
        initializers=[tensor("zero", np.float32(0))], opset=17)
    out.append(Case("if-data-dependent", "exact", mb, (x,), refused="run"))
    out.append(case("if-without-branches", "exact", "If", ["c"], {"x": x},
                    {"c": true}, refused="preflight"))

    acc_body = _loop_body(
        ident + [E.node("Add", ["v", "x"], ["v_out"]),
                 E.node("Identity", ["v_out"], ["trace"])], ["v"], ["trace"])
    table = _normal(804, (6, 3))
    slice_body = _loop_body(
        ident + [E.node("Gather", ["table", "it"], ["row"]),
                 E.node("Add", ["it", "one"], ["it1"]),
                 E.node("Slice", ["table", "it", "it1"], ["rows"]),
                 E.node("Mul", ["v", "row"], ["v_out"]),
                 E.node("Add", ["rows", "v_out"], ["trace"])],
        ["v"], ["trace"])
    while_body = _loop_body(
        [E.node("Add", ["v", "x"], ["v_out"]),
         E.node("Add", ["it", "one"], ["it1"]),
         E.node("Less", ["it1", "three"], ["cond_out"])], ["v"])
    host_body = _loop_body(
        ident + [E.node("Mul", ["v", "two"], ["v_out"]),
                 E.node("Cast", ["it"], ["trace"], attrs=[A("to", 1)])],
        ["v"], ["trace"])
    consts = {"table": table, "one": _i64(1), "three": _i64(3),
              "two": np.float32(2)}
    out += [
        case("loop-scan-output", "exact", "Loop", ["m", "", "v0"],
             {"x": np.array([1.0, 2.0], np.float32)},
             {"m": _i64(3), "v0": np.array([0.0, 10.0], np.float32)},
             attrs=[E.attr_graph("body", acc_body)], outs=2),
        case("loop-body-slices-by-iteration", "exact", "Loop",
             ["m", "", "v0"], {"v0": x[0]}, {"m": _i64(4), **consts},
             attrs=[E.attr_graph("body", slice_body)], outs=2),
        case("loop-while-condition", "exact", "Loop", ["", "c", "v0"],
             {"x": x[0]}, {"c": true, "v0": np.zeros(3, np.float32),
                           **consts},
             attrs=[E.attr_graph("body", while_body)]),
        case("loop-trip-and-condition", "exact", "Loop", ["m", "c", "v0"],
             {"x": x[0]}, {"m": _i64(7), "c": true,
                           "v0": np.zeros(3, np.float32), **consts},
             attrs=[E.attr_graph("body", while_body)]),
        case("loop-false-condition", "exact", "Loop", ["m", "c", "v0"],
             {"x": x[0]}, {"m": _i64(5), "c": false, "v0": x[1], **consts},
             attrs=[E.attr_graph("body", while_body)]),
        case("loop-host", "exact", "Loop", ["m", "", "v0"],
             inits={"m": _i64(3), "v0": np.ones(2, np.float32), **consts},
             attrs=[E.attr_graph("body", host_body)], outs=2),
        case("loop-data-dependent-trip-count", "exact", "Loop",
             ["m", "", "v0"], {"m": _i64(2), "x": x[0]},
             {"v0": np.zeros(3, np.float32)},
             attrs=[E.attr_graph("body", acc_body)], outs=2, refused="run"),
        case("loop-data-dependent-condition", "exact", "Loop",
             ["", "c", "v0"], {"c": true, "x": x[0]},
             {"v0": np.zeros(3, np.float32), **consts},
             attrs=[E.attr_graph("body", while_body)], refused="run"),
        case("loop-unroll-cap", "exact", "Loop", ["m", "", "v0"], {"x": x[0]},
             {"m": _i64(4097), "v0": np.zeros(3, np.float32)},
             attrs=[E.attr_graph("body", acc_body)], outs=2, refused="run"),
        case("loop-zero-trips-with-scan", "exact", "Loop", ["m", "", "v0"],
             {"x": x[0]}, {"m": _i64(0), "v0": np.zeros(3, np.float32)},
             attrs=[E.attr_graph("body", acc_body)], outs=2, refused="run"),
        case("loop-without-body", "exact", "Loop", ["m", "", "v0"],
             {"v0": x[0]}, {"m": _i64(2)}, refused="preflight"),
        case("loop-without-trip-or-condition", "exact", "Loop",
             ["", "", "v0"], {"x": x[0]}, {"v0": np.zeros(3, np.float32)},
             attrs=[E.attr_graph("body", acc_body)], refused="preflight"),
    ]
    # The loop-carried condition computed on the device.
    dep_body = _loop_body(
        [E.node("Add", ["v", "x"], ["v_out"]),
         E.node("ReduceSum", ["v_out"], ["s"], attrs=[A("keepdims", 0)]),
         E.node("Less", ["s", "lim"], ["cond_out"])], ["v"])
    out.append(case("loop-data-dependent-carried-condition", "exact", "Loop",
                    ["m", "", "v0"], {"x": x[0]},
                    {"m": _i64(3), "v0": np.zeros(3, np.float32),
                     "lim": np.float32(100)},
                    attrs=[E.attr_graph("body", dep_body)], refused="run"))
    # A while-style loop whose condition never turns false.
    forever = _loop_body(ident + [E.node("Identity", ["v"], ["v_out"])],
                         ["v"])
    out.append(case("loop-while-unroll-cap", "exact", "Loop",
                    ["", "c", "v0"], {"v0": x[0]}, {"c": true},
                    attrs=[E.attr_graph("body", forever)], refused="run"))

    cum = _body([E.node("Add", ["s", "xt"], ["s_out"]),
                 E.node("Identity", ["s_out"], ["y_t"])],
                [_vi("s", ["n"]), _vi("xt", ["n"])],
                [_vi("s_out", ["n"]), _vi("y_t", ["n"])])
    rev = _body([E.node("Identity", ["s"], ["s_out"]),
                 E.node("Identity", ["xt"], ["y_t"])],
                [_vi("s", ["n"]), _vi("xt", ["n"])],
                [_vi("s_out", ["n"]), _vi("y_t", ["n"])])
    two_in = _body([E.node("Mul", ["at", "bt"], ["p"]),
                    E.node("Add", ["s", "p"], ["s_out"]),
                    E.node("Identity", ["p"], ["y_t"])],
                   [_vi("s", ["n"]), _vi("at", ["n"]), _vi("bt", ["n"])],
                   [_vi("s_out", ["n"]), _vi("y_t", ["n"])])
    xs = _normal(805, (4, 3))
    scan = [E.attr_int("num_scan_inputs", 1)]
    out += [
        case("scan-cumulative-sum", "exact", "Scan", ["s0", "xs"],
             {"xs": xs}, {"s0": np.zeros(3, np.float32)},
             attrs=[E.attr_graph("body", cum)] + scan, outs=2, opset=11),
        case("scan-reverse", "exact", "Scan", ["s0", "xs"],
             {"xs": xs}, {"s0": np.zeros(3, np.float32)},
             attrs=[E.attr_graph("body", rev)] + scan
             + [I("scan_input_directions", [1])], outs=2, opset=11),
        case("scan-axes-and-output-direction", "exact", "Scan",
             ["s0", "a", "b"], {"a": xs.T.copy(), "s0": np.zeros(3,
                                                                np.float32)},
             {"b": _normal(806, (4, 3))},
             attrs=[E.attr_graph("body", two_in),
                    E.attr_int("num_scan_inputs", 2),
                    I("scan_input_axes", [1, 0]),
                    I("scan_output_axes", [1]),
                    I("scan_output_directions", [1])], outs=2, opset=11),
        case("scan-host", "exact", "Scan", ["s0", "xs"],
             inits={"xs": xs, "s0": np.zeros(3, np.float32)},
             attrs=[E.attr_graph("body", cum)] + scan, outs=2, opset=11),
        case("scan-opset8", "exact", "Scan", ["", "s0"],
             {"s0": np.zeros((1, 3), np.float32)},
             attrs=[E.attr_graph("body", rev)] + scan, opset=8,
             refused="preflight"),
        case("scan-without-attributes", "exact", "Scan", ["s0", "xs"],
             {"xs": xs}, {"s0": np.zeros(3, np.float32)}, opset=11,
             refused="preflight"),
        case("scan-unroll-cap", "exact", "Scan", ["s0", "xs"],
             {"xs": np.zeros((4097, 1), np.float32)},
             {"s0": np.zeros(1, np.float32)},
             attrs=[E.attr_graph("body", cum)] + scan, outs=2, opset=11,
             refused="run"),
        case("scan-too-few-inputs", "exact", "Scan", ["xs"], {"xs": xs},
             attrs=[E.attr_graph("body", cum),
                    E.attr_int("num_scan_inputs", 2)], opset=11,
             refused="run"),
    ]
    return out


# -- 9. recurrent layers and the Lp normalizations --------------------------------

def recurrent_cases() -> list[Case]:
    """RNN, GRU and LSTM (``lowering.py:2551-2720``, unrolled step by
    step) and the normalization extras (``:2723-2762``), within
    ``spatial``; layout=1, clip, other activations and the other refused
    inputs are typed refusals."""
    seq, batch, inp, hid = 5, 2, 4, 3
    x = _normal(901, (seq, batch, inp))
    out = []
    for op, gates in (("RNN", 1), ("GRU", 3), ("LSTM", 4)):
        lo = op.lower()
        for d, dirs in (("forward", 1), ("reverse", 1),
                        ("bidirectional", 2)):
            w = _normal(902, (dirs, gates * hid, inp), 0.5)
            r = _normal(903, (dirs, gates * hid, hid), 0.5)
            b = _normal(904, (dirs, 2 * gates * hid), 0.3)
            h0 = _normal(905, (dirs, batch, hid), 0.5)
            ins = ["x", "w", "r", "b", "", "h0"]
            inits = {"w": w, "r": r, "b": b, "h0": h0}
            if op == "LSTM":
                ins.append("c0")
                inits["c0"] = _normal(906, (dirs, batch, hid), 0.5)
            attrs = [S("direction", d), A("hidden_size", hid)]
            outs = 3 if op == "LSTM" else 2
            out.append(case(f"{lo}-{d}", "spatial", op, ins, {"x": x}, inits,
                            attrs=attrs, outs=outs, bf16=d == "forward"))
            out.append(case(f"{lo}-{d}-no-bias-no-state", "spatial", op,
                            ["x", "w", "r"], {"x": x}, {"w": w, "r": r},
                            attrs=[S("direction", d)], outs=outs))
        out.append(case(f"{lo}-host", "spatial", op, ["x", "w", "r"],
                        inits={"x": x,
                               "w": _normal(907, (1, gates * hid, inp)),
                               "r": _normal(908, (1, gates * hid, hid))},
                        outs=2))
        w1 = _normal(909, (1, gates * hid, inp))
        r1 = _normal(910, (1, gates * hid, hid))
        base = {"w": w1, "r": r1}
        for name, attrs in (
                ("layout1", [A("layout", 1)]),
                ("clip", [F("clip", 3.0)]),
                ("direction", [S("direction", "sideways")])):
            out.append(case(f"{lo}-{name}", "spatial", op, ["x", "w", "r"],
                            {"x": x}, base, attrs=attrs, outs=2,
                            refused="run"))
        out.append(case(f"{lo}-sequence-lens", "spatial", op,
                        ["x", "w", "r", "", "sl"], {"x": x},
                        {**base, "sl": np.full(batch, seq, np.int32)},
                        outs=2, refused="run"))
    acts = {"RNN": ["Tanh"], "GRU": ["Sigmoid", "Tanh"],
            "LSTM": ["Sigmoid", "Tanh", "Tanh"]}
    for op, names in acts.items():
        lo, gates = op.lower(), {"RNN": 1, "GRU": 3, "LSTM": 4}[op]
        w2 = _normal(911, (2, gates * hid, inp))
        r2 = _normal(912, (2, gates * hid, hid))
        out.append(case(f"{lo}-explicit-default-activations", "spatial", op,
                        ["x", "w", "r"], {"x": x}, {"w": w2, "r": r2},
                        attrs=[S("direction", "bidirectional"),
                               _strs("activations", names + names)], outs=2))
        out.append(case(f"{lo}-other-activations", "spatial", op,
                        ["x", "w", "r"], {"x": x},
                        {"w": w2[:1], "r": r2[:1]},
                        attrs=[_strs("activations",
                                     ["Relu"] + names[1:])], outs=2,
                        refused="run"))
    out.append(case("gru-linear-before-reset", "spatial", "GRU",
                    ["x", "w", "r", "b"], {"x": x},
                    {"w": _normal(913, (1, 3 * hid, inp)),
                     "r": _normal(914, (1, 3 * hid, hid)),
                     "b": _normal(915, (1, 6 * hid))},
                    attrs=[A("linear_before_reset", 1)], outs=2, bf16=True))
    w4, r4 = _normal(916, (1, 4 * hid, inp)), _normal(917, (1, 4 * hid, hid))
    out += [
        case("lstm-peepholes", "spatial", "LSTM",
             ["x", "w", "r", "", "", "", "", "p"], {"x": x},
             {"w": w4, "r": r4, "p": np.zeros((1, 3 * hid), np.float32)},
             outs=2, refused="run"),
        case("lstm-input-forget", "spatial", "LSTM", ["x", "w", "r"],
             {"x": x}, {"w": w4, "r": r4}, attrs=[A("input_forget", 1)],
             outs=2, refused="run"),
    ]
    x4 = _normal(918, (2, 3, 4, 5))
    out += [
        case("meanvariancenormalization", "spatial",
             "MeanVarianceNormalization", ["x"], {"x": x4}, bf16=True),
        case("meanvariancenormalization-axes", "spatial",
             "MeanVarianceNormalization", ["x"], {"x": x4},
             attrs=[I("axes", [1, -1])]),
        case("meanvariancenormalization-host", "spatial",
             "MeanVarianceNormalization", ["c"], inits={"c": x4}),
        case("lpnormalization-l2", "spatial", "LpNormalization", ["x"],
             {"x": x4}, bf16=True),
        case("lpnormalization-l1-axis1", "spatial", "LpNormalization", ["x"],
             {"x": x4}, attrs=[A("p", 1), A("axis", 1)]),
        case("lpnormalization-host", "spatial", "LpNormalization", ["c"],
             inits={"c": x4}),
        case("lpnormalization-p3", "spatial", "LpNormalization", ["x"],
             {"x": x4}, attrs=[A("p", 3)], refused="run"),
        case("globallppool-l2", "spatial", "GlobalLpPool", ["x"], {"x": x4},
             bf16=True),
        case("globallppool-l1", "spatial", "GlobalLpPool", ["x"], {"x": x4},
             attrs=[A("p", 1)]),
        case("globallppool-host", "spatial", "GlobalLpPool", ["c"],
             inits={"c": x4}),
        case("globallppool-p3", "spatial", "GlobalLpPool", ["x"], {"x": x4},
             attrs=[A("p", 3)], refused="run"),
        case("lppool-l2", "spatial", "LpPool", ["x"], {"x": x4},
             attrs=[I("kernel_shape", [2, 2])], opset=18, bf16=True),
        case("lppool-l1-strides-pads", "spatial", "LpPool", ["x"],
             {"x": x4}, attrs=[A("p", 1), I("kernel_shape", [3, 2]),
                               I("strides", [2, 2]),
                               I("pads", [1, 0, 1, 1])], opset=18),
        case("lppool-p3", "spatial", "LpPool", ["x"], {"x": x4},
             attrs=[A("p", 3), I("kernel_shape", [2, 2])], opset=18,
             refused="run"),
    ]
    return out


def _strs(name: str, values) -> bytes:
    """A STRINGS attribute (the port's encoder has none)."""
    body = E._str(1, name)
    for v in values:
        b = v.encode()
        body += E._field(9, 2, E._varint(len(b)) + b)
    return body + E._int(20, 8)


def late_cases() -> list[Case]:
    """The families of the last 39 handlers."""
    return (index_cases() + transformer_cases() + control_cases()
            + recurrent_cases())


def run_port(model: bytes, feeds, bf16: bool = False, device="cpu",
             evaluator_cls=None):
    """``model`` through the port's evaluator (``evaluator_cls``, the stock
    one by default) on ``device``, bf16 compute when ``bf16``: the outputs
    (a tuple) and the evaluator."""
    import torch

    from birda_tpu_torch.onnx import lowering as tl
    from birda_tpu_torch.onnx.proto import load_model

    m = load_model(model)
    ev = (evaluator_cls or tl._Evaluator)(
        m.graph, compute_dtype=torch.bfloat16 if bf16 else None,
        opset=m.opset)
    fn = tl.OnnxFunction(m, evaluator=ev)
    params = {k: torch.from_numpy(np.array(v)).to(device)
              for k, v in fn.params.items()}
    out = fn(*(torch.from_numpy(np.array(f)).to(device) for f in feeds),
             params=params)
    return (out if isinstance(out, tuple) else (out,)), ev
