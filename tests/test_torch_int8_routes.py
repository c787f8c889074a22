"""The exact integer routes of the PyTorch port's int8 path
(birda_tpu_torch/onnx/lowering.py: int_conv, int_matmul and their routes).

Every route must give the exact int32 sums, bit for bit, of a float64 numpy
reference (float64 holds every partial sum of these int8 products exactly):
random int8 operands, random-sign ±127 operands, and the extreme +127 x -127
operands whose partial sums are the largest. On the CPU each route runs
here: ``torch._int_mm`` has a CPU form, so the card routes' layout work
(padding to its shape limits, im2col, the channel moves) is exercised as
well. The route chosen on the card is a function of static shapes alone.

The card-only case runs every conv and matmul case through the routes the
card chooses, against the same CPU reference (``BIRDA_TEST_TPU=1 python -m
pytest tests/test_torch_int8_routes.py -k card``). This file imports no jax,
so that command runs on a machine without it.
"""

import numpy as np
import pytest
import torch

from birda_tpu_torch.onnx import lowering as tl

KINDS = ["random", "pm127", "extreme"]


def _operands(x_shape, w_shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.integers(-127, 128, x_shape)
        w = rng.integers(-127, 128, w_shape)
    elif kind == "pm127":
        x = 127 * rng.choice([-1, 1], x_shape)
        w = 127 * rng.choice([-1, 1], w_shape)
    else:
        x, w = np.full(x_shape, 127), np.full(w_shape, -127)
    return x.astype(np.int8), w.astype(np.int8)


def _ref_conv(x, w, strides, pads, dil, group) -> np.ndarray:
    """2-D grouped convolution in float64, one kernel tap at a time."""
    x = np.pad(x.astype(np.float64), [(0, 0), (0, 0), *pads])
    n, _, h, wd = x.shape
    o, cg, kh, kw = w.shape
    oh = (h - (kh - 1) * dil[0] - 1) // strides[0] + 1
    ow = (wd - (kw - 1) * dil[1] - 1) // strides[1] + 1
    og = o // group
    out = np.zeros((n, o, oh, ow))
    for g in range(group):
        xs = x[:, g * cg:(g + 1) * cg]
        for i in range(kh):
            for j in range(kw):
                r0, c0 = i * dil[0], j * dil[1]
                patch = xs[:, :, r0:r0 + (oh - 1) * strides[0] + 1:strides[0],
                           c0:c0 + (ow - 1) * strides[1] + 1:strides[1]]
                out[:, g * og:(g + 1) * og] += np.einsum(
                    "nchw,oc->nohw", patch,
                    w[g * og:(g + 1) * og, :, i, j].astype(np.float64))
    return out.astype(np.int32)


# name: (x shape, w shape, strides, pads, dilations, group)
CONV_CASES = {
    "dense_3x3": ((2, 4, 8, 8), (8, 4, 3, 3), (1, 1), ((0, 0), (0, 0)),
                  (1, 1), 1),
    "dense_6x6_lifted": ((2, 32, 16, 16), (64, 32, 6, 6), (1, 1),
                         ((0, 0), (0, 0)), (1, 1), 1),
    "pointwise": ((2, 24, 5, 7), (10, 24, 1, 1), (1, 1), ((0, 0), (0, 0)),
                  (1, 1), 1),
    "pointwise_squeeze_b1": ((1, 13, 1, 1), (4, 13, 1, 1), (1, 1),
                             ((0, 0), (0, 0)), (1, 1), 1),
    "dense_stride2_pad": ((2, 5, 9, 11), (7, 5, 3, 3), (2, 2),
                          ((1, 1), (1, 1)), (1, 1), 1),
    "dense_asymmetric_pad": ((2, 3, 8, 8), (4, 3, 3, 3), (1, 1),
                             ((0, 1), (1, 0)), (1, 1), 1),
    "pointwise_stride2": ((2, 6, 7, 7), (5, 6, 1, 1), (2, 2),
                          ((0, 0), (0, 0)), (1, 1), 1),
    "dilated": ((2, 4, 12, 12), (6, 4, 3, 3), (1, 1), ((2, 2), (2, 2)),
                (2, 2), 1),
    "depthwise_3x3": ((2, 16, 9, 7), (16, 1, 3, 3), (1, 1),
                      ((1, 1), (1, 1)), (1, 1), 16),
    "depthwise_5x5_stride2": ((2, 24, 11, 9), (24, 1, 5, 5), (2, 2),
                              ((2, 2), (2, 2)), (1, 1), 24),
    "grouped": ((2, 8, 6, 6), (8, 2, 3, 3), (1, 1), ((1, 1), (1, 1)),
                (1, 1), 4),
    # depth 1040, the fp32 route's limit: partial sums up to 1040 * 127^2
    "depthwise_depth_1040": ((1, 2, 1, 1040), (2, 1, 1, 1040), (1, 1),
                             ((0, 0), (0, 0)), (1, 1), 2),
    # Deeper than 1040: fp32_split cuts the channels (depth 1089 = 33 x 33),
    # the kernel's rows (kernel 40 x 30, dilated rows), or both.
    "grouped_depth_1089": ((2, 132, 40, 1), (4, 33, 33, 1), (1, 1),
                           ((0, 0), (0, 0)), (1, 1), 4),
    "depthwise_kernel_rows": ((1, 2, 82, 32), (2, 1, 40, 30), (1, 1),
                              ((0, 0), (0, 0)), (2, 1), 2),
    "grouped_rows_and_channels": ((1, 4, 36, 35), (4, 2, 33, 33), (2, 1),
                                  ((1, 1), (0, 0)), (1, 1), 2),
}


def _routes(case) -> list[str]:
    _, w, strides, pads, _, group = case
    depth = int(np.prod(w[1:]))
    routes = ["float64"]
    if group == 1:
        routes.append("im2col")
        if w[2:] == (1, 1) and strides == (1, 1) and pads == ((0, 0), (0, 0)):
            routes.append("int_mm")
    else:
        routes.append("fp32_split")
    if depth <= tl.EXACT_FP32_DEPTH:
        routes.append("fp32")
    return routes


ROUTE_CASES = [pytest.param(name, route, kind, id=f"{name}-{route}-{kind}")
               for name, case in CONV_CASES.items()
               for route in _routes(case) for kind in KINDS]


@pytest.mark.parametrize("name,route,kind", ROUTE_CASES)
def test_conv_route_is_exact(name, route, kind):
    xs, ws, strides, pads, dil, group = CONV_CASES[name]
    x, w = _operands(xs, ws, kind)
    want = _ref_conv(x, w, strides, pads, dil, group)
    got = tl.int_conv(torch.from_numpy(x), torch.from_numpy(w), strides,
                      pads, dil, group, route=route)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


# (M, K, N): batch 1 and the tiny widths fall below _int_mm's card limits
# (M a multiple of 32, K and N multiples of 8) and are padded; 8 x 16 x 240,
# 17 x 16 x 240 and 40 x 16 x 240 are a v2.4 squeeze-excite product at batch
# 8, 17 and 40, and 8 x 24 x 384 a v3.0 one at batch 8, which cuBLASLt
# refused at 17 and 24 rows (ROADMAP C11).
MATMUL_CASES = [(1, 1280, 16), (4, 32, 16), (17, 13, 10), (33, 64, 4),
                (8, 16, 240), (17, 16, 240), (40, 16, 240), (8, 24, 384)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_matmul_routes_are_exact(m, k, n, kind):
    a, b = _operands((m, k), (k, n), kind, seed=m + k + n)
    want = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    plain = tl.int_matmul(at, bt)  # the CPU's float64 products
    padded = tl.int_mm_weight(bt)
    assert padded.shape[0] % 8 == 0 and padded.shape[1] % 8 == 0
    card_route = tl._int_mm(at, padded, n)  # the card's, here on the CPU
    for got in (plain, card_route):
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 23, 24, 25, 32, 33, 64])
def test_int_mm_rows_are_padded_to_what_cublaslt_takes(m, monkeypatch):
    """The card's ``torch._int_mm`` gets a multiple of 32 rows, and the
    product comes back at ``m`` rows (C11)."""
    seen = []
    int_mm = torch._int_mm

    def recording(a, b):
        seen.append(tuple(a.shape))
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", recording)
    a, b = _operands((m, 16), (16, 240), "random", seed=m)
    got = tl._int_mm(torch.from_numpy(a), tl.int_mm_weight(
        torch.from_numpy(b)), 240)
    rows = seen[0][0]
    assert rows % 32 == 0 and 0 <= rows - m < 32
    want = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,group,strides,pads,want", [
    pytest.param((8, 1, 3, 3), 8, (1, 1), ((1, 1), (1, 1)), "fp32",
                 id="depthwise"),
    pytest.param((8, 4, 1, 1), 1, (1, 1), ((0, 0), (0, 0)), "int_mm",
                 id="pointwise"),
    pytest.param((8, 4, 3, 3), 1, (1, 1), ((1, 1), (1, 1)), "im2col",
                 id="dense"),
    pytest.param((8, 4, 1, 1), 1, (2, 2), ((0, 0), (0, 0)), "im2col",
                 id="pointwise-strided"),
    pytest.param((8, 4, 1, 1), 1, (1, 1), ((1, 1), (1, 1)), "im2col",
                 id="pointwise-padded"),
    pytest.param((8, 33, 33, 1), 8, (1, 1), ((0, 0), (0, 0)), "fp32_split",
                 id="grouped-deeper-than-1040"),
])
def test_card_route_follows_static_shapes(shape, group, strides, pads, want):
    x_shape = (2, shape[1] * group, 6, 6)
    assert tl.int_conv_route(x_shape, shape, strides, pads, (1, 1), group,
                             "cuda") == want
    assert tl.int_conv_route(x_shape, shape, strides, pads, (1, 1), group,
                             "cpu") == "float64"


def test_grouped_conv_beyond_exact_fp32_depth_is_refused():
    """A single fp32 conv deeper than 1040 is refused, never rounded: the
    card's route for such a grouped conv is ``fp32_split``, which is exact
    where the unsplit fp32 conv is not (1089 · 127² > 2²⁴)."""
    x_shape, w_shape = (2, 132, 40, 1), (4, 33, 33, 1)  # depth 1089
    assert tl.int_conv_route(x_shape, w_shape, (1, 1), ((0, 0), (0, 0)),
                             (1, 1), 4, "cuda") == "fp32_split"
    x, w = (torch.from_numpy(v)
            for v in _operands(x_shape, w_shape, "extreme"))
    with pytest.raises(tl.UnsupportedOnnxOp, match="no exact route"):
        tl.int_conv(x, w, (1, 1), ((0, 0), (0, 0)), (1, 1), 4, route="fp32")
    got = tl.int_conv(x, w, (1, 1), ((0, 0), (0, 0)), (1, 1), 4,
                      route="fp32_split")
    assert int(got.min()) == -1089 * 127 * 127 < -(1 << 24)
    want = _ref_conv(x.numpy(), w.numpy(), (1, 1), ((0, 0), (0, 0)), (1, 1),
                     4)
    assert np.array_equal(got.numpy(), want)


def test_integer_routes_give_shapes_on_meta():
    meta = torch.device("meta")
    x = torch.empty((2, 5, 9, 11), dtype=torch.int8, device=meta)
    w = torch.empty((7, 5, 3, 3), dtype=torch.int8, device=meta)
    out = tl.int_conv(x, w, (2, 2), ((1, 1), (1, 1)), (1, 1), 1)
    assert out.device == meta and out.dtype == torch.int32
    assert tuple(out.shape) == (2, 7, 5, 6)
    a = torch.empty((3, 40), dtype=torch.int8, device=meta)
    b = torch.empty((40, 9), dtype=torch.int8, device=meta)
    mm = tl.int_matmul(a, b)
    assert mm.dtype == torch.int32 and tuple(mm.shape) == (3, 9)


@pytest.mark.parametrize("op", ["MatMul", "Gemm"])
def test_integer_matmul_and_gemm_nodes_are_exact(op):
    """The evaluator's MatMul and Gemm of int8 operands sum exactly and, as
    the JAX evaluator's preferred element type, return float32. Wider
    integer operands (zero-point shifted 8-bit values, up to 255 in
    magnitude) take the float64 route and are exact too."""
    import fixtures_onnx as fo

    a, b = _operands((5, 40), (40, 6), "extreme")
    mb = fo.model([fo.node(op, ["a", "b"], ["y"])],
                  inputs=[fo.value_info("a", ["n", 40])],
                  outputs=[fo.value_info("y", ["n", 6])])
    model = tl.load_model(mb)
    ev = tl._Evaluator(model.graph, compute_dtype=torch.bfloat16)
    node = model.graph.nodes[0]
    with ev._no_compute_cast():
        got = getattr(ev, f"op_{op}")(node, torch.from_numpy(a), b)
    assert got.dtype == torch.float32
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    wide_a = a.astype(np.int32) * 2 + 1  # |v| up to 255
    wide_b = b.astype(np.int32) * 2 - 1
    with ev._no_compute_cast():
        got = ev.op_MatMul(node, torch.from_numpy(wide_a), wide_b)
    want = wide_a.astype(np.float64) @ wide_b.astype(np.float64)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CONV_CASES) + ["matmuls"])
def test_card_routes_match_cpu_reference(name):
    """On a CUDA card: each case through the route the card picks, bit for
    bit against the CPU float64 product, for every operand kind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's cuBLASLt route and "
                    "the card's conv algorithms run only there")
    dev = torch.device("cuda")
    for kind in KINDS:
        if name == "matmuls":
            for m, k, n in MATMUL_CASES:
                a, b = _operands((m, k), (k, n), kind)
                want = tl.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
                got = tl.int_matmul(torch.from_numpy(a).to(dev),
                                    torch.from_numpy(b).to(dev))
                assert torch.equal(got.cpu(), want), (m, k, n, kind)
            continue
        xs, ws, strides, pads, dil, group = CONV_CASES[name]
        x, w = (torch.from_numpy(v) for v in _operands(xs, ws, kind))
        want = tl.int_conv(x, w, strides, pads, dil, group, route="float64")
        got = tl.int_conv(x.to(dev), w.to(dev), strides, pads, dil, group)
        assert torch.equal(got.cpu(), want), kind
