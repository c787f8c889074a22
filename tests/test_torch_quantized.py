"""The ported quantized ops (QDQ QuantizeLinear/DequantizeLinear and the
QOperator QLinear*/Integer family) against the JAX evaluator on the CPU,
and against the numpy oracles of ``tests/test_quantized.py``.

- Each quantized case of ``tests/torch_op_cases.py`` through both
  evaluators: integer outputs bit for bit; the QLinear ops that requantize
  a float intermediate at most one step off on a counted share; and a
  second call of each makes no host value for the device.
- The integer products (QLinearConv, QLinearMatMul, MatMulInteger,
  ConvInteger) bit for bit against float64 oracles, with uint8 zero points,
  int8 -128, per-channel weight scales and padding; the wide-integer routes
  bit for bit at the extremes of their operand range.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import torch_op_cases as oc
from test_quantized import q_ref
from torch_jax_parity import (assert_case_matches_jax,
                              assert_second_call_copies_no_host_value,
                              run_port, second_call_params)

from birda_tpu_torch.onnx import lowering as tl

CASES = oc.quantized_cases()
BF16 = [c for c in CASES if c.bf16]
BY_ID = {c.id: c for c in CASES}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("c", CASES, ids=[c.id for c in CASES])
def test_matches_jax(c):
    assert_case_matches_jax(c)


@pytest.mark.parametrize("c", BF16, ids=[c.id for c in BF16])
def test_bf16_matches_jax(c):
    assert_case_matches_jax(c, bf16=True)


@pytest.mark.parametrize("c,bf16", second_call_params(CASES))
def test_second_call_copies_no_host_value(c, bf16):
    assert_second_call_copies_no_host_value(c, bf16)


# -- numpy oracles ------------------------------------------------------------

def _port(cid):
    c = BY_ID[cid]
    outs, _ = run_port(c.model, c.feeds)
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in outs], c


def _inits(c):
    from birda_tpu_torch.onnx.proto import load_model

    return {n: t.array for n, t in load_model(c.model).graph.initializers
            .items()}


def test_quantize_rounds_half_to_even_and_saturates():
    (got,), c = _port("quantize-uint8-ties-zero-point")
    init = _inits(c)
    want = q_ref(c.feeds[0], init["s"], int(init["z"]), np.uint8)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    (got,), c = _port("quantize-int8-saturate")
    init = _inits(c)
    want = q_ref(c.feeds[0], init["s"], int(init["z"]), np.int8)
    assert np.array_equal(got, want)
    assert got.min() == -128 and got.max() == 127


def test_quantize_per_axis_matches_oracle():
    (got,), c = _port("quantize-per-axis-1")
    init = _inits(c)
    want = q_ref(c.feeds[0], init["s"].reshape(1, 3, 1),
                 init["z"].astype(np.float64).reshape(1, 3, 1), np.int8)
    assert np.array_equal(got, want)


def _conv_oracle(x, xz, w, wz, strides, pads, group=1):
    """The integer conv of the zero-point shifted values in float64
    (exact), padding 0 in the shifted domain."""
    xi = x.astype(np.float64) - np.float64(xz)
    wz = np.asarray(wz, np.float64)
    wi = w.astype(np.float64) - (wz.reshape(-1, 1, 1, 1) if wz.size > 1
                                 else wz)
    xi = np.pad(xi, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    return TF.conv2d(torch.from_numpy(xi), torch.from_numpy(wi),
                     stride=strides, groups=group).numpy()


@pytest.mark.parametrize("cid,strides,pads,group", [
    ("qlinearconv-uint8-pad-bias", (1, 1), (1, 1, 1, 1), 1),
    ("qlinearconv-per-channel-stride", (2, 2), (0, 1, 2, 1), 1),
    ("qlinearconv-depthwise", (1, 1), (1, 1, 1, 1), 4),
    ("qlinearconv-int8-x", (1, 1), (0, 0, 0, 0), 1),
])
def test_qlinear_conv_matches_oracle(cid, strides, pads, group):
    """ORT's QLinearConv: exact int32 accumulation (float64 here), the
    int32 bias, then the float32 requantize with round-half-even."""
    (got,), c = _port(cid)
    p = _inits(c)
    acc = _conv_oracle(c.feeds[0], p["xz"], p["w"], p["wz"], strides, pads,
                       group)
    if "b" in p:
        acc = acc + p["b"].astype(np.float64).reshape(1, -1, 1, 1)
    ws = p["ws"].reshape(1, -1, 1, 1) if p["ws"].size > 1 else p["ws"]
    scale = np.float32(p["xs"]) * ws.astype(np.float32) / np.float32(p["ys"])
    info = np.iinfo(p["yz"].dtype)
    want = np.clip(np.round(acc.astype(np.float32) * scale) + p["yz"],
                   info.min, info.max).astype(p["yz"].dtype)
    assert got.dtype == p["yz"].dtype
    assert np.array_equal(got, want)


def test_conv_integer_matches_oracle():
    (got,), c = _port("convinteger-both-zero-points")
    p = _inits(c)
    want = _conv_oracle(c.feeds[0], p["xz"], p["w"], p["wz"], (1, 2),
                        (0, 0, 0, 0))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    (got,), c = _port("convinteger-x-zero-point")
    p = _inits(c)
    want = _conv_oracle(c.feeds[0], p["xz"], p["w"], 0, (1, 1),
                        (1, 1, 1, 1))
    assert np.array_equal(got, want)


def test_qlinear_matmul_matches_oracle():
    (got,), c = _port("qlinearmatmul-uint8")
    p = _inits(c)
    af = (c.feeds[0].astype(np.float64) - p["az"]) * p["as"]
    bf = (p["b"].astype(np.float64) - p["bz"]) * p["bs"]
    want = q_ref(af @ bf, p["ys"], int(p["yz"]), np.uint8)
    assert np.array_equal(got, want)


def test_matmul_integer_matches_oracle():
    (got,), c = _port("matmulinteger-both-zero-points")
    p = _inits(c)
    want = (c.feeds[0].astype(np.int64) - int(p["az"])) @ (
        p["b"].astype(np.int64) - p["bz"].astype(np.int64))
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_dynamic_quantize_matches_oracle():
    (y, ys, yz), c = _port("dynamicquantizelinear")
    x = c.feeds[0]
    lo, hi = min(x.min(), 0.0), max(x.max(), 0.0)
    scale = np.float32((hi - lo) / 255.0)
    zp = int(np.clip(np.round(0 - lo / scale), 0, 255))
    assert float(ys) == scale and int(yz) == zp
    assert np.array_equal(y, q_ref(x, scale, zp, np.uint8))


def test_qlinear_softmax_within_one_step_of_oracle():
    (got,), c = _port("qlinearsoftmax")
    xf = c.feeds[0].astype(np.float32) * 0.05
    e = np.exp(xf - xf.max(1, keepdims=True))
    want = np.clip(np.round(e / e.sum(1, keepdims=True) * 255), 0, 255)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


# -- the wide-integer routes ---------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_wide_integer_routes_are_exact(kind):
    """float64 conv and matmul of shifted 8-bit operands (|v| up to 255)
    against int64 sums, at a depth of 2,304 (3x3 x 256 channels)."""
    rng = np.random.default_rng(7)
    if kind == "random":
        x = rng.integers(-255, 256, (2, 256, 6, 5))
        w = rng.integers(-255, 256, (3, 256, 3, 3))
    else:
        x = np.full((2, 256, 6, 5), 255)
        w = np.full((3, 256, 3, 3), -255)
    xt, wt = (torch.from_numpy(v.astype(np.int32)) for v in (x, w))
    got = tl.wide_int_conv(xt, wt, (1, 1), ((1, 1), (0, 2)), (1, 1), 1)
    want = _conv_oracle(x, 0, w, 0, (1, 1), (1, 0, 1, 2))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    if kind == "random":
        a, b = rng.integers(-255, 256, (40, 2304)), \
            rng.integers(-255, 256, (2304, 7))
    else:
        a, b = np.full((40, 2304), -255), np.full((2304, 7), 255)
    got = tl.wide_int_matmul(torch.from_numpy(a.astype(np.int32)),
                             torch.from_numpy(b.astype(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b)


def test_qlinear_conv_second_run_copies_nothing_again():
    """The shifted int32 weight and the combined requantize scale, host
    arithmetic on constants inside QLinearConv, are made once and kept: a
    second run makes no new device copy (each would be a host sync per
    step on the card)."""
    c = BY_ID["qlinearconv-per-channel-stride"]
    fn = tl.lower(c.model)
    x = torch.from_numpy(c.feeds[0])
    first = fn(x)
    copies, memos = dict(fn._eval._device_copies), dict(fn._eval._memos)
    assert len(memos) == 2
    assert torch.equal(fn(x), first)
    assert fn._eval._device_copies.keys() == copies.keys()
    assert all(fn._eval._memos[k][1] is v[1] for k, v in memos.items())
