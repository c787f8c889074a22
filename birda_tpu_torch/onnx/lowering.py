"""ONNX graph -> PyTorch function: the port of ``birda_tpu/onnx/lowering.py``.

A parsed :class:`~birda_tpu_torch.onnx.proto.Model` runs node by node over an
environment of values, the same design as the JAX evaluator:

- Host constants stay numpy. A node whose inputs are all host values is
  folded on the host (numpy where the JAX evaluator uses numpy, a CPU
  tensor brought back to numpy where it uses jax.numpy), so shape, slice and
  reshape parameters stay plain integers. A node whose inputs are all
  constants folds once and keeps its value, as a jit trace folds it once.
  Every shape parameter (a Reshape's shape, a Pad's pads, a TopK's ``k``,
  Resize's scales and sizes, ...) must be a host value: a device tensor
  there is refused, never read (a read would be a device sync per step, and
  the JAX evaluator's trace refuses it too).
- Device values are ``torch.Tensor``s on the device the graph input lives
  on. Host operands of a device op are copied to that device once and
  cached.
- ``compute_dtype=torch.bfloat16`` casts matmul/conv operands to bf16,
  accumulates in fp32 and materializes their outputs at bf16 (the JAX
  ``_mm_cast``/``_mm_out`` recipe); ``None`` is the fp32 route, run with
  TF32 off for cuDNN convolutions and cuBLAS matmuls (the GPU form of the
  JAX route's HIGHEST matmul precision).
- Elementwise ops promote like ``jax.numpy``: a 0-d float32 constant
  promotes a bf16 tensor to float32 (``torch.promote_types`` on both
  dtypes), Python scalars stay weak. jax holds no 64-bit type on the device,
  so a device Cast to int64 or float64 gives int32 or float32.
- Integer products accumulate exactly in int32, the JAX route's
  ``preferred_element_type=int32``. int8 operands (the int8 path of
  :mod:`birda_tpu_torch.onnx.quantize`) take :func:`int_conv` and
  :func:`int_matmul`, which pick a route by static shape (``torch._int_mm``
  on the card, an fp32 product only where every partial sum is an exact
  integer, float64 products on the CPU). Wider integers (the zero-point
  shifted int32 operands of QLinearConv, QLinearMatMul, ConvInteger and
  MatMulInteger, up to 255 in magnitude) take float64 products on every
  device (:func:`wide_int_conv`, :func:`wide_int_matmul`). None rounds.

The op set is the JAX evaluator's, all 178 handlers: everything the
full-scale BirdNET v2.4 / v3.0 and Perch v2 graphs emit, their QDQ forms,
the common glue of other exports, the transformer family (opset-23
Attention and the com.microsoft fused ops), the static control flow
(If/Loop/Scan, run at call time with their bodies unrolled, as a jit trace
unrolls them) and the recurrent layers (unrolled step by step); plus the
fused spectrogram front-end ``BirdaFusedMelFrontend`` that
:func:`maybe_fuse_frontend` splices in for bf16 compute. In bf16 two
hand-written CUDA kernels carry the front-ends: the fused node runs
``ops/stft_conv.py::fused_logmel``, and a single-channel long-kernel Conv1d
the fusion pass did not take (the unfused Conv1d-STFT, Perch v2's framing
conv) runs ``ops/stft_conv.py::conv1d_stft``, each where its kernel holds
the node's geometry (``conv1d_kernel_fits``, ``logmel_kernel_fits``, from
static shapes on every device); any other geometry, and every front-end
node under ``BIRDA_STFT_KERNEL=gather``, runs the JAX evaluator's composed
route for that node, and ``stft_conv.ROUTES`` counts which route each node
took. A graph outside the op set fails at load with
the full list (``preflight_or_raise``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import stft_conv
# The preflight reads the lowering's Constant-folding rule by this name.
from .proto import _NP_DTYPES, Model, load_model
from .proto import constant_payload as _constant_payload

__all__ = ["OnnxFunction", "UnsupportedOnnxOp", "lower",
           "maybe_fuse_frontend"]

#: Float initializers at least this large are lifted out of the host
#: constants into :attr:`OnnxFunction.params`: each is carried to the card
#: once (cast to bf16 once on the bf16 route) and shared by every batch
#: shape. Smaller ones (shape vectors, scalars, BatchNormalization vectors)
#: stay host numpy, so shape arithmetic folds on the host. 64 KiB lifts every
#: conv and matmul weight of the shipped graphs and the same set of names as
#: the JAX lowering, so a params dict carries between the two packages.
LIFT_PARAM_BYTES = 1 << 16


class UnsupportedOnnxOp(NotImplementedError):
    pass


def _autopad_amounts(op_shape, kernel, strides, dilations, mode):
    """SAME_UPPER/SAME_LOWER pad amounts per spatial dim."""
    pads = []
    for dim, k, s, d in zip(op_shape, kernel, strides, dilations):
        eff_k = (k - 1) * d + 1
        out = -(-dim // s)
        total = max(0, (out - 1) * s + eff_k - dim)
        if mode == b"SAME_LOWER":
            pads.append((total - total // 2, total // 2))
        else:
            pads.append((total // 2, total - total // 2))
    return pads


def _is_host(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _host_array(x) -> np.ndarray:
    """A host value as the array jax would make of it (x64 off: float64
    becomes float32)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return np.require(a, requirements=["C", "W"])


def _dtype_kind(x) -> str:
    """numpy dtype kind (``f``, ``i``, ``u``, ``b``, ``c``) of a host value
    or a tensor, without reading it, as the JAX evaluator sees it: bfloat16
    is kind ``V`` there (ml_dtypes' bfloat16 is a numpy void type), so its
    kind tests for ``f`` pass float32 but not bf16 values — which decides,
    for one, which tensors the int8 path stores as int8."""
    if isinstance(x, torch.Tensor):
        dt = x.dtype
        if dt == torch.bfloat16:
            return "V"
        if dt.is_floating_point:
            return "f"
        if dt.is_complex:
            return "c"
        if dt == torch.bool:
            return "b"
        return "i" if dt.is_signed else "u"
    dt = getattr(x, "dtype", None)
    return dt.kind if dt is not None else np.asarray(x).dtype.kind


def _device_of(*xs) -> torch.device:
    """The device of the tensor operands (the card's where one is on it);
    the CPU when there is none, so a handler run on host values alone
    computes there."""
    found = None
    for x in xs:
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                return x.device
            found = x.device
    return found if found is not None else torch.device("cpu")


_NP_FROM_ONNX_DT = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}

#: The device dtype of each numpy dtype, as jax holds it with 64-bit types
#: off: int64, uint64 and float64 take 32 bits.
_DEVICE_DTYPE = {
    np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32, np.dtype(np.bool_): torch.bool,
    np.dtype(np.float16): torch.float16, np.dtype(np.float64): torch.float32,
    np.dtype(np.uint32): torch.uint32, np.dtype(np.uint64): torch.uint32,
}


#: The numpy dtype of each device dtype numpy holds (not bfloat16).
_NP_OF_TORCH = {
    torch.float32: np.float32, torch.float16: np.float16,
    torch.float64: np.float64, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.uint16: np.uint16, torch.int16: np.int16, torch.int32: np.int32,
    torch.int64: np.int64, torch.bool: np.bool_, torch.uint32: np.uint32,
    torch.uint64: np.uint64,
}

#: Unsigned dtypes for which PyTorch has no bitwise or shift kernels: their
#: bitwise ops run on int64 (which holds every value) and convert back.
_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)

#: Ops whose bodies read the enclosing graph's values: never folded as a
#: function of their own inputs.
_CONTROL_FLOW = frozenset({"If", "Loop", "Scan"})


def _as_host(v):
    """A handler's value for a node whose inputs were all host values: a
    tensor it computed on the CPU comes back as numpy (bf16, which numpy
    does not hold, stays a tensor)."""
    if isinstance(v, torch.Tensor) and v.dtype != torch.bfloat16:
        return v.numpy()
    return v


def _int_acc(dt: torch.dtype) -> torch.dtype:
    """The dtype of a jnp sum, product or cumsum of an integer or bool
    tensor: the default integer of its signedness, 32 bits with x64 off (as
    the JAX evaluator's index outputs are int32)."""
    return torch.int32 if dt == torch.bool or dt.is_signed else torch.uint32


def _true_div(a, b):
    """``a / b`` for a tensor and a Python scalar as IEEE division, which
    jnp's is: torch on the card multiplies by the scalar's reciprocal,
    one unit in the last place off."""
    if isinstance(b, torch.Tensor) or not isinstance(a, torch.Tensor):
        return a / b
    dt = a.dtype if a.is_floating_point() else torch.float32
    return a / torch.full((), b, dtype=dt, device=a.device)


def _all_host(*xs) -> bool:
    """Whether every present operand is a host value."""
    return all(_is_host(x) for x in xs if x is not None)


def _fill_value(dt: torch.dtype):
    """jnp.take's fill value for an index out of range."""
    if dt == torch.bool:
        return True
    if dt.is_floating_point or dt.is_complex:
        return float("nan")
    info = torch.iinfo(dt)
    return info.min if dt.is_signed else info.max


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)``: ``0.5 x erfc(-x / sqrt 2)``,
    its constant at the input's dtype (an integer input as float32)."""
    if not x.is_floating_point():
        x = x.float()
    c = float(torch.tensor(np.sqrt(0.5), dtype=torch.float64).to(x.dtype))
    return (0.5 * x * torch.erfc(-x * c)).to(x.dtype)


def _det(x: torch.Tensor) -> torch.Tensor:
    """Determinant of ``[..., n, n]`` by LU with partial pivoting, one
    elimination step after another in plain tensor ops: no library
    factorization, so nothing is read back to the host (a MAGMA route may
    be). A zero pivot gives 0."""
    a = x.clone() if x.is_floating_point() else x.float()
    n = a.shape[-1]
    batch = a.shape[:-2]
    det = torch.ones(batch, dtype=a.dtype, device=a.device)
    for k in range(n):
        p = a[..., k:, k].abs().argmax(-1) + k
        idx = p[..., None, None].expand(*batch, 1, n)
        row_p = a.gather(-2, idx)
        row_k = a[..., k:k + 1, :].clone()
        a.scatter_(-2, idx, row_k)
        a[..., k:k + 1, :] = row_p
        det = torch.where(p == k, det, -det)
        piv = a[..., k, k]
        det = det * piv
        if k + 1 < n:
            f = torch.where(piv[..., None] == 0, 0.0,
                            a[..., k + 1:, k] / piv[..., None])
            a[..., k + 1:, :] -= f[..., None] * a[..., k:k + 1, :]
    return det


class _TorchMath:
    """The jax.numpy functions the handlers call, on tensors and Python
    scalars (weak, as in jax.numpy): with it a handler reads as its JAX
    counterpart, ``m = _math(x)`` or ``m, xs = self._lib(*xs)`` in place of
    ``m = self._lib(*xs)``. An instance carries the device its
    constructors (``zeros``, ``arange``) make tensors on."""

    def __init__(self, device=None):
        self.device = device

    exp, log, log1p, sqrt, abs = (torch.exp, torch.log, torch.log1p,
                                  torch.sqrt, torch.abs)
    tanh, floor, ceil, negative = torch.tanh, torch.floor, torch.ceil, \
        torch.neg
    sin, cos, tan, sinh, cosh = (torch.sin, torch.cos, torch.tan, torch.sinh,
                                 torch.cosh)
    arcsin, arccos, arctan = torch.asin, torch.acos, torch.atan
    arcsinh, arccosh, arctanh = torch.asinh, torch.acosh, torch.atanh
    isnan, isinf, isposinf, isneginf = (torch.isnan, torch.isinf,
                                        torch.isposinf, torch.isneginf)
    logical_not, zeros_like, where = (torch.logical_not, torch.zeros_like,
                                      torch.where)
    round = staticmethod(torch.round)

    @staticmethod
    def maximum(a, b):
        return torch.maximum(a, b) if isinstance(b, torch.Tensor) \
            else torch.clamp_min(a, b)

    @staticmethod
    def minimum(a, b):
        return torch.minimum(a, b) if isinstance(b, torch.Tensor) \
            else torch.clamp_max(a, b)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def true_divide(a, b):
        return _true_div(a, b)

    @staticmethod
    def square(x):
        return x * x

    @staticmethod
    def sign(x):
        # torch.sign gives 0 for NaN; jnp.sign keeps the NaN.
        s = torch.sign(x)
        return torch.where(torch.isnan(x), x, s) if x.is_floating_point() \
            else s

    reshape, moveaxis, stack = torch.reshape, torch.movedim, torch.stack

    @staticmethod
    def mean(x, axis=None, keepdims=False):
        return _Evaluator._mean(x, _axes(axis), keepdims)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return _Evaluator._torch_reduce("sum", x, _axes(axis), keepdims)

    @staticmethod
    def repeat(x, n):
        # np.repeat without an axis repeats the flattened elements.
        return torch.repeat_interleave(x.reshape(-1), n)

    @staticmethod
    def matmul(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        return torch.matmul(a.to(dt), b.to(dt))

    @staticmethod
    def take_along_axis(x, idx, axis):
        """jnp.take_along_axis: ``idx`` broadcasts against ``x``, negative
        indices count from the end, one still out of range reads the fill
        value (NaN for floats), so no index is checked on the host."""
        n = x.shape[axis]
        idx = torch.where(idx < 0, idx + n, idx)
        out = torch.take_along_dim(x, idx.clamp(0, max(n - 1, 0)), axis)
        return torch.where((idx >= 0) & (idx < n), out,
                           _fill_value(x.dtype))

    @staticmethod
    def mul_f32(c, x):
        """``c * x`` for a numpy float32 scalar ``c``, strongly typed in
        jnp: the product at ``x``'s dtype promoted with float32. ``c`` goes
        in as a Python float, so no host value is copied to the card."""
        return x.to(torch.promote_types(x.dtype, torch.float32)) * float(c)

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def arange(self, n):
        return torch.arange(n, device=self.device)


def _axes(axis):
    """A jnp ``axis`` argument as a tuple of dims (None: every dim)."""
    return (axis,) if isinstance(axis, int) else axis


def _math(*xs):
    """numpy when every operand is a host value, else :class:`_TorchMath`
    (the JAX evaluator's ``_lib``)."""
    return np if _all_host(*xs) else _TorchMath


#: Graph runs inside _full_precision (over every thread) and the caller's
#: settings saved by the first of them.
_precision_lock = threading.Lock()
_precision_runs = 0
_precision_saved: tuple = ()


@contextmanager
def _full_precision():
    """fp32 products in full fp32 (no TF32) and bf16 products with fp32
    reductions, for the length of one graph run; restores the caller's
    settings. The settings are process-wide, so concurrent runs (``--jobs``
    workers) share one window: the first run in sets them, the last out
    restores them."""
    global _precision_runs, _precision_saved
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    with _precision_lock:
        if _precision_runs == 0:
            _precision_saved = (cudnn.allow_tf32, mm.allow_tf32,
                                mm.allow_bf16_reduced_precision_reduction)
            cudnn.allow_tf32 = False
            mm.allow_tf32 = False
            mm.allow_bf16_reduced_precision_reduction = False
        _precision_runs += 1
    try:
        yield
    finally:
        with _precision_lock:
            _precision_runs -= 1
            if _precision_runs == 0:
                (cudnn.allow_tf32, mm.allow_tf32,
                 mm.allow_bf16_reduced_precision_reduction) = \
                    _precision_saved


# -- exact integer products ----------------------------------------------------

#: Reduction depth up to which an fp32 product of int8 operands is exact:
#: 1040 · 127² < 2²⁴, so every partial sum, in any order, is an integer that
#: float32 holds exactly.
EXACT_FP32_DEPTH = 1040
#: ``torch._int_mm`` on the card (cuBLASLt, int8 -> int32) takes inner and
#: output widths that are multiples of 8, and rows padded here to a multiple
#: of 32: torch's own check passes more than 16 rows, but on the H100
#: cuBLASLt has no kernel for 17 or 24 rows at some widths (17 x 16 x 240
#: and 24 x 16 x 240, a squeeze-excite product of v2.4 at batch 8), and the
#: main paths run every product at a multiple of 32 rows.
INT_MM_ROWS = 32
INT_MM_ALIGN = 8


def int_mm_weight(w: torch.Tensor) -> torch.Tensor:
    """A ``[K, N]`` int8 weight as ``torch._int_mm`` takes it: contiguous,
    zero-padded to multiples of 8 (zeros add nothing to an integer sum).
    Made once per weight."""
    k, n = w.shape
    pk, pn = -k % INT_MM_ALIGN, -n % INT_MM_ALIGN
    if pk or pn:
        w = F.pad(w, (0, pn, 0, pk))
    return w.contiguous()


def _int_mm(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """``torch._int_mm`` of ``a [M, K]`` and a weight from
    :func:`int_mm_weight` (``n`` true output columns): ``a`` is zero-padded
    to the weight's padded depth and to a multiple of INT_MM_ROWS rows, and
    the result sliced back."""
    m, k = a.shape
    kp = b.shape[0]
    pm = -m % INT_MM_ROWS
    if pm or kp != k:
        a = F.pad(a, (0, kp - k, 0, pm))
    out = torch._int_mm(a.contiguous(), b)
    return out[:m, :n] if pm or out.shape[1] != n else out


def int_matmul(a: torch.Tensor, b: torch.Tensor,
               n: int | None = None) -> torch.Tensor:
    """Exact ``[M, K] x [K, N] -> [M, N]`` int32 product of int8 operands.

    ``b`` may already be laid out by :func:`int_mm_weight` (``n`` is then
    the true output width). The card runs ``torch._int_mm``; the CPU, and
    the meta device for shapes alone, take float64 products, exact for any
    depth below 2^53 / 127^2.
    """
    k = a.shape[-1]
    n = b.shape[1] if n is None else n
    if a.device.type == "cuda":
        if b.shape[0] % INT_MM_ALIGN or b.shape[1] % INT_MM_ALIGN:
            b = int_mm_weight(b)
        return _int_mm(a, b, n)
    return torch.matmul(a.double(), b[:k, :n].double()).to(torch.int32)


def int_conv_route(x_shape, w_shape, strides, pads, dilations, group,
                   device_type: str) -> str:
    """The exact route of an int8 conv, chosen from static shapes alone:

    - ``float64`` off the card (float64 products, exact);
    - ``fp32`` for a grouped (depthwise) conv: cuDNN/PyTorch fp32 with TF32
      off, exact while the depth ``C_in/group · prod(kernel)`` is at most
      EXACT_FP32_DEPTH;
    - ``fp32_split`` for a deeper grouped conv: the reduction cut into
      slices of at most EXACT_FP32_DEPTH, each an exact fp32 conv, summed
      in int32 (:func:`_conv_fp32_split`);
    - ``int_mm`` for a 1x1 stride-1 unpadded dense conv, a ``[N·H·W, C_in]
      x [C_in, C_out]`` product (on the card 3.4x faster than the exact fp32
      route at the widest 1x1 of the shipped graphs);
    - ``im2col`` for any other dense conv: int8 windows times the weight
      matrix through ``torch._int_mm`` (never cuDNN's fp32 algorithms,
      whose Winograd and FFT forms are not exact on integers).
    """
    if device_type != "cuda":
        return "float64"
    kernel = list(w_shape[2:])
    depth = int(w_shape[1] * np.prod(kernel))
    if group > 1:
        return "fp32" if depth <= EXACT_FP32_DEPTH else "fp32_split"
    pointwise = (all(k == 1 for k in kernel) and all(s == 1 for s in strides)
                 and not any(p for pair in pads for p in pair))
    return "int_mm" if pointwise else "im2col"


def prepare_int_conv_weight(w: torch.Tensor, route: str) -> torch.Tensor:
    """The int8 conv weight ``[C_out, C_in/group, *kernel]`` as ``route``
    reads it: the padded ``[C_in·prod(kernel), C_out]`` matrix for the
    ``_int_mm`` routes, a float copy for the float routes."""
    if route in ("int_mm", "im2col"):
        return int_mm_weight(w.reshape(w.shape[0], -1).T)
    return w.to(torch.float64 if route == "float64" else torch.float32)


def int_conv(x: torch.Tensor, w: torch.Tensor, strides, pads, dilations,
             group: int, route: str | None = None,
             prepared: torch.Tensor | None = None) -> torch.Tensor:
    """Exact int32 convolution of int8 ``x [N, C, *spatial]`` and int8
    ``w [C_out, C/group, *kernel]``; ``pads`` is a ``(lo, hi)`` pair per
    spatial dim. ``route`` defaults to :func:`int_conv_route`'s choice;
    ``prepared`` is the weight from :func:`prepare_int_conv_weight` for that
    route (made here when absent)."""
    if route is None:
        route = int_conv_route(tuple(x.shape), tuple(w.shape), strides, pads,
                               dilations, group, x.device.type)
    if prepared is None:
        prepared = prepare_int_conv_weight(w, route)
    if route == "fp32" and int(np.prod(w.shape[1:])) > EXACT_FP32_DEPTH:
        raise UnsupportedOnnxOp(
            f"one fp32 conv of reduction depth {int(np.prod(w.shape[1:]))} "
            f"is no exact route beyond {EXACT_FP32_DEPTH}; take fp32_split")
    if route in ("fp32", "float64"):
        return _conv_float(x, prepared, strides, pads, dilations,
                           group).to(torch.int32)
    if route == "fp32_split":
        return _conv_fp32_split(x, prepared, strides, pads, dilations, group)
    c_out = w.shape[0]
    n, c = x.shape[:2]
    if route == "int_mm":
        rows = x.movedim(1, -1).reshape(-1, c)
        out = _int_mm(rows, prepared, c_out)
        return out.reshape(n, *x.shape[2:], c_out).movedim(-1, 1)
    if route != "im2col":
        raise ValueError(f"unknown int8 conv route {route!r}")
    kernel = list(w.shape[2:])
    spatial = len(kernel)
    if any(p for pair in pads for p in pair):
        x = F.pad(x, [v for pair in reversed(pads) for v in pair])
    for d in range(spatial):
        x = x.unfold(2 + d, (kernel[d] - 1) * dilations[d] + 1, strides[d])
        if dilations[d] > 1:
            x = x[..., ::dilations[d]]
    out_sp = list(x.shape[2:2 + spatial])
    # [N, C, *out, *kernel] -> [N, *out, C, *kernel]: rows of C·prod(kernel)
    # in the weight's (c, k...) order.
    cols = x.permute(0, *range(2, 2 + spatial), 1,
                     *range(2 + spatial, 2 + 2 * spatial))
    out = _int_mm(cols.reshape(-1, c * int(np.prod(kernel))), prepared, c_out)
    return out.reshape(n, *out_sp, c_out).movedim(-1, 1)


def _conv_float(x, w, strides, pads, dilations, group) -> torch.Tensor:
    """An integer conv computed in ``w``'s float dtype (TF32 off), its
    result still in that dtype: exact where every partial sum is an exactly
    held integer."""
    spatial = x.ndim - 2
    # Contiguous NCHW: a channels-last input would send the depthwise conv
    # to cuDNN rather than PyTorch's direct-summation kernel.
    xf = x.to(dtype=w.dtype, memory_format=torch.contiguous_format)
    lo = [p[0] for p in pads]
    if lo != [p[1] for p in pads]:
        xf = F.pad(xf, [v for pair in reversed(pads) for v in pair])
        lo = [0] * spatial
    conv = (F.conv1d, F.conv2d, F.conv3d)[spatial - 1]
    with _full_precision():
        out = conv(xf, w, None, strides, lo, dilations, group)
    return out


def wide_int_conv(x: torch.Tensor, w: torch.Tensor, strides, pads,
                  dilations, group: int) -> torch.Tensor:
    """Exact int32 convolution of integer operands up to 255 in
    magnitude (the zero-point shifted operands of QLinearConv and
    ConvInteger; padding is 0 in the shifted domain, the zero point in the
    quantized one). Float64 products on every device: each partial sum is
    an integer below 2^53 for any depth under 2^53 / 255^2 (1.4e11), so
    direct summation is exact, and the result is rounded to the nearest
    integer so that a transform-based algorithm (cuDNN's FFT or Winograd,
    off by far less than 0.5) is exact too."""
    out = _conv_float(x, w.to(torch.float64), strides, pads, dilations,
                      group)
    return torch.round(out).to(torch.int32)


def wide_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product ``a @ b`` (numpy matmul broadcasting) of
    integer operands up to 255 in magnitude: float64 products
    (cuBLAS DGEMM on the card), exact for any depth under 2^53 / 255^2."""
    with _full_precision():
        out = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return out.to(torch.int32)


def _conv_fp32_split(x, w, strides, pads, dilations, group) -> torch.Tensor:
    """A grouped int8 conv deeper than EXACT_FP32_DEPTH, exactly: each
    group's input channels are cut into slices, and where the kernel alone
    is deeper, its first spatial axis into row bands, so that each piece's
    depth is at most EXACT_FP32_DEPTH. Each piece is an exact fp32 conv (a
    row band reads the input shifted by ``row · dilation``), converted to
    int32; the pieces are summed in int32. ``w`` is the float32 weight."""
    kernel = list(w.shape[2:])
    cg = w.shape[1]
    rest = int(np.prod(kernel[1:]))
    rows = min(kernel[0], EXACT_FP32_DEPTH // rest)
    if rows == 0:
        raise UnsupportedOnnxOp(
            f"grouped int8 conv of kernel {kernel}: one row of it is deeper "
            f"than {EXACT_FP32_DEPTH}, no exact route")
    chans = min(cg, EXACT_FP32_DEPTH // (rows * rest))
    xf = x.to(dtype=w.dtype, memory_format=torch.contiguous_format)
    if any(p for pair in pads for p in pair):
        xf = F.pad(xf, [v for pair in reversed(pads) for v in pair])
    n, sp = xf.shape[0], xf.shape[2:]
    out_rows = (sp[0] - (kernel[0] - 1) * dilations[0] - 1) // strides[0] + 1
    xg = xf.reshape(n, group, cg, *sp)
    conv = (F.conv1d, F.conv2d, F.conv3d)[len(kernel) - 1]
    total = None
    with _full_precision():
        for c0 in range(0, cg, chans):
            xs = xg[:, :, c0:c0 + chans].reshape(n, -1, *sp)
            for r0 in range(0, kernel[0], rows):
                part = conv(xs[:, :, r0 * dilations[0]:],
                            w[:, c0:c0 + chans, r0:r0 + rows], None, strides,
                            0, dilations, group)
                part = part[:, :, :out_rows].to(torch.int32)
                total = part if total is None else total.add_(part)
    return total


class _Evaluator:
    """Executes a graph node by node over a value environment."""

    def __init__(self, graph, compute_dtype=None, opset: int = 0):
        self.graph = graph
        self.opset = opset
        #: Per-thread state: the stack of live environments (the outer
        #: scope of If/Loop/Scan bodies), the compute-cast suppression and
        #: the loop steps a body runs in.
        self._tls = threading.local()
        #: Names of subgraph initializers lifted into OnnxFunction.params
        #: (they reach the bodies through the outer environment).
        self.lifted_params: set = set()
        #: Body evaluators by id(graph), made once under the lock.
        self._sub_evs: dict = {}
        self._sub_lock = threading.Lock()
        #: Loop iteration numbers, one object per value, so that a fold on
        #: an iteration number is the same fold at every call.
        self._iters: dict = {}
        #: torch.bfloat16 for mixed precision, None for the fp32 route.
        self.compute_dtype = compute_dtype
        self.const: dict[str, np.ndarray] = {
            name: t.array for name, t in graph.initializers.items()
            if t.array is not None
        }
        for node in graph.nodes:
            if node.op_type == "Constant" and node.outputs:
                v = _constant_payload(node)
                if v is not None:
                    self.const[node.outputs[0]] = v
        #: Device copies of persistent host arrays: (id, device) -> (array,
        #: tensor); the array is held so its id cannot be reused.
        self._device_copies: dict[tuple, tuple[Any, torch.Tensor]] = {}
        #: ids of host arrays that live across runs (constants, params and
        #: the folded BatchNormalization factors).
        self._persistent: set[int] = set()
        #: Folded BatchNormalization (inv, shift) by node name.
        self._bn_folds: dict[str, tuple] = {}
        #: Fused front-end kernel layouts: (id(w), id(fb)) -> (w, fb, layout).
        self._logmel_layouts: dict[tuple, tuple] = {}
        #: Conv1d-STFT kernel weight layouts: (output name, device) -> (w,
        #: layout); one per node, so a weight computed afresh each run (a
        #: DequantizeLinear of an int8 one) replaces its entry.
        self._conv1d_layouts: dict[tuple, tuple] = {}
        #: int8 weights laid out for their integer route: (id(w), route) ->
        #: (w, layout).
        self._int_layouts: dict[tuple, tuple] = {}
        #: Values folded on constants (a node's, keyed by id(node); host
        #: arithmetic inside a handler, a requantize scale or a shifted
        #: weight, by (what, id(node))): key -> (inputs, value).
        self._memos: dict = {}

    @property
    def compute_dtype(self):
        if getattr(self._tls, "cd_suppressed", False):
            return None
        return self._compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, value):
        self._compute_dtype = value

    @contextmanager
    def _no_compute_cast(self):
        """Suppress the compute-dtype casts of matmul/conv operands inside
        the block (the integer paths accumulate in int32 and must never see
        a bf16 cast). Per thread, so that threads sharing one evaluator do
        not strip each other's compute dtype; re-entrant."""
        prev = getattr(self._tls, "cd_suppressed", False)
        self._tls.cd_suppressed = True
        try:
            yield
        finally:
            self._tls.cd_suppressed = prev

    # -- execution ----------------------------------------------------------

    def run(self, feeds: dict[str, Any]) -> dict[str, Any]:
        env: dict[str, Any] = dict(self.const)
        env.update(feeds)
        self._persistent.update(
            id(v) for v in env.values() if isinstance(v, np.ndarray))
        return self._execute(env)

    def _execute(self, env: dict) -> dict:
        """Run every node over ``env`` (pushed on this thread's stack of
        live environments for the bodies of control-flow nodes)."""
        env[""] = None
        stack = getattr(self._tls, "envs", None)
        if stack is None:
            stack = self._tls.envs = []
        stack.append(env)
        try:
            with _full_precision():
                for node in self.graph.nodes:
                    if node.op_type == "Constant":
                        continue
                    handler = getattr(self, f"op_{node.op_type}", None)
                    if handler is None:
                        raise UnsupportedOnnxOp(
                            f"ONNX op '{node.op_type}' (node '{node.name}') "
                            "is not supported")
                    args = [
                        self._fetch(node, pos, i, env[i]) if i else None
                        for pos, i in enumerate(node.inputs)
                    ]
                    result = self._call(node, handler, args)
                    if not isinstance(result, tuple):
                        result = (result,)
                    for out_name, val in zip(node.outputs, result):
                        if out_name:
                            env[out_name] = self._store(out_name, val)
        finally:
            stack.pop()
        return env

    def _constant(self, v) -> bool:
        """Whether ``v`` is the same value on every run: absent, an
        immutable host scalar, or a host array the evaluator keeps
        (constants, params, earlier folds)."""
        if isinstance(v, np.ndarray):
            return id(v) in self._persistent
        return v is None or isinstance(v, (np.generic, int, float, bool))

    def _call(self, node, handler, args):
        """One node's handler. A node whose inputs are all host values
        folds on the host: a tensor it returns comes back as numpy; and
        where they are all constants, once (:meth:`_memo`). A control-flow
        node is never folded: its body reads the enclosing graph."""
        if node.op_type in _CONTROL_FLOW or not _all_host(*args):
            return handler(node, *args)

        def fold():
            result = handler(node, *args)
            return (tuple(_as_host(v) for v in result)
                    if isinstance(result, tuple) else _as_host(result))

        return self._memo(id(node), args, fold)

    def _memo(self, key, inputs, make):
        """``make()`` once for these ``inputs`` while each is a constant
        (:meth:`_constant`) and the same object as on the last call under
        ``key``; its arrays are kept persistent, so a device copy of them is
        made once (as a jit trace folds constants once). Computed afresh
        otherwise. Inside a Loop or Scan body the key holds the loop steps
        (:meth:`_steps`): each iteration keeps its own fold, so a fold on
        the iteration number gives that iteration's value and is made once
        per iteration, not once per call."""
        if not all(self._constant(v) for v in inputs):
            return make()
        key = (key, self._steps())
        hit = self._memos.get(key)
        if hit is not None and len(hit[0]) == len(inputs) and all(
                a is b for a, b in zip(hit[0], inputs)):
            return hit[1]
        val = make()
        self._memos[key] = (list(inputs), val)
        self._persistent.update(
            id(v) for v in (val if isinstance(val, tuple) else (val,))
            if isinstance(v, np.ndarray))
        return val

    def _steps(self) -> tuple:
        """The loop steps this thread's run of this evaluator is inside
        (one per enclosing Loop or Scan; empty at the top level)."""
        return getattr(self._tls, "steps", ())

    @staticmethod
    def _host_value(node, x, what: str):
        """``x``, which sets a shape or a static parameter: a device
        tensor there is refused, not read."""
        if isinstance(x, torch.Tensor):
            raise UnsupportedOnnxOp(
                f"{node.op_type} (node '{node.name}'): {what} is a device "
                "value; it must be a host constant (the JAX evaluator's "
                "trace refuses it, and reading it would sync the device)")
        return x

    def _store(self, name, val):
        """Hook over every value entering the environment."""
        return val

    def _fetch(self, node, pos, name, val):
        """Hook over every value leaving the environment for a node input."""
        return val

    # -- host/device plumbing -----------------------------------------------

    def _tensor(self, x, device: torch.device, dtype=None) -> torch.Tensor:
        """``x`` as a tensor on ``device`` (at ``dtype`` when given);
        persistent host arrays are copied once per device and dtype."""
        if isinstance(x, torch.Tensor):
            return x.to(device, dtype)
        key = (id(x), device, dtype)
        hit = self._device_copies.get(key)
        if hit is not None and hit[0] is x:
            return hit[1]
        t = torch.from_numpy(_host_array(x)).to(device, dtype)
        if id(x) in self._persistent:
            self._device_copies[key] = (x, t)
        return t

    def _operand(self, x, device):
        """Elementwise operand: Python scalars stay weak (like jnp)."""
        if isinstance(x, (int, float, bool)):
            return x
        return self._tensor(x, device)

    def _promote(self, *xs, dev=None, uniform: bool = False) -> list:
        """Operands of one elementwise op as jax.numpy takes them: host
        arrays become tensors on the operands' device, and the tensors
        promote as jnp promotes them, on the dtypes alone. torch's own
        promotion does the same among dimensioned tensors, inside the op's
        kernel; but it lets a 0-d tensor yield to a dimensioned one of its
        category, so where both kinds meet with different dtypes each
        tensor is cast to the common dtype first (``uniform``: always, for
        ops that take one dtype). Python scalars stay weak; None passes."""
        dev = _device_of(*xs) if dev is None else dev
        ts = [x if x is None else self._operand(x, dev) for x in xs]
        tensors = [t for t in ts if isinstance(t, torch.Tensor)]
        if len({t.dtype for t in tensors}) < 2 or not (uniform or (
                any(t.dim() == 0 for t in tensors)
                and any(t.dim() for t in tensors))):
            return ts
        dt = tensors[0].dtype
        for t in tensors[1:]:
            dt = torch.promote_types(dt, t.dtype)
        return [t.to(dt) if isinstance(t, torch.Tensor) and t.dtype != dt
                else t for t in ts]

    def _binary(self, np_fn, torch_fn, a, b):
        if _is_host(a) and _is_host(b):
            return np_fn(a, b)
        return torch_fn(*self._promote(a, b))

    def _lib(self, *xs):
        """(math, operands) of a handler written once for host and device
        values, as the JAX evaluator's ``m = self._lib(*xs)``: numpy and the
        operands as they are when all are host values; else
        :class:`_TorchMath` on their device and the operands as tensors
        there (:meth:`_promote`: a constant's device copy is made once)."""
        if _all_host(*xs):
            return np, xs
        dev = _device_of(*xs)
        return _TorchMath(dev), self._promote(*xs, dev=dev)

    def _where(self, cond, a, b):
        if _is_host(cond) and _is_host(a) and _is_host(b):
            return np.where(cond, a, b)
        dev = _device_of(cond, a, b)
        a, b = self._promote(a, b, dev=dev)
        return torch.where(self._tensor(cond, dev).to(torch.bool), a, b)

    def _mm_cast(self, device, *xs):
        """Matmul/conv operands as tensors on ``device``, float operands at
        the compute dtype."""
        out = []
        for x in xs:
            floating = (x.is_floating_point() if isinstance(x, torch.Tensor)
                        else np.asarray(x).dtype.kind == "f")
            out.append(self._tensor(
                x, device, self.compute_dtype if floating else None))
        return out

    def _contract(self, fn, *xs) -> torch.Tensor:
        """Run a matmul/conv ``fn`` with fp32 accumulation. On the card the
        bf16 operands go to the tensor cores, which accumulate in fp32 and
        round the result to bf16 once, as ``_mm_out`` would; on the CPU the
        bf16-rounded operands are multiplied in fp32, the same
        arithmetic."""
        if self.compute_dtype is not None and xs[0].device.type == "cpu":
            return fn(*(x.float() for x in xs))
        return fn(*xs)

    def _mm_out(self, out):
        """Materialize matmul/conv outputs at the compute dtype."""
        if self.compute_dtype is None or _is_host(out):
            return out
        return out.to(self.compute_dtype)

    # -- elementwise --------------------------------------------------------

    def op_Add(self, node, a, b):
        return self._binary(np.add, torch.add, a, b)

    def op_Sub(self, node, a, b):
        return self._binary(np.subtract, torch.sub, a, b)

    def op_Mul(self, node, a, b):
        return self._binary(np.multiply, torch.mul, a, b)

    def op_Div(self, node, a, b):
        if _is_host(a) and _is_host(b):
            res = np.divide(a, b)
            # ONNX integer Div truncates toward zero.
            if np.asarray(a).dtype.kind in "iu" and \
                    np.asarray(b).dtype.kind in "iu":
                res = (np.sign(res) * np.floor(np.abs(res))).astype(
                    np.asarray(a).dtype)
            return res
        return self._binary(np.divide, torch.div, a, b)

    def op_Pow(self, node, a, b):
        return self._binary(np.power, torch.pow, a, b)

    def op_Sqrt(self, node, x):
        return _math(x).sqrt(x)

    def op_Exp(self, node, x):
        return _math(x).exp(x)

    def op_Log(self, node, x):
        return _math(x).log(x)

    def op_Neg(self, node, x):
        return _math(x).negative(x)

    def op_Abs(self, node, x):
        return _math(x).abs(x)

    def op_Floor(self, node, x):
        return _math(x).floor(x)

    def op_Ceil(self, node, x):
        return _math(x).ceil(x)

    def op_Reciprocal(self, node, x):
        return 1.0 / x

    def op_Min(self, node, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = self._binary(np.minimum, torch.minimum, out, x)
        return out

    def op_Max(self, node, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = self._binary(np.maximum, torch.maximum, out, x)
        return out

    def op_Erf(self, node, x):
        if _is_host(x):
            from scipy.special import erf as _erf

            return _erf(x).astype(np.asarray(x).dtype)
        return torch.erf(x)

    def op_Relu(self, node, x):
        return _math(x).maximum(x, 0)

    def op_LeakyRelu(self, node, x):
        alpha = node.attr("alpha", 0.01)
        return _math(x).where(x >= 0, x, alpha * x)

    def op_PRelu(self, node, x, slope):
        neg = self._binary(np.multiply, torch.mul, slope, x)
        return self._where(x >= 0, x, neg)

    def op_Elu(self, node, x):
        alpha = node.attr("alpha", 1.0)
        m = _math(x)
        return m.where(x >= 0, x, alpha * (m.exp(x) - 1))

    def op_Sigmoid(self, node, x):
        if _is_host(x):
            z = np.asarray(x).astype(np.float64)
            return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)
        return torch.sigmoid(x)

    def op_HardSigmoid(self, node, x):
        alpha = node.attr("alpha", 0.2)
        beta = node.attr("beta", 0.5)
        return _math(x).clip(alpha * x + beta, 0, 1)

    def op_HardSwish(self, node, x):
        m = _math(x)
        return x * m.clip(m.true_divide(x, 6.0) + 0.5, 0, 1)

    def op_Tanh(self, node, x):
        return _math(x).tanh(x)

    def op_Softplus(self, node, x):
        m = _math(x)
        return m.log1p(m.exp(-m.abs(x))) + m.maximum(x, 0)

    def op_Celu(self, node, x):
        alpha = node.attr("alpha", 1.0)
        m = _math(x)
        return m.maximum(x, 0) + m.minimum(
            alpha * (m.exp(m.true_divide(m.minimum(x, 0), alpha)) - 1), 0)

    def op_Selu(self, node, x):
        alpha = node.attr("alpha", 1.6732632423543772)
        gamma = node.attr("gamma", 1.0507009873554805)
        m = _math(x)
        return gamma * m.where(x > 0, x, alpha * (m.exp(m.minimum(x, 0)) - 1))

    def op_Mish(self, node, x):
        return x * _math(x).tanh(self.op_Softplus(node, x))

    def op_Softsign(self, node, x):
        return x / (1 + _math(x).abs(x))

    def op_ThresholdedRelu(self, node, x):
        alpha = node.attr("alpha", 1.0)
        m = _math(x)
        return m.where(x > alpha, x, m.zeros_like(x))

    def op_Shrink(self, node, x):
        bias = node.attr("bias", 0.0)
        lambd = node.attr("lambd", 0.5)
        m = _math(x)
        return m.where(x < -lambd, x + bias,
                       m.where(x > lambd, x - bias, m.zeros_like(x)))

    def op_Sin(self, node, x):
        return _math(x).sin(x)

    def op_Cos(self, node, x):
        return _math(x).cos(x)

    def op_Tan(self, node, x):
        return _math(x).tan(x)

    def op_Asin(self, node, x):
        return _math(x).arcsin(x)

    def op_Acos(self, node, x):
        return _math(x).arccos(x)

    def op_Atan(self, node, x):
        return _math(x).arctan(x)

    def op_Sinh(self, node, x):
        return _math(x).sinh(x)

    def op_Cosh(self, node, x):
        return _math(x).cosh(x)

    def op_Asinh(self, node, x):
        return _math(x).arcsinh(x)

    def op_Acosh(self, node, x):
        return _math(x).arccosh(x)

    def op_Atanh(self, node, x):
        return _math(x).arctanh(x)

    def op_Dropout(self, node, x, ratio=None, training_mode=None):
        """Inference no-op; a host ``training_mode=True`` is refused, a
        device one is not read (as in the JAX evaluator's trace)."""
        if (training_mode is not None and _is_host(training_mode)
                and bool(np.asarray(training_mode).reshape(-1)[0])):
            raise UnsupportedOnnxOp(
                "Dropout with training_mode=True (training graph, not an "
                "inference export)")
        if len(node.outputs) > 1 and node.outputs[1]:
            mask = (np.ones(np.shape(x), np.bool_) if _is_host(x)
                    else torch.ones(x.shape, dtype=torch.bool,
                                    device=x.device))
            return x, mask
        return x

    def _softmax_axes(self, node, x) -> tuple:
        """Opset >= 13: softmax along one axis (default -1). Opset < 13:
        the input is coerced to 2-D at ``axis`` (default 1) and softmax
        runs over the flattened trailing block — equivalent to reducing
        jointly over every axis from ``axis`` on."""
        if 0 < self.opset < 13:
            ax = node.attr("axis", 1) % x.ndim
            return tuple(range(ax, x.ndim))
        return (node.attr("axis", -1) % x.ndim,)

    def op_Softmax(self, node, x):
        """Max-subtracted softmax in the input's dtype (bf16 in, bf16 out,
        as ``jax.numpy`` computes it)."""
        axes = self._softmax_axes(node, x)
        if _is_host(x):
            e = np.exp(x - np.max(x, axis=axes, keepdims=True))
            return e / e.sum(axis=axes, keepdims=True)
        e = torch.exp(x - x.amax(dim=axes, keepdim=True))
        return e / e.sum(dim=axes, keepdim=True)

    def op_LogSoftmax(self, node, x):
        axes = self._softmax_axes(node, x)
        if _is_host(x):
            z = x - np.max(x, axis=axes, keepdims=True)
            return z - np.log(np.exp(z).sum(axis=axes, keepdims=True))
        z = x - x.amax(dim=axes, keepdim=True)
        return z - torch.log(torch.exp(z).sum(dim=axes, keepdim=True))

    def op_Hardmax(self, node, x):
        """One-hot of the first largest element along ``axis`` (opset <
        13: over the flattened trailing block), in the input's dtype."""
        host = _is_host(x)
        if 0 < self.opset < 13:
            ax = node.attr("axis", 1) % x.ndim
            rows = int(np.prod(x.shape[:ax], dtype=np.int64)) if ax else 1
            if host:
                flat = np.reshape(x, (rows, -1))
                one = np.arange(flat.shape[1]) == np.expand_dims(
                    np.argmax(flat, axis=1), 1)
                return np.reshape(one.astype(np.asarray(x).dtype), x.shape)
            flat = x.reshape(rows, -1)
            one = torch.arange(flat.shape[1], device=x.device) == \
                flat.argmax(1)[:, None]
            return one.to(x.dtype).reshape(x.shape)
        ax = node.attr("axis", -1) % x.ndim
        shape = [1] * x.ndim
        shape[ax] = x.shape[ax]
        if host:
            one = np.reshape(np.arange(x.shape[ax]), shape) == \
                np.expand_dims(np.argmax(x, axis=ax), ax)
            return one.astype(np.asarray(x).dtype)
        one = torch.arange(x.shape[ax], device=x.device).reshape(shape) == \
            x.argmax(ax).unsqueeze(ax)
        return one.to(x.dtype)

    def op_Clip(self, node, x, lo=None, hi=None):
        """``jnp.clip``: maximum with ``lo``, then minimum with ``hi``, each
        promoting (a float32 constant bound turns a bf16 input float32; the
        default infinite bounds are weak)."""
        if lo is None:
            lo = node.attr("min", -np.inf)
        if hi is None:
            hi = node.attr("max", np.inf)
        if _is_host(x):
            return np.clip(x, lo, hi)
        x, lo, hi = self._promote(x, lo, hi, uniform=True)
        for bound in (lo, hi):
            if not isinstance(bound, torch.Tensor):
                dt = torch.result_type(torch.empty(1, dtype=x.dtype), bound)
                x = x.to(dt)
        x = torch.clamp_min(x, lo.to(x.dtype) if isinstance(lo, torch.Tensor)
                            else lo)
        return torch.clamp_max(x, hi.to(x.dtype)
                               if isinstance(hi, torch.Tensor) else hi)

    def op_Where(self, node, cond, a, b):
        return self._where(cond, a, b)

    def op_Equal(self, node, a, b):
        return self._binary(np.equal, torch.eq, a, b)

    def op_Greater(self, node, a, b):
        return self._binary(np.greater, torch.gt, a, b)

    def op_Less(self, node, a, b):
        return self._binary(np.less, torch.lt, a, b)

    def op_Not(self, node, x):
        return _math(x).logical_not(x)

    def op_And(self, node, a, b):
        return self._binary(np.logical_and, torch.logical_and, a, b)

    def op_Or(self, node, a, b):
        return self._binary(np.logical_or, torch.logical_or, a, b)

    def op_Xor(self, node, a, b):
        return self._binary(np.logical_xor, torch.logical_xor, a, b)

    def op_GreaterOrEqual(self, node, a, b):
        return self._binary(np.greater_equal, torch.ge, a, b)

    def op_LessOrEqual(self, node, a, b):
        return self._binary(np.less_equal, torch.le, a, b)

    def op_IsNaN(self, node, x):
        return _math(x).isnan(x)

    def op_IsInf(self, node, x):
        detect_pos = node.attr("detect_positive", 1)
        detect_neg = node.attr("detect_negative", 1)
        m = _math(x)
        if detect_pos and detect_neg:
            return m.isinf(x)
        if detect_pos:
            return m.isposinf(x)
        if detect_neg:
            return m.isneginf(x)
        if m is np:
            return np.zeros(np.shape(x), np.bool_)
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    def op_Sum(self, node, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = self._binary(np.add, torch.add, out, x)
        return out

    def op_Mean(self, node, *xs):
        total = self.op_Sum(node, *xs)
        return _math(total).true_divide(total, len(xs))

    def op_Mod(self, node, a, b):
        """``jnp.fmod`` (``fmod=1``) or ``jnp.mod``: a truncated remainder,
        for ``mod`` moved by the divisor where the signs differ, an integer
        divisor of 0 taken as 1 (the same arithmetic, so the same bits)."""
        fmod = node.attr("fmod", 0)
        if _is_host(a) and _is_host(b):
            return np.fmod(a, b) if fmod else np.mod(a, b)
        a, b = self._promote(a, b, uniform=True)
        if not (a.is_floating_point() or a.is_complex()):
            b = torch.where(b == 0, torch.ones_like(b), b)
        rem = torch.fmod(a, b)
        if fmod:
            return rem
        move = ((rem < 0) != (b < 0)) & (rem != 0)
        return torch.where(move, rem + b, rem)

    # -- shape / structure ---------------------------------------------------

    def op_Identity(self, node, x):
        return x

    def op_Cast(self, node, x):
        to = _NP_FROM_ONNX_DT[node.attr("to")]
        if _is_host(x):
            return np.asarray(x).astype(to)
        return x.to(_DEVICE_DTYPE[np.dtype(to)])

    def op_Shape(self, node, x):
        """A host constant, one array per shape. Opset >= 15 start/end
        (negative counts from the back; both clamp to [0, rank])."""
        rank = len(np.shape(x))

        def _clamp(v, default):
            if v is None:
                return default
            v = int(v)
            if v < 0:
                v += rank
            return min(max(v, 0), rank)

        start = _clamp(node.attr("start"), 0)
        end = _clamp(node.attr("end"), rank)
        # One array per shape, so that the folds on it are made once too.
        dims = tuple(x.shape)[start:end]
        return self._memo(("shape", id(node), dims), [],
                          lambda: np.asarray(dims, np.int64))

    def op_Size(self, node, x):
        return self._memo(("size", id(node), tuple(x.shape)), [],
                          lambda: np.asarray(int(np.prod(x.shape)), np.int64))

    def op_Reshape(self, node, x, shape):
        shape = [int(s) for s in np.asarray(
            self._host_value(node, shape, "shape")).reshape(-1)]
        if not node.attr("allowzero", 0):
            shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        return x.reshape(shape)

    def op_Split(self, node, x, split=None):
        axis = node.attr("axis", 0)
        if split is None:
            split = node.attr("split")
        n_out = len(node.outputs)
        if split is not None:
            split = [int(s) for s in np.asarray(
                self._host_value(node, split, "split")).reshape(-1)]
        if _is_host(x):
            if split is None:
                return tuple(np.split(x, n_out, axis=axis))
            return tuple(np.split(x, np.cumsum(split)[:-1].tolist(),
                                  axis=axis))
        if split is None:
            if x.shape[axis] % n_out:
                raise ValueError(
                    "array split does not result in an equal division")
            return tuple(torch.tensor_split(x, n_out, dim=axis))
        return tuple(torch.tensor_split(x, np.cumsum(split)[:-1].tolist(),
                                        dim=axis))

    def _take(self, x, idx, axis: int):
        """``jnp.take(x, idx, axis)``: negative indices count from the end;
        an index still out of range gives jnp's fill value (NaN, the
        smallest signed or largest unsigned integer, True), where
        ``index_select`` would fault on the card. A host scalar index (a
        Loop body's iteration number) selects a view: no index is copied
        to the card."""
        dev = _device_of(x, idx)
        x = self._tensor(x, dev)
        ax = axis % x.ndim
        n = x.shape[ax]
        if _is_host(idx) and np.ndim(idx) == 0:
            i = int(idx) + (n if int(idx) < 0 else 0)
            if 0 <= i < n:
                return x.select(ax, i)
            return torch.full(x.shape[:ax] + x.shape[ax + 1:],
                              _fill_value(x.dtype), dtype=x.dtype,
                              device=dev)
        it = self._tensor(idx, dev).to(torch.int64)
        it = torch.where(it < 0, it + n, it)
        valid = (it >= 0) & (it < n)
        out = x.index_select(ax, it.clamp(0, max(n - 1, 0)).reshape(-1))
        out = out.reshape(*x.shape[:ax], *it.shape, *x.shape[ax + 1:])
        mask = valid.reshape((1,) * ax + tuple(it.shape)
                             + (1,) * (x.ndim - ax - 1))
        return torch.where(mask, out, _fill_value(x.dtype))

    def op_Gather(self, node, x, idx):
        axis = node.attr("axis", 0)
        if _is_host(x) and _is_host(idx):
            return np.take(x, np.asarray(idx), axis=axis)
        return self._take(x, idx, axis)

    def op_GatherElements(self, node, x, idx):
        axis = node.attr("axis", 0)
        if _is_host(x) and _is_host(idx):
            return np.take_along_axis(np.asarray(x), np.asarray(idx),
                                      axis=axis)
        dev = _device_of(x, idx)
        x = self._tensor(x, dev)
        ax = axis % x.ndim
        n = x.shape[ax]
        it = self._tensor(idx, dev).to(torch.int64)
        it = torch.where(it < 0, it + n, it)
        valid = (it >= 0) & (it < n)
        out = torch.gather(x, ax, it.clamp(0, max(n - 1, 0)))
        return torch.where(valid, out, _fill_value(x.dtype))

    def op_Expand(self, node, x, shape):
        shape = [int(s) for s in np.asarray(
            self._host_value(node, shape, "shape")).reshape(-1)]
        target = list(np.broadcast_shapes(tuple(x.shape), tuple(shape)))
        if _is_host(x):
            return np.broadcast_to(x, target)
        return x.expand(target)

    def op_Tile(self, node, x, repeats):
        repeats = [int(r) for r in np.asarray(
            self._host_value(node, repeats, "repeats")).reshape(-1)]
        return np.tile(x, repeats) if _is_host(x) else torch.tile(x, repeats)

    def op_SpaceToDepth(self, node, x):
        """NCHW [N,C,H,W] -> [N,C*b*b,H/b,W/b]."""
        b = node.attr("blocksize")
        n, c, h, w = x.shape
        if _is_host(x):
            y = np.reshape(x, (n, c, h // b, b, w // b, b))
            y = np.transpose(y, (0, 3, 5, 1, 2, 4))
            return np.reshape(y, (n, c * b * b, h // b, w // b))
        y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
        return y.reshape(n, c * b * b, h // b, w // b)

    def op_DepthToSpace(self, node, x):
        b = node.attr("blocksize")
        mode = node.attr("mode", b"DCR")
        if isinstance(mode, bytes):
            mode = mode.decode()
        n, c, h, w = x.shape
        if mode == "DCR":
            split, perm = (n, b, b, c // (b * b), h, w), (0, 3, 4, 1, 5, 2)
        else:  # CRD
            split, perm = (n, c // (b * b), b, b, h, w), (0, 1, 4, 2, 5, 3)
        out = (n, c // (b * b), h * b, w * b)
        if _is_host(x):
            return np.reshape(np.transpose(np.reshape(x, split), perm), out)
        return x.reshape(split).permute(perm).reshape(out)

    def op_Trilu(self, node, x, k=None):
        kk = 0 if k is None else int(np.asarray(
            self._host_value(node, k, "k")).reshape(-1)[0])
        if _is_host(x):
            return np.triu(x, kk) if node.attr("upper", 1) \
                else np.tril(x, kk)
        return torch.triu(x, kk) if node.attr("upper", 1) \
            else torch.tril(x, kk)

    def op_Range(self, node, start, limit, delta):
        start, limit, delta = (self._host_value(node, v, "a Range bound")
                               for v in (start, limit, delta))
        return np.arange(int(start), int(limit), int(delta), dtype=np.int64)

    def op_ConstantOfShape(self, node, shape):
        shape = [int(s) for s in np.asarray(
            self._host_value(node, shape, "shape")).reshape(-1)]
        t = node.attr("value")
        if t is not None and getattr(t, "array", None) is not None:
            fill = t.array.reshape(-1)[0]
            return np.full(shape, fill, t.array.dtype)
        return np.zeros(shape, np.float32)

    def op_Pad(self, node, x, pads=None, value=None, axes=None):
        """``jnp.pad``: constant (the value input, else 0), reflect, edge or
        wrap; a negative pad is refused, as jnp.pad refuses it. The
        non-constant modes gather each padded axis at the indices
        ``np.pad`` gives an ``arange`` of it, which is numpy's (and so
        jnp's) definition of the mode."""
        mode = node.attr("mode", b"constant")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if pads is None:
            pads = node.attr("pads")
        pads = [int(p) for p in np.asarray(
            self._host_value(node, pads, "pads")).reshape(-1)]
        nd = x.ndim
        if axes is not None:
            ax = [int(a) % nd for a in np.asarray(
                self._host_value(node, axes, "axes")).reshape(-1)]
        else:
            ax = list(range(nd))
        half = len(pads) // 2
        pad_width = [(0, 0)] * nd
        for i, a in enumerate(ax):
            pad_width[a] = (pads[i], pads[i + half])
        if mode == "constant":
            cv = 0 if value is None else float(np.asarray(self._host_value(
                node, value, "the pad value")).reshape(-1)[0])
            if _is_host(x):
                return np.pad(x, pad_width, mode="constant",
                              constant_values=cv)
        np_mode = {"reflect": "reflect", "edge": "edge", "wrap": "wrap",
                   "constant": "constant"}[mode]
        if _is_host(x):
            return np.pad(x, pad_width, mode=np_mode)
        if any(p < 0 for pair in pad_width for p in pair):
            raise ValueError("index can't contain negative values")
        if mode == "constant":
            flat = [v for pair in reversed(pad_width) for v in pair]
            return F.pad(x, flat, value=cv)
        for a, (lo, hi) in enumerate(pad_width):
            if lo or hi:
                idx = self._memo(
                    ("pad", id(node), a, x.shape[a], lo, hi, np_mode), [],
                    lambda n=x.shape[a], lo=lo, hi=hi: np.pad(
                        np.arange(n), (lo, hi), mode=np_mode))
                x = x.index_select(a, self._tensor(idx, x.device))
        return x

    def op_Flatten(self, node, x):
        axis = node.attr("axis", 1)
        lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
        return x.reshape(lead, -1)

    def op_Transpose(self, node, x):
        perm = node.attr("perm")
        if _is_host(x):
            return np.transpose(x, perm)
        return x.permute(*(perm or reversed(range(x.ndim))))

    def op_Squeeze(self, node, x, axes=None):
        """Axes from the input (opset 13 on), else the attribute; none
        given squeezes every unit axis."""
        if axes is None:
            axes = node.attr("axes")
        if axes is None:
            axes = [i for i, s in enumerate(x.shape) if s == 1]
        axes = tuple(int(a) % x.ndim for a in np.asarray(axes).reshape(-1))
        if _is_host(x):
            return np.squeeze(x, axis=axes)
        return x.squeeze(axes) if axes else x

    def op_Unsqueeze(self, node, x, axes=None):
        if axes is None:
            axes = node.attr("axes")
        axes = sorted(int(a) for a in np.asarray(axes).reshape(-1))
        nd = np.ndim(x) + len(axes)
        out = x
        for a in axes:
            a = a % nd if a < 0 else a
            out = np.expand_dims(out, a) if _is_host(out) else out.unsqueeze(a)
        return out

    def op_Concat(self, node, *xs):
        axis = node.attr("axis")
        xs = [x for x in xs if x is not None]
        if all(_is_host(x) for x in xs):
            return np.concatenate(xs, axis=axis)
        dev = _device_of(*xs)
        ts = [self._tensor(x, dev) for x in xs]
        dt = ts[0].dtype
        for t in ts[1:]:
            dt = torch.promote_types(dt, t.dtype)
        return torch.cat([t.to(dt) for t in ts], dim=axis)

    def op_Slice(self, node, x, starts=None, ends=None, axes=None,
                 steps=None):
        if starts is None:  # opset < 10: attributes
            starts = node.attr("starts")
            ends = node.attr("ends")
            axes = node.attr("axes")
        starts = [int(v) for v in np.asarray(starts).reshape(-1)]
        ends = [int(v) for v in np.asarray(ends).reshape(-1)]
        nd = np.ndim(x)
        axes = (list(range(len(starts))) if axes is None
                else [int(v) % nd for v in np.asarray(axes).reshape(-1)])
        steps = ([1] * len(starts) if steps is None
                 else [int(v) for v in np.asarray(steps).reshape(-1)])
        slicers = [slice(None)] * nd
        reversed_axes = []
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            dim = x.shape[ax]
            # ONNX uses INT64_MAX-ish sentinels for "to the end".
            st, en = min(st, dim), min(en, dim)
            slicers[ax] = slice(st, en, sp)
            if sp < 0:
                reversed_axes.append(ax)
        if _is_host(x) or not reversed_axes:
            return x[tuple(slicers)]
        # torch slicing takes no negative steps: gather those axes.
        out = x
        for ax, sl in enumerate(slicers):
            if ax in reversed_axes:
                idx = torch.arange(*sl.indices(x.shape[ax]), device=x.device)
                out = out.index_select(ax, idx)
            else:
                out = out[(slice(None),) * ax + (sl,)]
        return out

    # -- reductions ----------------------------------------------------------

    _REDUCE_NOOP = object()

    def _reduce_plan(self, node, x, axes):
        """Axes from the input (a host value), else the attribute; empty or
        absent axes follow ``noop_with_empty_axes`` (None = every axis)."""
        if axes is None:
            axes = node.attr("axes")
        if axes is not None:
            nd = np.ndim(x)
            t = tuple(int(a) % nd for a in np.asarray(
                self._host_value(node, axes, "axes")).reshape(-1))
            if t:
                return t
        return self._REDUCE_NOOP if node.attr("noop_with_empty_axes", 0) \
            else None

    @staticmethod
    def _mean(x, axes, keepdims: bool):
        """jnp.mean's arithmetic: fp32 accumulation, the result at the
        input's float dtype (float32 for an integer input)."""
        dims = axes if axes is not None else tuple(range(x.ndim))
        out = x.float().mean(dim=dims, keepdim=keepdims)
        return out.to(x.dtype) if x.is_floating_point() else out

    @staticmethod
    def _torch_reduce(fn_name, x, plan, keepdims: bool):
        """The jnp reduction ``fn_name`` over ``plan`` (None: every axis)
        of a tensor."""
        dims = plan if plan is not None else tuple(range(x.ndim))
        if fn_name == "mean":
            return _Evaluator._mean(x, dims, keepdims)
        if fn_name == "sum":
            if not x.is_floating_point():
                return x.sum(dim=dims, keepdim=keepdims,
                             dtype=torch.int64).to(_int_acc(x.dtype))
            return x.sum(dim=dims, keepdim=keepdims)
        if fn_name == "max":
            return x.amax(dim=dims, keepdim=keepdims)
        if fn_name == "min":
            return x.amin(dim=dims, keepdim=keepdims)
        if fn_name == "prod":
            acc = None if x.is_floating_point() else _int_acc(x.dtype)
            for d in sorted(dims, reverse=True):
                x = x.prod(d, keepdim=keepdims)
            return x if acc is None else x.to(acc)
        raise ValueError(f"unknown reduction {fn_name!r}")

    def _reduce(self, node, x, fn_name, axes=None, pre=None):
        plan = self._reduce_plan(node, x, axes)
        if plan is self._REDUCE_NOOP:
            return x
        y = x if pre is None else pre(_math(x), x)
        keepdims = bool(node.attr("keepdims", 1))
        if _is_host(y):
            return getattr(np, fn_name)(y, axis=plan, keepdims=keepdims)
        return self._torch_reduce(fn_name, y, plan, keepdims)

    def op_ReduceMean(self, node, x, axes=None):
        return self._reduce(node, x, "mean", axes)

    def op_ReduceSum(self, node, x, axes=None):
        return self._reduce(node, x, "sum", axes)

    def op_ReduceMax(self, node, x, axes=None):
        return self._reduce(node, x, "max", axes)

    def op_ReduceMin(self, node, x, axes=None):
        return self._reduce(node, x, "min", axes)

    def op_ReduceProd(self, node, x, axes=None):
        return self._reduce(node, x, "prod", axes)

    def op_ReduceL1(self, node, x, axes=None):
        return self._reduce(node, x, "sum", axes, pre=lambda m, v: m.abs(v))

    def op_ReduceL2(self, node, x, axes=None):
        out = self._reduce(node, x, "sum", axes,
                           pre=lambda m, v: m.square(v))
        return out if out is x else _math(out).sqrt(out)

    def op_ReduceSumSquare(self, node, x, axes=None):
        return self._reduce(node, x, "sum", axes,
                            pre=lambda m, v: m.square(v))

    def op_ReduceLogSum(self, node, x, axes=None):
        out = self._reduce(node, x, "sum", axes)
        return out if out is x else _math(out).log(out)

    def op_ReduceLogSumExp(self, node, x, axes=None):
        """Max-subtracted: the ONNX value without overflow."""
        plan = self._reduce_plan(node, x, axes)
        if plan is self._REDUCE_NOOP:
            return x
        keepdims = bool(node.attr("keepdims", 1))
        if _is_host(x):
            peak = np.max(x, axis=plan, keepdims=True)
            out = np.log(np.sum(np.exp(x - peak), axis=plan,
                                keepdims=True)) + peak
            if not keepdims:
                out = np.squeeze(out, axis=plan) if plan is not None \
                    else np.reshape(out, ())
            return out
        peak = self._torch_reduce("max", x, plan, True)
        out = torch.log(self._torch_reduce("sum", torch.exp(x - peak), plan,
                                           True)) + peak
        if not keepdims:
            out = out.squeeze(plan) if plan is not None else out.reshape(())
        return out

    def _argreduce(self, node, x, fn_name):
        axis = node.attr("axis", 0)
        keepdims = bool(node.attr("keepdims", 1))
        if node.attr("select_last_index", 0):
            raise UnsupportedOnnxOp(f"{node.op_type} select_last_index=1")
        if _is_host(x):
            out = getattr(np, fn_name)(x, axis=axis)
            if keepdims:
                out = np.expand_dims(out, axis)
            return out.astype(np.int64)
        out = getattr(torch, fn_name)(x, dim=axis).to(torch.int32)
        return out.unsqueeze(axis) if keepdims else out

    def op_ArgMax(self, node, x):
        return self._argreduce(node, x, "argmax")

    def op_ArgMin(self, node, x):
        return self._argreduce(node, x, "argmin")

    # -- linear algebra ------------------------------------------------------

    def _int_layout(self, w: torch.Tensor, route: str) -> torch.Tensor:
        """``w`` laid out for an integer route, once per weight."""
        key = (id(w), route)
        hit = self._int_layouts.get(key)
        if hit is None or hit[0] is not w:
            layout = (int_mm_weight(w) if route == "matmul"
                      else prepare_int_conv_weight(w, route))
            hit = self._int_layouts[key] = (w, layout)
        return hit[1]

    def _int_matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Exact int32 product of integer ``a [..., K]`` and ``b``: int8
        ``[K, N]`` on the int8 routes, anything else (the zero-point shifted
        int32 operands of the quantized ops) in float64."""
        if a.dtype != torch.int8 or b.dtype != torch.int8 or b.ndim != 2:
            return wide_int_matmul(a, b)
        wb = self._int_layout(b, "matmul") if a.device.type == "cuda" else b
        out = int_matmul(a.reshape(-1, a.shape[-1]), wb, b.shape[1])
        return out.reshape(*a.shape[:-1], b.shape[1])

    def _int_conv(self, x, w, strides, pads, dilations, group):
        route = int_conv_route(tuple(x.shape), tuple(w.shape), strides, pads,
                               dilations, group, x.device.type)
        return int_conv(x, w, strides, pads, dilations, group, route=route,
                        prepared=self._int_layout(w, route))

    def op_MatMul(self, node, a, b):
        if _is_host(a) and _is_host(b):
            return np.matmul(a, b)
        a, b = self._mm_cast(_device_of(a, b), a, b)
        if not (a.is_floating_point() or b.is_floating_point()):
            # Integer operands: exact sums, float32 out (the JAX route's
            # preferred element type).
            return self._mm_out(self._int_matmul(a, b).float())
        return self._mm_out(self._contract(torch.matmul, a, b))

    def op_Gemm(self, node, a, b, c=None):
        if np.ndim(a) != 2 or np.ndim(b) != 2:
            raise UnsupportedOnnxOp(
                f"Gemm requires rank-2 inputs, got A rank {np.ndim(a)} and "
                f"B rank {np.ndim(b)} (node {node.name or node.op_type}; "
                "the graph is invalid per the ONNX spec)")
        alpha = node.attr("alpha", 1.0)
        beta = node.attr("beta", 1.0)
        if node.attr("transA", 0):
            a = a.T
        if node.attr("transB", 0):
            b = b.T
        if _is_host(a) and _is_host(b):
            out = alpha * np.matmul(a, b)
        else:
            a, b = self._mm_cast(_device_of(a, b), a, b)
            if not (a.is_floating_point() or b.is_floating_point()):
                out = alpha * self._int_matmul(a, b).float()
            else:
                out = alpha * self._contract(torch.matmul, a, b)
        if c is None:
            return out if _is_host(out) else self._mm_out(out)
        if _is_host(out):
            return out + beta * c
        # The bias joins on the device: a host-side product would be a new
        # array, copied (and synchronized) on every call.
        c = self._tensor(c, out.device)
        return self._mm_out(self.op_Add(node, out,
                                        c if beta == 1.0 else beta * c))

    # -- convolution ---------------------------------------------------------

    def _conv_params(self, node, x, w):
        spatial = np.ndim(x) - 2
        kernel = list(w.shape[2:])
        strides = list(node.attr("strides") or [1] * spatial)
        dilations = list(node.attr("dilations") or [1] * spatial)
        group = node.attr("group", 1)
        autopad = node.attr("auto_pad", b"NOTSET")
        pads_attr = node.attr("pads")
        if autopad in (b"SAME_UPPER", b"SAME_LOWER"):
            pads = _autopad_amounts(list(x.shape[2:]), kernel, strides,
                                    dilations, autopad)
        elif autopad == b"VALID" or pads_attr is None:
            pads = [(0, 0)] * spatial
        else:
            p = [int(v) for v in pads_attr]
            pads = list(zip(p[:spatial], p[spatial:]))
        return strides, pads, dilations, group

    def _bias(self, out, b, spatial: int):
        if b is None:
            return out
        # Reshaped on the device: the cached copy of a constant bias is
        # reused, where a host-side reshape would be copied every call.
        b = self._tensor(b, out.device).reshape((1, -1) + (1,) * spatial)
        return self.op_Add(None, out, b)

    def op_Conv(self, node, x, w, b=None):
        strides, pads, dilations, group = self._conv_params(node, x, w)
        spatial = np.ndim(x) - 2
        dev = _device_of(x, w, b)
        if (spatial == 1 and x.shape[1] == 1 and group == 1
                and dilations == [1] and w.shape[2] >= 256
                and pads == [(0, 0)]):
            # Conv1d-STFT form (single input channel, long kernel, big
            # stride: the unfused windowed DFT, Perch v2's framer).
            k, hop = w.shape[2], strides[0]
            if self.compute_dtype == torch.bfloat16:
                if not (stft_conv.kernel_requested()
                        and stft_conv.conv1d_kernel_fits(x.shape[2], k, hop,
                                                         w.shape[0])):
                    # BIRDA_STFT_KERNEL=gather, or a geometry the kernel
                    # does not take: the JAX package's composed route,
                    # decided from shapes alone.
                    stft_conv.count_route("conv1d_stft", "composed")
                    return self._conv1d_composed(dev, x, w, b, hop)
                # The hand-written kernel (bf16 operands, fp32 sums, bf16
                # [B, C, T] out); the bias joins after it in bf16, as on
                # the JAX package's kernel path.
                stft_conv.count_route("conv1d_stft", "kernel")
                layout = self._conv1d_layout(node.outputs[0], w, dev) \
                    if dev.type == "cuda" \
                    else None
                out = stft_conv.conv1d_stft(
                    self._tensor(x, dev)[:, 0, :],
                    self._tensor(w, dev)[:, 0, :], hop, prepared=layout)
                if b is not None:
                    out = out + self._tensor(b, dev, out.dtype).reshape(
                        1, -1, 1)
                return out
            # fp32: the JAX fp32 route's gather form.
            return self._conv1d_composed(dev, x, w, b, hop)
        x, w = self._mm_cast(dev, x, w)
        if x.is_floating_point() != w.is_floating_point():
            raise UnsupportedOnnxOp(
                f"Conv (node '{node.name}') of {x.dtype} input and {w.dtype} "
                "weight")
        if not x.is_floating_point():
            # Integer conv: exact int32 sums, no compute-dtype output cast,
            # as the JAX route's preferred_element_type=int32; int8 (the
            # int8 path) on its routes, wider integers in float64.
            if x.dtype == w.dtype == torch.int8:
                out = self._int_conv(x, w, strides, pads, dilations, group)
            else:
                out = wide_int_conv(x, w, strides, pads, dilations, group)
            return self._bias(out, b, spatial)
        lo = [p[0] for p in pads]
        hi = [p[1] for p in pads]
        if lo != hi:
            x = F.pad(x, [v for pair in reversed(pads) for v in pair])
            lo = [0] * spatial
        conv = (F.conv1d, F.conv2d, F.conv3d)[spatial - 1]
        out = self._contract(
            lambda a, k: conv(a, k, None, strides, lo, dilations, group),
            x, w)
        return self._mm_out(self._bias(out, b, spatial))

    def op_BirdaFusedMelFrontend(self, node, x, w, fb):
        """The fused spectrogram front-end spliced in by
        :func:`birda_tpu_torch.onnx.fuse.fuse_mel_frontend`: windowed-DFT conv,
        power, mel projection and log in one CUDA kernel
        (``ops/stft_conv.py::fused_logmel``). ``x`` is the conv input
        ``[B, 1, S]`` (the STFT-op spelling: ``[B, S]`` or ``[B, S, 1]``);
        the output ``[B, T, sum(mels)]`` is the chain's Log."""
        hop, eps = node.attr("hop"), node.attr("eps")
        dev = _device_of(x, w, fb)
        sig = self._tensor(x, dev)
        if node.attr("src", b"conv") == b"stft":
            sig = sig if sig.ndim == 2 else sig[:, :, 0]
        else:
            sig = sig[:, 0, :]
        wm = self._tensor(w, dev)[:, 0, :]
        (c, k), m = wm.shape, np.shape(fb)[1]
        if not (stft_conv.kernel_requested()
                and stft_conv.logmel_kernel_fits(sig.shape[-1], k, hop, c,
                                                 m)):
            # BIRDA_STFT_KERNEL=gather, or a geometry the kernel cannot
            # hold: the JAX package's composed route, decided from shapes
            # alone.
            stft_conv.count_route("fused_logmel", "composed")
            return self._logmel_composed(dev, sig, wm, fb, hop, eps)
        stft_conv.count_route("fused_logmel", "kernel")
        layout = self._logmel_layout(w, fb, dev) if dev.type == "cuda" \
            else None
        return stft_conv.fused_logmel(sig, wm, self._tensor(fb, dev),
                                      hop=hop, eps=eps, prepared=layout)

    def _conv1d_composed(self, dev, x, w, b, hop: int):
        """The JAX evaluator's gather-form Conv1d-STFT
        (``birda_tpu/onnx/lowering.py::op_Conv``'s composed branch) with its
        dtypes: compute-dtype frames (an unfold view) times the weight,
        summed in fp32, the bias added in fp32, one ``_mm_out`` cast."""
        xx, wm = self._mm_cast(dev, x[:, 0, :], w[:, 0, :])
        frames = xx.unfold(-1, wm.shape[1], hop)  # [B, T, k]
        out = torch.matmul(frames.float(), wm.float().T).transpose(1, 2)
        return self._mm_out(self._bias(out, b, 1))

    def _logmel_composed(self, dev, sig, wm, fb, hop: int, eps: float):
        """The JAX evaluator's composed log-mel
        (``birda_tpu/onnx/lowering.py::op_BirdaFusedMelFrontend``'s
        fallback) with its dtypes: the DFT of compute-dtype frames summed in
        fp32, the power from the re/im halves in fp32 and cast by
        ``_mm_out``, the mel product summed in fp32, ``log(mel + eps)`` and
        ``_mm_out``."""
        bins = wm.shape[0] // 2
        xx, wc = self._mm_cast(dev, sig, wm)
        frames = xx.unfold(-1, wc.shape[1], hop)  # [B, T, k]
        spec = torch.matmul(frames.float(), wc.float().T)
        re, im = spec[..., :bins], spec[..., bins:2 * bins]
        power, fbc = self._mm_cast(dev, self._mm_out(re * re + im * im), fb)
        mel = torch.matmul(power.float(), fbc.float())
        return self._mm_out(torch.log(mel + float(np.float32(eps))))

    def _conv1d_layout(self, out_name: str, w, device):
        """The Conv1d-STFT kernel's layout of the weight of the conv that
        writes ``out_name``, made once per weight."""
        key = (out_name, device)
        hit = self._conv1d_layouts.get(key)
        if hit is None or hit[0] is not w:
            layout = stft_conv.prepare_conv1d_weights(
                self._tensor(w, device)[:, 0, :])
            hit = self._conv1d_layouts[key] = (w, layout)
        return hit[1]

    def _logmel_layout(self, w, fb, device):
        """The kernel's layout of this front-end's weights, made once per
        (weight, filterbank) pair."""
        key = (id(w), id(fb), device)
        hit = self._logmel_layouts.get(key)
        if hit is None or hit[0] is not w or hit[1] is not fb:
            layout = stft_conv.prepare_logmel_weights(
                self._tensor(w, device)[:, 0, :], self._tensor(fb, device))
            hit = self._logmel_layouts[key] = (w, fb, layout)
        return hit[2]

    def op_ConvTranspose(self, node, x, w, b=None):
        """The JAX evaluator's transposed conv: float32 out, no compute-dtype
        cast; ``pads`` crop the output (the lhs-dilated lax conv it runs,
        as ``F.conv_transpose`` with no padding, cropped). ``output_padding``
        and ``output_shape`` are ignored there and here."""
        spatial = np.ndim(x) - 2
        strides = list(node.attr("strides") or [1] * spatial)
        dilations = list(node.attr("dilations") or [1] * spatial)
        group = node.attr("group", 1)
        p = [int(v) for v in (node.attr("pads") or [0] * (2 * spatial))]
        if group != 1:
            # lax reads an "IO" weight of [C_in, C_out/group] as C_in input
            # features per group: the JAX evaluator's conv fails there.
            raise ValueError(
                f"ConvTranspose group={group}: the JAX evaluator's lax conv "
                "takes no grouped transposed weight")
        dev = _device_of(x, w, b)
        xt, wt = (t.float() for t in self._promote(x, w, dev=dev))
        conv = (F.conv_transpose1d, F.conv_transpose2d,
                F.conv_transpose3d)[spatial - 1]
        out = self._contract(lambda a, k: conv(a, k, None, strides, 0, 0, 1,
                                               dilations), xt, wt)
        crop = [slice(None), slice(None)]
        for i in range(spatial):
            n = out.shape[2 + i]
            crop.append(slice(p[i], n - p[i + spatial]))
        out = out[tuple(crop)]
        if b is not None:
            out = self._binary(np.add, torch.add, out, self._tensor(
                b, dev).reshape((1, -1) + (1,) * spatial))
        return out

    def _pool(self, node, x, kind: str):
        """``lax.reduce_window`` over the spatial axes (``kind`` max, avg or
        sum), padding with the reduction's identity, as the JAX evaluator:
        each axis is padded, unfolded into windows of the dilated kernel at
        the stride, and reduced. ``ceil_mode`` extends the high padding to
        cover the last window ONNX keeps; average pooling divides by the
        count of real (or, with ``count_include_pad``, explicitly padded)
        elements in each window."""
        spatial = np.ndim(x) - 2
        kernel = list(node.attr("kernel_shape"))
        strides = list(node.attr("strides") or [1] * spatial)
        dilations = [int(d) for d in (node.attr("dilations")
                                      or [1] * spatial)]
        autopad = node.attr("auto_pad", b"NOTSET")
        pads_attr = node.attr("pads")
        if autopad in (b"SAME_UPPER", b"SAME_LOWER"):
            pads = _autopad_amounts(list(x.shape[2:]), kernel, strides,
                                    dilations, autopad)
        elif autopad == b"VALID" or pads_attr is None:
            pads = [(0, 0)] * spatial
        else:
            p = [int(v) for v in pads_attr]
            pads = list(zip(p[:spatial], p[spatial:]))
        base_pads = list(pads)
        if node.attr("ceil_mode", 0):
            # ONNX/ORT drop a last window that would start entirely in the
            # right padding (start >= d + pad_l).
            pads = []
            for d, k, s, dl, (pl, ph) in zip(
                    x.shape[2:], kernel, strides, dilations, base_pads):
                eff_k = (k - 1) * dl + 1
                n_out = -(-(d + pl + ph - eff_k) // s) + 1
                while n_out > 1 and (n_out - 1) * s >= d + pl:
                    n_out -= 1
                need = (n_out - 1) * s + eff_k - (d + pl)
                pads.append((pl, max(ph, need)))
        x = self._tensor(x, _device_of(x))

        def window(t, pad, fill, reduce):
            flat = [v for pair in reversed(pad) for v in pair]
            if any(flat):
                t = F.pad(t, flat, value=fill)
            for i, (k, s, dl) in enumerate(zip(kernel, strides, dilations)):
                t = t.unfold(2 + i, (k - 1) * dl + 1, s)
                if dl > 1:
                    t = t[..., ::dl]
            dims = tuple(range(t.ndim - spatial, t.ndim))
            return t.amax(dim=dims) if reduce == "max" else t.sum(dim=dims)

        if kind == "max":
            return window(x, pads, -float("inf"), "max")
        out = window(x, pads, 0.0, "sum")
        if kind == "sum":
            return out
        ones = torch.ones(x.shape, dtype=x.dtype, device=x.device)
        if node.attr("count_include_pad", 0):
            # The explicit padding counts, the ceil-mode extension does not.
            ones = F.pad(ones, [v for pair in reversed(base_pads)
                                for v in pair], value=1.0)
            extra = [(0, ph - bh) for (_, ph), (_, bh) in zip(pads,
                                                                base_pads)]
            counts = window(ones, extra, 0.0, "sum")
        else:
            counts = window(ones, pads, 0.0, "sum")
        return out / counts

    def op_MaxPool(self, node, x):
        if sum(1 for o in node.outputs if o) > 1:
            raise UnsupportedOnnxOp(
                "MaxPool with an Indices output is not supported")
        return self._pool(node, x, "max")

    def op_AveragePool(self, node, x):
        return self._pool(node, x, "avg")

    def op_GlobalAveragePool(self, node, x):
        axes = tuple(range(2, np.ndim(x)))
        if _is_host(x):
            return np.mean(x, axis=axes, keepdims=True)
        return self._mean(x, axes, True)

    def op_GlobalMaxPool(self, node, x):
        axes = tuple(range(2, np.ndim(x)))
        if _is_host(x):
            return np.max(x, axis=axes, keepdims=True)
        return x.amax(dim=axes, keepdim=True)

    # -- quantization --------------------------------------------------------
    #
    # Both quantized-graph styles of the ONNX Runtime quantizer: QDQ
    # (QuantizeLinear/DequantizeLinear pairs around float ops) and QOperator
    # (QLinearConv/QLinearMatMul and the com.microsoft QLinear* ops), with
    # the JAX evaluator's semantics: quantize = saturate(round_half_even(
    # x / scale) + zero_point); integer products accumulate exactly, and the
    # ops around a float intermediate dequantize, compute in float and
    # requantize.

    @staticmethod
    def _q_axis_shape(x_ndim: int, axis: int) -> tuple:
        shape = [1] * x_ndim
        shape[axis % x_ndim] = -1
        return tuple(shape)

    def _per_axis(self, arr, x_ndim: int, axis: int):
        """A per-axis host scale or zero point reshaped to broadcast along
        ``axis``; scalars (and device values) pass unchanged."""
        if arr is None:
            return None
        if _is_host(arr) and np.asarray(arr).size > 1:
            return np.asarray(arr).reshape(self._q_axis_shape(x_ndim, axis))
        return arr

    def _per_axis_tensor(self, arr, dev, x_ndim: int, axis: int):
        """:meth:`_per_axis` for a device operand: the host constant is
        copied once and reshaped on the device."""
        if arr is None or not (_is_host(arr) and np.asarray(arr).size > 1):
            return arr
        return self._tensor(arr, dev).reshape(
            self._q_axis_shape(x_ndim, axis))

    def _quantize(self, x, scale, zp, node, default_dtype=np.uint8):
        dt = np.asarray(zp).dtype if zp is not None and _is_host(zp) \
            else np.dtype(default_dtype)
        info = np.iinfo(dt)
        ndim = getattr(x, "ndim", 0)
        axis = node.attr("axis", 1)
        if _all_host(x, scale, zp):
            scale = self._per_axis(scale, ndim, axis)
            zp = self._per_axis(zp, ndim, axis)
            q = np.round(x / scale) + (0 if zp is None else zp)
            return np.clip(q, info.min, info.max).astype(dt)
        dev = _device_of(x, scale, zp)
        scale = self._per_axis_tensor(scale, dev, ndim, axis)
        zp = self._per_axis_tensor(zp, dev, ndim, axis)
        q = torch.round(self._binary(np.divide, torch.div, x, scale))
        if zp is not None:
            q = self._binary(np.add, torch.add, q, zp)
        return torch.clamp(q, info.min, info.max).to(_DEVICE_DTYPE[dt])

    def _dequantize(self, x, scale, zp, node):
        ndim = getattr(x, "ndim", 0)
        axis = node.attr("axis", 1)
        if _all_host(x, scale, zp):
            def host():
                s = self._per_axis(scale, ndim, axis)
                z = self._per_axis(zp, ndim, axis)
                zf = 0.0 if z is None else np.asarray(z, np.float32)
                return (np.asarray(x, np.float32) - zf) * s

            # Once for a constant operand of a QLinear* node.
            return self._memo(("dequantize", id(node), id(x)),
                              (x, scale, zp), host)
        dev = _device_of(x, scale, zp)
        scale = self._per_axis_tensor(scale, dev, ndim, axis)
        zp = self._per_axis_tensor(zp, dev, ndim, axis)
        xf = self._tensor(x, dev).float()
        zf = 0.0 if zp is None else self._tensor(zp, dev).float()
        return self._binary(np.multiply, torch.mul, xf - zf, scale)

    def op_QuantizeLinear(self, node, x, scale, zp=None):
        return self._quantize(x, scale, zp, node)

    def op_DequantizeLinear(self, node, x, scale, zp=None):
        return self._dequantize(x, scale, zp, node)

    def op_DynamicQuantizeLinear(self, node, x):
        qmin, qmax = 0.0, 255.0
        if _is_host(x):
            lo = np.minimum(np.min(x), 0.0)
            hi = np.maximum(np.max(x), 0.0)
            scale = (hi - lo) / (qmax - qmin)
            zp_f = np.clip(np.round(qmin - lo / scale), qmin, qmax)
            q = np.clip(np.round(x / scale) + zp_f, qmin, qmax).astype(
                np.uint8)
            return q, scale.astype(np.float32), zp_f.astype(np.uint8)
        lo = torch.clamp_max(x.amin(), 0.0)
        hi = torch.clamp_min(x.amax(), 0.0)
        scale = _true_div(hi - lo, qmax - qmin)
        zp_f = torch.clamp(torch.round(qmin - lo / scale), qmin, qmax)
        q = torch.clamp(torch.round(x / scale) + zp_f, qmin, qmax)
        return (q.to(torch.uint8), scale.to(torch.float32),
                zp_f.to(torch.uint8))

    def _as_i32(self, x, zp):
        """Zero-point-shifted int32 view of a quantized tensor."""
        if _all_host(x, zp):
            xi = np.asarray(x, np.int32)
            return xi if zp is None else xi - np.asarray(zp, np.int32)
        dev = _device_of(x, zp)
        xi = self._tensor(x, dev).to(torch.int32)
        return xi if zp is None else xi - self._tensor(zp, dev).to(
            torch.int32)

    def _requantize(self, accf, scale, y_zp):
        """``saturate(round(acc * scale) + y_zp)`` at y_zp's dtype (uint8
        when absent)."""
        dt = np.asarray(y_zp).dtype if y_zp is not None and _is_host(y_zp) \
            else np.dtype(np.uint8)
        info = np.iinfo(dt)
        m = _math(accf, scale, y_zp)
        q = m.round(self._binary(np.multiply, torch.mul, accf, scale))
        q = self._binary(np.add, torch.add, q, 0 if y_zp is None else y_zp)
        if m is np:
            return np.clip(q, info.min, info.max).astype(dt)
        return torch.clamp(q, info.min, info.max).to(_DEVICE_DTYPE[dt])

    def _shifted_weight(self, node, w, w_zp):
        """The zero-point-shifted int32 conv weight (per-output-channel
        zero points on axis 0), made once for a constant weight."""
        wndim = np.ndim(w)
        if isinstance(w, torch.Tensor) and w_zp is not None:
            return self._as_i32(w, self._per_axis_tensor(w_zp, w.device,
                                                         wndim, 0))
        return self._memo(("shift", id(node)), (w, w_zp),
                          lambda: self._as_i32(w, self._per_axis(w_zp,
                                                                 wndim, 0)))

    def op_QLinearConv(self, node, x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp,
                       b=None):
        """Integer-exact, as ONNX Runtime computes it: the conv of the
        zero-point-shifted int32 values with an int32 accumulator (float64
        products, :func:`wide_int_conv`), the int32 bias, then the combined
        scale ``x_s * w_s / y_s`` (``w_s`` per output channel or not) and
        the requantize. The bias and the scale broadcast as 4-D (NCHW), as
        the JAX evaluator's do."""
        xi = self._as_i32(x, x_zp)
        wi = self._shifted_weight(node, w, w_zp)
        with self._no_compute_cast():
            acc = self.op_Conv(node, xi, wi, None)
        if b is not None:
            if _is_host(acc):
                acc = acc + np.asarray(b, np.int32).reshape(1, -1, 1, 1)
            else:
                acc = acc + self._tensor(b, acc.device).to(
                    torch.int32).reshape(1, -1, 1, 1)
        ws = self._per_axis(w_s, 4, 1)
        if _is_host(x_s) and _is_host(w_s) and _is_host(y_s):
            scale = self._memo(("scale", id(node)), (x_s, w_s, y_s),
                               lambda: np.asarray(
                np.asarray(x_s, np.float32) * np.asarray(ws, np.float32)
                / np.asarray(y_s, np.float32)))
        else:
            scale = self._binary(np.divide, torch.div, self._binary(
                np.multiply, torch.mul, x_s, ws), y_s)
        accf = acc.astype(np.float32) if _is_host(acc) else acc.float()
        return self._requantize(accf, scale, y_zp)

    def op_QLinearMatMul(self, node, a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp):
        """Exact int32 accumulation of the shifted operands; the host fold
        requantizes in float64, the device one in float32 (as the JAX
        evaluator does, numpy on the host and jnp on the device)."""
        ai = self._as_i32(a, a_zp)
        bi = self._memo(("shift", id(node)), (b, b_zp),
                        lambda: self._as_i32(b, b_zp))
        if _is_host(ai) and _is_host(bi):
            accf = np.matmul(ai.astype(np.int64),
                             bi.astype(np.int64)).astype(np.float64)
        else:
            dev = _device_of(ai, bi)
            accf = wide_int_matmul(self._tensor(ai, dev),
                                   self._tensor(bi, dev)).float()
        if _is_host(a_s) and _is_host(b_s) and _is_host(y_s):
            scale = self._memo(("scale", id(node)), (a_s, b_s, y_s),
                               lambda: np.asarray(
                np.float64(a_s) * np.float64(b_s) / np.float64(y_s)))
        else:
            scale = self._binary(np.divide, torch.div, self._binary(
                np.multiply, torch.mul, a_s, b_s), y_s)
        return self._requantize(accf, scale, y_zp)

    def op_MatMulInteger(self, node, a, b, a_zp=None, b_zp=None):
        ai = self._memo(("shift_a", id(node)), (a, a_zp),
                        lambda: self._as_i32(a, a_zp))
        bi = self._memo(("shift_b", id(node)), (b, b_zp),
                        lambda: self._as_i32(b, b_zp))
        if _is_host(ai) and _is_host(bi):
            return np.matmul(ai, bi).astype(np.int32)
        dev = _device_of(ai, bi)
        return wide_int_matmul(self._tensor(ai, dev), self._tensor(bi, dev))

    def op_ConvInteger(self, node, x, w, x_zp=None, w_zp=None):
        xi = self._as_i32(x, x_zp)
        wi = self._shifted_weight(node, w, w_zp)
        with self._no_compute_cast():
            return self.op_Conv(node, xi, wi, None)

    def _qlinear_binary(self, node, np_fn, torch_fn, a, a_s, a_zp, b, b_s,
                        b_zp, y_s, y_zp):
        af = self._dequantize(a, a_s, a_zp, node)
        bf = self._dequantize(b, b_s, b_zp, node)
        return self._quantize(self._binary(np_fn, torch_fn, af, bf), y_s,
                              y_zp, node)

    def op_QLinearAdd(self, node, a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp):
        return self._qlinear_binary(node, np.add, torch.add, a, a_s, a_zp,
                                    b, b_s, b_zp, y_s, y_zp)

    def op_QLinearMul(self, node, a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp):
        return self._qlinear_binary(node, np.multiply, torch.mul, a, a_s,
                                    a_zp, b, b_s, b_zp, y_s, y_zp)

    def op_QLinearSigmoid(self, node, x, x_s, x_zp, y_s, y_zp):
        xf = self._dequantize(x, x_s, x_zp, node)
        return self._quantize(self.op_Sigmoid(node, xf), y_s, y_zp, node)

    def op_QLinearLeakyRelu(self, node, x, x_s, x_zp, y_s, y_zp):
        xf = self._dequantize(x, x_s, x_zp, node)
        return self._quantize(self.op_LeakyRelu(node, xf), y_s, y_zp, node)

    def op_QLinearSoftmax(self, node, x, x_s, x_zp, y_s, y_zp):
        xf = self._dequantize(x, x_s, x_zp, node)
        return self._quantize(self.op_Softmax(node, xf), y_s, y_zp, node)

    def op_QLinearAveragePool(self, node, x, x_s, x_zp, y_s, y_zp):
        if node.attr("channels_last", 0):
            raise UnsupportedOnnxOp("QLinearAveragePool channels_last=1")
        xf = self._dequantize(x, x_s, x_zp, node)
        return self._quantize(self.op_AveragePool(node, xf), y_s, y_zp, node)

    def op_QLinearConcat(self, node, y_s, y_zp, *parts):
        """Variadic (tensor, scale, zero point) triples after the output
        scale and zero point (the com.microsoft spelling)."""
        if len(parts) % 3:
            raise UnsupportedOnnxOp("QLinearConcat malformed inputs")
        des = [self._dequantize(parts[i], parts[i + 1], parts[i + 2], node)
               for i in range(0, len(parts), 3)]
        return self._quantize(self.op_Concat(node, *des), y_s, y_zp, node)

    def op_QGemm(self, node, a, a_s, a_zp, b, b_s, b_zp, c=None,
                 y_s=None, y_zp=None):
        """com.microsoft QGemm: the dequantized product (a float32 matmul),
        an int32 bias at scale ``a_s * b_s``; a float output when
        ``y_scale`` is absent."""
        af = self._dequantize(a, a_s, a_zp, node)
        if node.attr("transA", 0):
            af = af.T
        if node.attr("transB", 0):
            # Transpose the quantized B first, so a per-output-channel
            # b_scale lands on axis 1 of the [K, N] operand.
            b = b.T if not _is_host(b) else self._memo(
                ("transB", id(node)), (b,), lambda: np.transpose(b))
        bf = self._dequantize(b, b_s, b_zp, node)
        alpha = node.attr("alpha", 1.0)
        if _is_host(af) and _is_host(bf):
            out = alpha * (af @ bf)
        else:
            af, bf = self._promote(af, bf, uniform=True)
            out = alpha * torch.matmul(af, bf)
        if c is not None:
            def bias():
                cf = np.asarray(c, np.float32) if _is_host(c) \
                    else c.to(torch.float32)
                return self._binary(np.multiply, torch.mul, self._binary(
                    np.multiply, torch.mul, cf, a_s), b_s)

            out = self._binary(np.add, torch.add, out, self._memo(
                ("bias", id(node)), (c, a_s, b_s), bias))
        if y_s is None:
            return out
        return self._quantize(out, y_s, y_zp, node)

    def op_QLinearGlobalAveragePool(self, node, x, x_s, x_zp, y_s, y_zp):
        xf = self._dequantize(x, x_s, x_zp, node)
        nd = np.ndim(xf)
        axes = (tuple(range(1, nd - 1)) if node.attr("channels_last", 0)
                else tuple(range(2, nd)))
        y = np.mean(xf, axis=axes, keepdims=True) if _is_host(xf) \
            else self._mean(xf, axes, True)
        return self._quantize(y, y_s, y_zp, node)

    # -- signal --------------------------------------------------------------

    def op_DFT(self, node, x, dft_length=None, axis=None):
        """ONNX DFT as a library FFT in float32 (cuFFT on the card), the
        JAX evaluator's semantics: the real part of a ``[..., 1|2]`` input,
        ``axis`` from the input (opset 20) else the attribute, ``[..., 2]``
        real/imaginary float32 out."""
        onesided = node.attr("onesided", 0)
        inverse = node.attr("inverse", 0)
        ax = int(np.asarray(axis).reshape(())) if axis is not None \
            else node.attr("axis", 1)
        if inverse:
            raise UnsupportedOnnxOp("inverse DFT not supported")
        n = int(np.asarray(dft_length).reshape(())) \
            if dft_length is not None else None
        xr = x[..., 0] if x.shape[-1] in (1, 2) else x
        if _is_host(xr):
            xr = np.asarray(xr)
            out = np.fft.rfft(xr, n=n, axis=ax) if onesided \
                else np.fft.fft(xr, n=n, axis=ax)
            return np.stack([out.real, out.imag], axis=-1).astype(np.float32)
        if xr.dtype not in (torch.float32, torch.float64):
            xr = xr.float()  # the FFT takes no bf16, as in jax
        out = torch.fft.rfft(xr, n=n, dim=ax) if onesided \
            else torch.fft.fft(xr, n=n, dim=ax)
        return torch.view_as_real(out).float()

    def op_STFT(self, node, signal, frame_step, window=None,
                frame_length=None):
        """Opset-17 STFT: frames at ``frame_step`` (an unfold view), times
        the window, a one-sided real FFT of each; ``[B, frames, bins, 2]``
        float32. Not the Conv1d-STFT kernel: the JAX evaluator's STFT is a
        plain framed FFT."""
        if not node.attr("onesided", 1):
            raise UnsupportedOnnxOp("STFT onesided=0")
        if np.ndim(signal) == 3:
            if signal.shape[-1] != 1:
                raise UnsupportedOnnxOp("STFT on complex signals")
            signal = signal[..., 0]
        step = int(np.asarray(self._host_value(
            node, frame_step, "frame_step")).reshape(()))
        if window is not None:
            w_len = int(window.shape[-1])
        elif frame_length is not None:
            w_len = int(np.asarray(self._host_value(
                node, frame_length, "frame_length")).reshape(()))
        else:
            raise UnsupportedOnnxOp("STFT needs window or frame_length")
        dev = _device_of(signal, window)
        sig = self._tensor(signal, dev)
        if sig.dtype not in (torch.float32, torch.float64):
            sig = sig.float()
        frames = sig.unfold(-1, w_len, step)
        if window is not None:
            frames = frames * self._tensor(window, dev, frames.dtype)
        return torch.view_as_real(torch.fft.rfft(frames, dim=-1)).float()

    def _cosine_window(self, node, size, a0, a1, a2):
        """Opset-17 generalized-cosine window: a host constant."""
        n = int(np.asarray(self._host_value(node, size, "size")).reshape(()))
        dt = _NP_DTYPES.get(node.attr("output_datatype", 1))
        if dt is None:
            raise UnsupportedOnnxOp(
                f"{node.op_type} output_datatype "
                f"{node.attr('output_datatype')} is not supported")
        denom = n if node.attr("periodic", 1) else n - 1
        if denom <= 0:  # single-sample symmetric window
            return np.ones(n, dt)
        x = 2.0 * np.pi * np.arange(n, dtype=np.float64) / denom
        return (a0 - a1 * np.cos(x) + a2 * np.cos(2.0 * x)).astype(dt)

    def op_HannWindow(self, node, size):
        return self._cosine_window(node, size, 0.5, 0.5, 0.0)

    def op_HammingWindow(self, node, size):
        # ONNX pins the exact rational coefficients (not torch's 0.54).
        return self._cosine_window(node, size, 25.0 / 46.0, 21.0 / 46.0, 0.0)

    def op_BlackmanWindow(self, node, size):
        return self._cosine_window(node, size, 0.42, 0.5, 0.08)

    def op_MelWeightMatrix(self, node, num_mel_bins, dft_length, sample_rate,
                           lower_edge_hertz, upper_edge_hertz):
        """Opset-17 mel filterbank, a host constant, by the ONNX spec's
        algorithm: mel(f) = 2595 log10(1 + f/700), num_mel_bins + 2 edges
        equally spaced in mel and snapped to DFT bins, triangles between."""
        bins, n_dft, sr, lo, hi = (
            cast(np.asarray(self._host_value(node, v, "a mel parameter"))
                 .reshape(()))
            for cast, v in ((int, num_mel_bins), (int, dft_length),
                            (int, sample_rate), (float, lower_edge_hertz),
                            (float, upper_edge_hertz)))
        dt = _NP_DTYPES.get(node.attr("output_datatype", 1))
        if dt is None:
            raise UnsupportedOnnxOp(
                "MelWeightMatrix output_datatype "
                f"{node.attr('output_datatype')} is not supported")
        n_spec = n_dft // 2 + 1
        mel_lo = 2595.0 * np.log10(1.0 + lo / 700.0)
        mel_hi = 2595.0 * np.log10(1.0 + hi / 700.0)
        edges = np.arange(bins + 2, dtype=np.float64)
        edges = edges * (mel_hi - mel_lo) / (bins + 2) + mel_lo
        hz = 700.0 * (np.power(10.0, edges / 2595.0) - 1.0)
        freq_bin = ((n_dft + 1) * hz // sr).astype(np.int64)
        out = np.zeros((n_spec, bins), np.float64)
        for i in range(bins):
            left, center, right = freq_bin[i], freq_bin[i + 1], freq_bin[i + 2]
            if center - left == 0:
                out[center, i] = 1.0
            else:
                for j in range(left, center + 1):
                    out[j, i] = (j - left) / float(center - left)
            if right - center > 0:
                for j in range(center, right):
                    out[j, i] = (right - j) / float(right - center)
        return out.astype(dt)

    # -- normalization -------------------------------------------------------

    def op_BatchNormalization(self, node, x, scale, bias, mean, var):
        eps = node.attr("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (np.ndim(x) - 2)
        if all(_is_host(v) for v in (scale, bias, mean, var)):
            # Host-folded once per node: the constants never change.
            key = (id(scale), id(bias), id(mean), id(var))
            fold = self._bn_folds.get(node.name)
            if fold is None or fold[0] != key:
                inv = np.reshape(scale, shape) / np.sqrt(
                    np.reshape(var, shape) + eps)
                shift = np.reshape(bias, shape) - np.reshape(mean, shape) * inv
                fold = self._bn_folds[node.name] = (key, inv, shift)
                self._persistent.update((id(inv), id(shift)))
            _, inv, shift = fold
        else:
            def r(v):
                return np.reshape(v, shape) if _is_host(v) \
                    else v.reshape(shape)

            inv = self.op_Div(node, r(scale),
                              self.op_Sqrt(node, self.op_Add(node, r(var),
                                                             eps)))
            shift = self.op_Sub(node, r(bias), self.op_Mul(node, r(mean), inv))
        return self.op_Add(node, self.op_Mul(node, x, inv), shift)


    def op_LayerNormalization(self, node, x, scale, bias=None):
        axis = node.attr("axis", -1)
        eps = node.attr("epsilon", 1e-5)
        axes = tuple(range(axis % x.ndim, x.ndim))
        if _is_host(x):
            mu = np.mean(x, axis=axes, keepdims=True)
            var = np.mean((x - mu) ** 2, axis=axes, keepdims=True)
            out = (x - mu) / np.sqrt(var + eps) * scale
            return out if bias is None else out + bias
        mu = self._mean(x, axes, True)
        d = x - mu
        var = self._mean(d * d, axes, True)
        out = self._binary(np.multiply, torch.mul, d / torch.sqrt(var + eps),
                           scale)
        return out if bias is None else self._binary(np.add, torch.add, out,
                                                     bias)

    def op_InstanceNormalization(self, node, x, scale, bias):
        eps = node.attr("epsilon", 1e-5)
        axes = tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if _is_host(x) and _is_host(scale) and _is_host(bias):
            mu = np.mean(x, axis=axes, keepdims=True)
            var = np.mean((x - mu) ** 2, axis=axes, keepdims=True)
            return (x - mu) / np.sqrt(var + eps) * np.reshape(scale, shape) \
                + np.reshape(bias, shape)
        dev = _device_of(x, scale, bias)
        x = self._tensor(x, dev)
        mu = self._mean(x, axes, True)
        d = x - mu
        var = self._mean(d * d, axes, True)
        out = self._binary(np.multiply, torch.mul, d / torch.sqrt(var + eps),
                           self._tensor(scale, dev).reshape(shape))
        return self._binary(np.add, torch.add, out,
                            self._tensor(bias, dev).reshape(shape))

    def op_LRN(self, node, x):
        """Across-channel sum of squares over ``size`` channels (padded with
        zeros), ``x / (bias + alpha * sum / size) ** beta``."""
        alpha = node.attr("alpha", 1e-4)
        beta = node.attr("beta", 0.75)
        bias = node.attr("bias", 1.0)
        size = node.attr("size")
        x = self._tensor(x, _device_of(x))
        half = size // 2
        sq = F.pad(x * x, [0, 0] * (x.ndim - 2) + [half, size - 1 - half])
        sums = sq.unfold(1, size, 1).sum(dim=-1)
        return x / torch.pow(bias + _true_div(alpha * sums, size), beta)

    def op_Gelu(self, node, x):
        """``jax.nn.gelu``: the exact form through erfc, or the tanh form
        (``approximate="tanh"``), each constant at the input's dtype."""
        approx = node.attr("approximate", b"none")
        if _is_host(x):
            from scipy.special import erf as _erf

            return (x * 0.5 * (1.0 + _erf(np.asarray(x) / np.sqrt(2.0)))
                    ).astype(np.asarray(x).dtype)
        if not x.is_floating_point():
            x = x.float()

        def const(v):
            return float(torch.tensor(v, dtype=torch.float64).to(x.dtype))

        if approx == b"tanh":
            cdf = 0.5 * (1.0 + torch.tanh(const(np.sqrt(2 / np.pi)) * (
                x + 0.044715 * (x * x * x))))
            return x * cdf
        return _gelu_exact(x)

    def op_Sign(self, node, x):
        return _math(x).sign(x)

    def op_Round(self, node, x):
        # ONNX Round is round-half-to-even, as numpy's and torch's.
        return _math(x).round(x)

    def op_CumSum(self, node, x, axis):
        ax = int(np.asarray(self._host_value(node, axis, "axis")).reshape(()))
        if node.attr("exclusive", 0) or node.attr("reverse", 0):
            raise UnsupportedOnnxOp("CumSum exclusive/reverse not supported")
        if _is_host(x):
            return np.cumsum(x, axis=ax)
        if x.is_floating_point():
            return torch.cumsum(x, dim=ax)
        return torch.cumsum(x, dim=ax).to(_int_acc(x.dtype))

    def op_TopK(self, node, x, k):
        """The ``k`` largest along ``axis``, ties in index order (the lower
        index first, as ``lax.top_k`` ranks them): a stable descending
        sort, which ``torch.topk`` does not promise on the card."""
        k = int(np.asarray(self._host_value(node, k, "k")).reshape(-1)[0])
        axis = node.attr("axis", -1)
        if not node.attr("largest", 1):
            raise UnsupportedOnnxOp("TopK with largest=0")
        if _is_host(x):
            xs = np.moveaxis(np.asarray(x), axis, -1)
            idx = np.argsort(-xs, axis=-1)[..., :k]
            vals = np.take_along_axis(xs, idx, axis=-1)
            return (np.moveaxis(vals, -1, axis),
                    np.moveaxis(idx.astype(np.int64), -1, axis))
        vals, idx = torch.sort(x.movedim(axis, -1), dim=-1, descending=True,
                               stable=True)
        return (vals[..., :k].movedim(-1, axis),
                idx[..., :k].to(torch.int32).movedim(-1, axis))

    @staticmethod
    def _resize_coords(ct: str, d_in: int, d_out: int, scale: float):
        """ONNX output->input coordinate map for one axis, on the host."""
        i = np.arange(d_out, dtype=np.float64)
        if ct == "half_pixel":
            return (i + 0.5) / scale - 0.5
        if ct == "pytorch_half_pixel":
            return (i + 0.5) / scale - 0.5 if d_out > 1 else np.zeros(1)
        if ct == "asymmetric":
            return i / scale
        if ct == "align_corners":
            if d_out == 1:
                return np.zeros(1)
            return i * ((d_in - 1) / (d_out - 1))
        if ct == "tf_half_pixel_for_nn":
            return (i + 0.5) / scale
        raise UnsupportedOnnxOp(
            f"Resize coordinate_transformation_mode '{ct}'")

    def _gather_axis(self, x, idx: np.ndarray, axis: int):
        """``x`` at host indices ``idx`` (all in range) along ``axis``;
        ``idx`` is a fold of :meth:`_memo`, so its device copy is made
        once."""
        if _is_host(x):
            return np.take(x, idx, axis=axis)
        return x.index_select(axis, self._tensor(idx, x.device))

    def _resize(self, node, x, out_shape, sc, mode: str, ct: str,
                nm: str | None = None):
        """Shared Resize/Upsample body: per-axis gathers (nearest) and
        two-point lerps (linear) at host-computed indices and weights, and
        ``jax.image.resize``'s Keys cubic (cubic). ``nm`` overrides the
        node's nearest_mode (legacy opset-10 Resize rounds down)."""
        if mode == "nearest":
            if nm is None:
                nm = node.attr("nearest_mode", b"round_prefer_floor")
                nm = nm.decode() if isinstance(nm, bytes) else nm
            out = x
            for ax, (d_in, d_out) in enumerate(zip(x.shape, out_shape)):
                if d_in == d_out:
                    continue
                scale = float(sc[ax]) if sc is not None else d_out / d_in
                idx = self._memo(
                    ("resize", id(node), ax, d_in, d_out, scale, ct, nm), [],
                    lambda d_in=d_in, d_out=d_out, scale=scale:
                    self._nearest_indices(ct, nm, d_in, d_out, scale))
                out = self._gather_axis(out, idx, ax)
            return out
        if mode in ("linear", "bilinear"):
            out = x
            for ax, (d_in, d_out) in enumerate(zip(x.shape, out_shape)):
                if d_in == d_out:
                    continue
                scale = float(sc[ax]) if sc is not None else d_out / d_in
                lo_i, hi_i, w_lo, w_hi = self._memo(
                    ("resize", id(node), ax, d_in, d_out, scale, ct,
                     out.ndim), [],
                    lambda ax=ax, d_in=d_in, d_out=d_out, scale=scale:
                    self._linear_taps(ct, d_in, d_out, scale, ax, out.ndim))
                a = self._gather_axis(out, lo_i, ax)
                b = self._gather_axis(out, hi_i, ax)
                out = self._binary(
                    np.add, torch.add,
                    self._binary(np.multiply, torch.mul, a, w_lo),
                    self._binary(np.multiply, torch.mul, b, w_hi))
            return out
        if mode == "cubic":
            if ct != "half_pixel":
                raise UnsupportedOnnxOp(
                    f"Resize cubic with coordinate mode '{ct}'")
            return self._keys_cubic(x, out_shape)
        raise UnsupportedOnnxOp(f"Resize mode {mode}")

    def _nearest_indices(self, ct, nm, d_in, d_out, scale) -> np.ndarray:
        """The source index of each output position of a nearest resize."""
        coord = self._resize_coords(ct, d_in, d_out, scale)
        if nm == "round_prefer_floor":
            idx = np.ceil(coord - 0.5)
        elif nm == "round_prefer_ceil":
            idx = np.floor(coord + 0.5)
        elif nm == "floor":
            idx = np.floor(coord)
        elif nm == "ceil":
            idx = np.ceil(coord)
        else:
            raise UnsupportedOnnxOp(f"Resize nearest_mode '{nm}'")
        return np.clip(idx, 0, d_in - 1).astype(np.int64)

    def _linear_taps(self, ct, d_in, d_out, scale, ax, ndim) -> tuple:
        """The two source indices of each output position of a linear
        resize along ``ax`` and their weights, shaped to broadcast."""
        coord = self._resize_coords(ct, d_in, d_out, scale)
        lo = np.floor(coord)
        w = (coord - lo).astype(np.float32)
        lo_i = np.clip(lo, 0, d_in - 1).astype(np.int64)
        hi_i = np.clip(lo + 1, 0, d_in - 1).astype(np.int64)
        wshape = [1] * ndim
        wshape[ax] = d_out
        w = w.reshape(wshape)
        return lo_i, hi_i, 1.0 - w, w

    def _keys_cubic(self, x, out_shape):
        """``jax.image.resize(x, out_shape, "bicubic")``: Keys' cubic
        (a = -0.5) at half-pixel centres, antialiased when downsampling, one
        weight matrix per resized axis (float32, as jax computes it)."""
        x = self._tensor(x, _device_of(x))
        if not x.is_floating_point():
            x = x.float()
        for d, (n_in, n_out) in enumerate(zip(x.shape, out_shape)):
            if n_in == n_out:
                continue
            w = self._memo(("keys", n_in, n_out), [],
                           lambda n_in=n_in, n_out=n_out:
                           self._keys_weights(n_in, n_out))
            wt = self._tensor(w, x.device, x.dtype)
            x = torch.tensordot(x, wt, dims=([d], [0])).movedim(-1, d)
        return x

    @staticmethod
    def _keys_weights(n_in: int, n_out: int) -> np.ndarray:
        """The ``[n_in, n_out]`` float32 weights of one axis of
        :meth:`_keys_cubic`."""
        scale = 1.0 if n_out == 0 else n_out / n_in
        inv = np.float32(1.0 / scale)
        kscale = max(inv, np.float32(1.0))
        sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
            * inv - np.float32(0.0) * inv - np.float32(0.5)
        t = np.abs(sample[None, :] - np.arange(
            n_in, dtype=np.float32)[:, None]) / kscale
        w = ((np.float32(1.5) * t - np.float32(2.5)) * t) * t \
            + np.float32(1.0)
        w = np.where(t >= 1.0, ((np.float32(-0.5) * t + np.float32(2.5))
                                * t - np.float32(4.0)) * t
                     + np.float32(2.0), w)
        w = np.where(t >= 2.0, np.float32(0.0), w).astype(np.float32)
        total = w.sum(axis=0, keepdims=True)
        w = np.where(np.abs(total) > 1000.0 * float(np.finfo(
            np.float32).eps), w / np.where(total != 0, total, 1), 0)
        return np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :],
                        w, 0).astype(np.float32)

    def op_Resize(self, node, x, roi=None, scales=None, sizes=None):
        legacy = bool(self.opset and self.opset < 11)
        if legacy and scales is None and sizes is None and roi is not None:
            # Opset-10 spelling: Resize(X, scales).
            scales, roi = roi, None
        mode = node.attr("mode", b"nearest")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if legacy:
            # Resize-10 is Upsample's: asymmetric, floor rounding.
            ct = "asymmetric"
        else:
            ct = node.attr("coordinate_transformation_mode", b"half_pixel")
            ct = ct.decode() if isinstance(ct, bytes) else ct
        if ct == "tf_crop_and_resize":
            raise UnsupportedOnnxOp("Resize tf_crop_and_resize")
        if node.attr("antialias", 0):
            raise UnsupportedOnnxOp("Resize antialias=1")
        if node.attr("exclude_outside", 0):
            raise UnsupportedOnnxOp("Resize exclude_outside=1")
        kap = node.attr("keep_aspect_ratio_policy", b"stretch")
        kap = kap.decode() if isinstance(kap, bytes) else kap
        if kap != "stretch":
            raise UnsupportedOnnxOp(
                f"Resize keep_aspect_ratio_policy '{kap}'")
        axes_attr = node.attr("axes")
        if axes_attr is not None:
            axes = [int(a) % x.ndim
                    for a in np.asarray(axes_attr).reshape(-1)]
        else:
            axes = list(range(x.ndim))
        sizes = self._host_value(node, sizes, "sizes")
        scales = self._host_value(node, scales, "scales")
        sc = None
        if sizes is not None and np.asarray(sizes).size:
            sz = [int(s) for s in np.asarray(sizes).reshape(-1)]
            if len(sz) != len(axes):
                raise UnsupportedOnnxOp(
                    f"Resize sizes has {len(sz)} entries for {len(axes)} axes")
            out_shape = list(x.shape)
            for a, s_ in zip(axes, sz):
                out_shape[a] = s_
        elif scales is not None and np.asarray(scales).size:
            s_list = np.asarray(scales, np.float64).reshape(-1)
            if len(s_list) != len(axes):
                raise UnsupportedOnnxOp(
                    f"Resize scales has {len(s_list)} entries for "
                    f"{len(axes)} axes")
            sc = np.ones(x.ndim, np.float64)
            for a, s_ in zip(axes, s_list):
                sc[a] = s_
            out_shape = [int(np.floor(d * s_)) for d, s_ in zip(x.shape, sc)]
        else:
            raise UnsupportedOnnxOp("Resize needs scales or sizes")
        return self._resize(node, x, out_shape, sc, mode, ct,
                            nm="floor" if legacy else None)

    def op_Upsample(self, node, x, scales=None):
        """Deprecated (opset 7 attribute / opset 9 input): asymmetric
        coordinates with floor rounding."""
        if scales is None:
            scales = node.attr("scales")
        if scales is None:
            raise UnsupportedOnnxOp("Upsample needs scales")
        sc = np.asarray(self._host_value(node, scales, "scales"),
                        np.float64).reshape(-1)
        out_shape = [int(np.floor(d * s)) for d, s in zip(x.shape, sc)]
        mode = node.attr("mode", b"nearest")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if mode == "nearest":
            out = x
            for ax, (d_in, d_out) in enumerate(zip(x.shape, out_shape)):
                if d_in == d_out:
                    continue
                idx = self._memo(
                    ("upsample", id(node), ax, d_in, d_out, float(sc[ax])),
                    [], lambda d_in=d_in, d_out=d_out, s=sc[ax]: np.clip(
                        np.floor(np.arange(d_out) / s), 0,
                        d_in - 1).astype(np.int64))
                out = self._gather_axis(out, idx, ax)
            return out
        return self._resize(node, x, out_shape, sc, mode, "asymmetric")

    def op_Einsum(self, node, *xs):
        """``jnp.einsum`` with float32 accumulation and a float32 result:
        the promoted operands in float32 (exact for bf16 products)."""
        eq = node.attr("equation")
        if isinstance(eq, bytes):
            eq = eq.decode()
        if all(_is_host(x) for x in xs):
            return np.einsum(eq, *xs)
        return torch.einsum(eq, *(t.float() for t in self._promote(*xs)))

    # -- scatter / gather extras ---------------------------------------------

    def op_CastLike(self, node, x, target):
        """``x`` at ``target``'s dtype (a device cast to a 64-bit type
        gives 32 bits, as jax with x64 off). A host ``x`` stays a host value
        (a bf16 one, which numpy does not hold, becomes a tensor on
        ``target``'s device), made once while ``x`` is a constant, so its
        device copy is made once too."""
        if _is_host(target):
            dt = np.asarray(target).dtype
            if _is_host(x):
                return np.asarray(x).astype(dt)
            return x.to(_DEVICE_DTYPE[dt])
        if not _is_host(x):
            return x.to(target.dtype)
        np_dt = _NP_OF_TORCH.get(target.dtype)

        def cast():
            if np_dt is not None:
                return np.asarray(x).astype(np_dt)
            return self._tensor(x, target.device, target.dtype)

        return self._memo(("CastLike", id(node), target.dtype,
                           target.device), [x], cast)

    def op_EyeLike(self, node, x):
        """A host identity of ``x``'s leading two dims (a bf16 one, which
        numpy does not hold, as a tensor on ``x``'s device), made once per
        shape and dtype, so its device copy is made once too."""
        k = node.attr("k", 0)
        to = node.attr("dtype")
        rows, cols = x.shape[0], x.shape[1]
        if to is not None:
            dt = _NP_DTYPES[to]
        elif _is_host(x):
            dt = np.asarray(x).dtype
        elif x.dtype == torch.bfloat16:
            return self._memo(
                ("EyeLike", id(node), rows, cols, x.device), [],
                lambda: self._tensor(np.eye(rows, cols, k=k,
                                            dtype=np.float32),
                                     x.device, torch.bfloat16))
        else:
            dt = _NP_OF_TORCH[x.dtype]
        return self._memo(("EyeLike", id(node), rows, cols, np.dtype(dt)),
                          [], lambda: np.eye(rows, cols, k=k, dtype=dt))

    def op_OneHot(self, node, indices, depth, values):
        """Indices in [-depth, -1] wrap once; anything outside
        [-depth, depth - 1] gives an all-off row (no modulo wrap)."""
        axis = node.attr("axis", -1)
        d = int(np.asarray(self._host_value(node, depth, "depth")).reshape(()))
        nd = np.ndim(indices) + 1
        ax = axis % nd
        shape = [1] * nd
        shape[ax] = d
        if _all_host(indices, values):
            idx = np.where(indices < 0, indices + d, indices)
            hot = np.expand_dims(idx, ax) == np.arange(d).reshape(shape)
            return np.where(hot, values[1], values[0])
        dev = _device_of(indices, values)
        it = self._tensor(indices, dev)
        idx = torch.where(it < 0, it + d, it)
        hot = idx.unsqueeze(ax) == torch.arange(d, device=dev).reshape(shape)
        v = self._tensor(values, dev)
        return torch.where(hot, v[1], v[0])

    def op_GatherND(self, node, data, indices):
        """``data[idx[..., 0], idx[..., 1], ...]``: negative indices count
        from the end, an index still out of range is clamped (jax's gather
        mode), so nothing is checked on the host."""
        batch_dims = node.attr("batch_dims", 0)
        if batch_dims:
            raise UnsupportedOnnxOp(
                f"GatherND batch_dims={batch_dims} is not supported")
        if _all_host(data, indices):
            return np.asarray(data)[tuple(np.moveaxis(np.asarray(indices),
                                                      -1, 0))]
        dev = _device_of(data, indices)
        d = self._tensor(data, dev)
        it = self._tensor(indices, dev).to(torch.int64)
        parts = []
        for k in range(indices.shape[-1]):
            n = d.shape[k]
            p = it[..., k]
            parts.append(torch.where(p < 0, p + n, p).clamp(0, max(n - 1, 0)))
        return d[tuple(parts)]

    def _scatter_reduce(self, node):
        red = node.attr("reduction", b"none")
        red = red.decode() if isinstance(red, bytes) else red
        if red not in ("none", "add", "mul", "max", "min"):
            raise UnsupportedOnnxOp(
                f"{node.op_type} reduction '{red}' is not supported")
        return red

    @staticmethod
    def _scatter(d: torch.Tensor, coords, updates: torch.Tensor,
                 red: str) -> torch.Tensor:
        """``d.at[coords].set/add/multiply/max/min(updates)`` as jax does
        it: ``coords`` index ``d``'s leading dims (broadcast to one shape);
        negative indices count from the end and an update still out of
        range is dropped. The leading dims are flattened, and a dropped
        update goes to one extra row that is cut off again, so no index is
        read on the host."""
        k = len(coords)
        lead, rest = d.shape[:k], tuple(d.shape[k:])
        rows = int(np.prod(lead, dtype=np.int64))
        coords = torch.broadcast_tensors(*coords)
        lin = torch.zeros_like(coords[0])
        valid = torch.ones_like(coords[0], dtype=torch.bool)
        for c, n in zip(coords, lead):
            c = torch.where(c < 0, c + n, c)
            valid &= (c >= 0) & (c < n)
            lin = lin * n + c
        lin = torch.where(valid, lin, rows).reshape(-1)
        flat = torch.cat([d.reshape(rows, *rest), d.new_zeros((1, *rest))])
        u = updates.to(d.dtype).reshape(-1, *rest)
        if red == "none":
            flat.index_put_((lin,), u)
        elif red == "add":
            flat.index_put_((lin,), u, accumulate=True)
        else:
            idx = lin.reshape(-1, *([1] * len(rest))).expand_as(u)
            flat.scatter_reduce_(0, idx, u, {"mul": "prod", "max": "amax",
                                             "min": "amin"}[red])
        return flat[:rows].reshape(d.shape)

    def op_ScatterND(self, node, data, indices, updates):
        red = self._scatter_reduce(node)
        dev = _device_of(data, indices, updates)
        d = self._tensor(data, dev)
        it = self._tensor(indices, dev).to(torch.int64)
        coords = [it[..., i] for i in range(indices.shape[-1])]
        return self._scatter(d, coords, self._tensor(updates, dev), red)

    def op_ScatterElements(self, node, data, indices, updates):
        red = self._scatter_reduce(node)
        axis = node.attr("axis", 0)
        if _all_host(data, indices, updates) and red == "none":
            out = np.asarray(data).copy()
            np.put_along_axis(out, np.asarray(indices), np.asarray(updates),
                              axis=axis)
            return out
        dev = _device_of(data, indices, updates)
        d = self._tensor(data, dev)
        it = self._tensor(indices, dev).to(torch.int64)
        coords = [torch.arange(it.shape[a], device=dev).reshape(
            [-1 if i == a else 1 for i in range(it.ndim)])
            for a in range(it.ndim)]
        coords[axis % d.ndim] = it
        return self._scatter(d, coords, self._tensor(updates, dev), red)

    def op_Scatter(self, node, data, indices, updates):
        # Deprecated opset-9 alias of ScatterElements.
        return self.op_ScatterElements(node, data, indices, updates)

    # -- opset-18+ breadth ops -------------------------------------------------

    def op_GroupNormalization(self, node, x, scale, bias):
        """Opset 18 (per-group scale/bias) and opset 21 (per-channel),
        told apart by the parameters' length, as ONNX Runtime does."""
        eps = node.attr("epsilon", 1e-5)
        g = node.attr("num_groups")
        n, c = x.shape[0], x.shape[1]
        if g is None or c % g:
            raise UnsupportedOnnxOp(
                f"GroupNormalization num_groups={g} over C={c}")
        m, (x, scale, bias) = self._lib(x, scale, bias)
        xs = m.reshape(x, (n, g, -1))
        # ``xs - mu`` once: an eager device run has no CSE to share it.
        d = xs - m.mean(xs, axis=-1, keepdims=True)
        var = m.mean(d ** 2, axis=-1, keepdims=True)
        y = m.reshape(d / m.sqrt(var + eps), x.shape)
        if scale.shape[0] == g != c:  # opset-18 per-group params
            scale = m.repeat(scale, c // g)
            bias = m.repeat(bias, c // g)
        shape = (1, c) + (1,) * (x.ndim - 2)
        return y * m.reshape(scale, shape) + m.reshape(bias, shape)

    def _rms_normalize(self, node, x, scale):
        eps = node.attr("epsilon", 1e-5)
        axis = node.attr("axis", -1)
        m, (x, scale) = self._lib(x, scale)
        axes = tuple(range(axis % x.ndim, x.ndim))
        ms = m.mean(m.square(x), axis=axes, keepdims=True)
        return x / m.sqrt(ms + eps) * scale

    def op_RMSNormalization(self, node, x, scale):
        return self._rms_normalize(node, x, scale)

    def op_SimplifiedLayerNormalization(self, node, x, scale):
        # com.microsoft spelling of RMSNorm (transformer exports).
        return self._rms_normalize(node, x, scale)

    def op_ReverseSequence(self, node, x, seq_lens):
        batch_axis = node.attr("batch_axis", 1)
        time_axis = node.attr("time_axis", 0)
        m, (x, seq_lens) = self._lib(x, seq_lens)
        t_len = x.shape[time_axis]
        lens = m.reshape(seq_lens, (-1, 1))
        t = m.arange(t_len)[None, :]
        idx = m.where(t < lens, lens - 1 - t, t)  # [B, T]
        xm = m.moveaxis(x, (batch_axis, time_axis), (0, 1))
        idx = m.reshape(idx, tuple(idx.shape) + (1,) * (xm.ndim - 2))
        # A length beyond the time axis reads out of range: jnp's fill on
        # the card, numpy's IndexError on host values (as in JAX).
        out = m.take_along_axis(xm, idx, axis=1)
        return m.moveaxis(out, (0, 1), (batch_axis, time_axis))

    def op_CenterCropPad(self, node, x, shape):
        target = [int(v) for v in np.asarray(
            self._host_value(node, shape, "shape")).reshape(-1)]
        axes = node.attr("axes")
        axes = (list(range(x.ndim)) if axes is None
                else [a % x.ndim for a in axes])
        pads = []
        slices = [slice(None)] * x.ndim
        for ax, want in zip(axes, target):
            have = x.shape[ax]
            if want < have:  # centered crop, floor offset at the start
                start = (have - want) // 2
                slices[ax] = slice(start, start + want)
            elif want > have:  # centered pad, extra element at the end
                before = (want - have) // 2
                pads.append((ax, before, want - have - before))
        x = x[tuple(slices)]
        if not pads:
            return x
        widths = [(0, 0)] * x.ndim
        for ax, b, a in pads:
            widths[ax] = (b, a)
        if _is_host(x):
            return np.pad(x, widths)
        return F.pad(x, [v for pair in reversed(widths) for v in pair])

    def op_Col2Im(self, node, x, image_shape, block_shape):
        """Inverse im2col (opset 18): each of the kH*kW kernel taps adds
        one strided slice onto the image canvas."""
        img = [int(v) for v in np.asarray(self._host_value(
            node, image_shape, "image_shape")).reshape(-1)]
        blk = [int(v) for v in np.asarray(self._host_value(
            node, block_shape, "block_shape")).reshape(-1)]
        nsp = len(img)
        dil = list(node.attr("dilations") or [1] * nsp)
        pads = list(node.attr("pads") or [0] * (2 * nsp))
        strides = list(node.attr("strides") or [1] * nsp)
        if nsp != 2:
            raise UnsupportedOnnxOp(
                f"Col2Im with {nsp} spatial dims (only 2-D supported)")
        (ih, iw), (kh, kw) = img, blk
        sh, sw = [
            (img[i] + pads[i] + pads[nsp + i] - dil[i] * (blk[i] - 1) - 1)
            // strides[i] + 1 for i in range(nsp)]
        x = self._tensor(x, _device_of(x))
        n = x.shape[0]
        c = x.shape[1] // (kh * kw)
        cols = x.reshape(n, c, kh, kw, sh, sw)
        canvas = torch.zeros((n, c, ih + pads[0] + pads[2],
                              iw + pads[1] + pads[3]),
                             dtype=cols.dtype, device=cols.device)
        for i in range(kh):
            for j in range(kw):
                canvas[:, :,
                       i * dil[0]: i * dil[0] + sh * strides[0]: strides[0],
                       j * dil[1]: j * dil[1] + sw * strides[1]: strides[1],
                       ] += cols[:, :, i, j]
        return canvas[:, :, pads[0]: pads[0] + ih, pads[1]: pads[1] + iw]

    def op_GridSample(self, node, x, grid):
        """2-D GridSample (opset 16/20): linear or nearest over zeros or
        border padding, one flattened gather per corner."""
        mode = node.attr("mode", b"linear")
        mode = mode.decode() if isinstance(mode, bytes) else mode
        pad = node.attr("padding_mode", b"zeros")
        pad = pad.decode() if isinstance(pad, bytes) else pad
        align = node.attr("align_corners", 0)
        if np.ndim(x) != 4:
            raise UnsupportedOnnxOp("GridSample supports 2-D inputs only")
        if mode not in ("linear", "bilinear", "nearest"):
            raise UnsupportedOnnxOp(f"GridSample mode '{mode}'")
        if pad not in ("zeros", "border"):
            raise UnsupportedOnnxOp(f"GridSample padding_mode '{pad}'")
        dev = _device_of(x, grid)
        x, grid = self._tensor(x, dev), self._tensor(grid, dev)
        n, c, h, w = x.shape
        gx, gy = grid[..., 0], grid[..., 1]

        def unnorm(g, size):
            if align:
                return (g + 1.0) * 0.5 * (size - 1)
            return ((g + 1.0) * size - 1.0) * 0.5

        fx, fy = unnorm(gx, w), unnorm(gy, h)
        flat = x.reshape(n, c, h * w)

        def tap(ix, iy):
            """x[n, :, iy, ix] with a border clamp, zeroed out of bounds
            under zeros padding."""
            ok = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            idx = idx.to(torch.int64).reshape(n, 1, -1).expand(n, c, -1)
            vals = torch.gather(flat, 2, idx).reshape(
                (n, c) + tuple(gx.shape[1:]))
            if pad == "zeros":
                vals = vals * ok.unsqueeze(1).to(vals.dtype)
            return vals

        if mode == "nearest":
            return tap(torch.round(fx).to(torch.int32),
                       torch.round(fy).to(torch.int32))
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx = (fx - x0).to(x.dtype)[:, None]
        wy = (fy - y0).to(x.dtype)[:, None]
        x0i, y0i = x0.to(torch.int32), y0.to(torch.int32)
        v00 = tap(x0i, y0i)
        v01 = tap(x0i + 1, y0i)
        v10 = tap(x0i, y0i + 1)
        v11 = tap(x0i + 1, y0i + 1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy

    def op_AffineGrid(self, node, theta, size):
        """Opset-20 AffineGrid (2-D): theta [N,2,3] and a host size
        [N,C,H,W] give the grid [N,H,W,2] of (x, y) in [-1, 1], in
        float32."""
        dims = [int(v) for v in np.asarray(
            self._host_value(node, size, "size")).reshape(-1)]
        if len(dims) != 4:
            raise UnsupportedOnnxOp(
                f"AffineGrid with {len(dims) - 2} spatial dims "
                "(only 2-D supported)")
        n, _, h, w = dims
        align = node.attr("align_corners", 0)
        dev = _device_of(theta)

        def base(count):
            r = torch.arange(count, dtype=torch.float32, device=dev)
            if align:
                return -1.0 + _true_div(2.0 * r, max(count - 1, 1))
            return _true_div(2.0 * r + 1.0, count) - 1.0

        xs = base(w)[None, :].expand(h, w)
        ys = base(h)[:, None].expand(h, w)
        ones = torch.ones((h, w), dtype=torch.float32, device=dev)
        pts = torch.stack([xs, ys, ones], dim=-1).reshape(h * w, 3)
        th = self._tensor(theta, dev, torch.float32)
        return torch.einsum("pk,nok->npo", pts, th).reshape(n, h, w, 2)

    def op_Det(self, node, x):
        if _is_host(x):
            return np.linalg.det(np.asarray(x)).astype(np.asarray(x).dtype)
        return _det(x)

    def _bitwise(self, np_fn, torch_fn, *xs):
        """A bitwise op in jnp's promotion; the unsigned dtypes PyTorch has
        no bitwise kernels for run on int64 and convert back (modulo 2^n,
        as the op itself wraps)."""
        if _all_host(*xs):
            return np_fn(*xs)
        ts = self._promote(*xs, uniform=True)
        dt = next(t.dtype for t in ts if isinstance(t, torch.Tensor))
        if dt in _WIDE_UNSIGNED:
            wide = [t.to(torch.int64) if isinstance(t, torch.Tensor) else t
                    for t in ts]
            return torch_fn(*wide).to(dt)
        return torch_fn(*ts)

    def op_BitShift(self, node, x, y):
        d = node.attr("direction")
        d = d.decode() if isinstance(d, bytes) else d
        if d == "LEFT":
            return self._bitwise(np.left_shift, torch.bitwise_left_shift,
                                 x, y)
        if d == "RIGHT":
            return self._bitwise(np.right_shift, torch.bitwise_right_shift,
                                 x, y)
        raise UnsupportedOnnxOp(f"BitShift direction '{d}'")

    def op_BitwiseAnd(self, node, a, b):
        return self._bitwise(np.bitwise_and, torch.bitwise_and, a, b)

    def op_BitwiseOr(self, node, a, b):
        return self._bitwise(np.bitwise_or, torch.bitwise_or, a, b)

    def op_BitwiseXor(self, node, a, b):
        return self._bitwise(np.bitwise_xor, torch.bitwise_xor, a, b)

    def op_BitwiseNot(self, node, x):
        return self._bitwise(np.invert, torch.bitwise_not, x)

    # -- attention (opset 23 + com.microsoft fused transformer ops) -----------
    #
    # Both spellings of a transformer export (opset-23 Attention, and the
    # ORT optimizer's com.microsoft fused ops) run one core, _sdpa, with the
    # JAX core's numerics: fp32 products and softmax. Not
    # F.scaled_dot_product_attention: its bf16 rounding differs from the
    # reference and it returns no raw Q·Kᵀ. KV-cache inputs (decode-time
    # state) are refused, as in the JAX evaluator.

    def _sdpa(self, q, k, v, mask=None, is_causal=False, scale=None,
              softcap=0.0):
        """q/k/v: [B, H, S, D] (kv heads may divide q heads: GQA). mask:
        bool (True = attend) or additive float, broadcastable to
        [B, H, Sq, Skv]. Returns (out, qk_raw): the output at ``v``'s dtype
        and the scaled Q·Kᵀ before mask and softcap, in float32.

        The products take float32 operands: a bf16 operand is exact in
        float32, and the float32 product (TF32 off) is the fp32-accumulated
        product of the bf16 values with a float32 result, which is what the
        JAX core's ``preferred_element_type=float32`` gives; a bf16
        ``torch.matmul`` would round its result to bf16."""
        dev = _device_of(q, k, v, mask)
        q, k, v = (self._tensor(t, dev) for t in (q, k, v))
        hq, hkv = q.shape[1], k.shape[1]
        if hq != hkv:  # grouped-query attention: repeat kv heads
            if hq % hkv:
                raise UnsupportedOnnxOp(
                    f"Attention q_heads={hq} not a multiple of kv_heads={hkv}")
            k = k.repeat_interleave(hq // hkv, dim=1)
            v = v.repeat_interleave(hq // hkv, dim=1)
        if scale is None:
            scale = 1.0 / float(np.sqrt(q.shape[-1]))
        qk_raw = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        qk = qk_raw
        # The spec's order: an additive mask joins the logits before the
        # softcap; a boolean or causal mask is a -inf select just before
        # the softmax.
        bool_mask = None
        if mask is not None:
            mask = self._tensor(mask, dev)
            while mask.ndim < 4:
                mask = mask[None]
            if mask.dtype == torch.bool:
                bool_mask = mask
            else:
                qk = qk + mask
        if softcap:
            qk = softcap * torch.tanh(_true_div(qk, softcap))
        if is_causal:
            # Upper-left alignment (tril of ones(Sq, Skv)), combined with
            # any given mask.
            sq, skv = qk.shape[-2], qk.shape[-1]
            causal = (torch.arange(skv, device=dev)[None, :]
                      <= torch.arange(sq, device=dev)[:, None])
            bool_mask = causal if bool_mask is None else bool_mask & causal
        if bool_mask is not None:
            qk = torch.where(bool_mask, qk, -float("inf"))
        e = torch.exp(qk - qk.amax(dim=-1, keepdim=True))
        w = e / e.sum(dim=-1, keepdim=True)
        out = torch.matmul(w, v.float())
        return out.to(v.dtype), qk_raw

    @staticmethod
    def _split_heads(x, n_heads):
        """[B, S, H*D] -> [B, H, S, D]"""
        b, s, hid = x.shape
        return x.reshape(b, s, n_heads, hid // n_heads).permute(0, 2, 1, 3)

    @staticmethod
    def _merge_heads(x):
        """[B, H, S, D] -> [B, S, H*D]"""
        b, h, s, d = x.shape
        return x.permute(0, 2, 1, 3).reshape(b, s, h * d)

    def op_Attention(self, node, q, k, v, attn_mask=None,
                     past_key=None, past_value=None):
        """Opset-23 Attention: 3-D ([B,S,hidden]) or 4-D ([B,H,S,D])
        Q/K/V, bool or additive mask, is_causal, GQA, scale, softcap;
        present K/V (no past: K/V in head layout) and the raw Q·Kᵀ."""
        if past_key is not None or past_value is not None:
            raise UnsupportedOnnxOp("Attention past_key/past_value (KV cache)")
        if len(node.outputs) > 3 and node.outputs[3]:
            mode = node.attr("qk_matmul_output_mode", 0)
            if mode != 0:
                raise UnsupportedOnnxOp(
                    f"Attention qk_matmul_output_mode={mode}")
        dev = _device_of(q, k, v, attn_mask)
        q, k, v = (self._tensor(t, dev) for t in (q, k, v))
        three_d = q.ndim == 3
        if three_d:
            hq = node.attr("q_num_heads")
            hkv = node.attr("kv_num_heads")
            if not hq or not hkv:
                raise UnsupportedOnnxOp(
                    "3-D Attention requires q_num_heads/kv_num_heads")
            q = self._split_heads(q, hq)
            k = self._split_heads(k, hkv)
            v = self._split_heads(v, hkv)
        out, qk = self._sdpa(
            q, k, v, mask=attn_mask,
            is_causal=bool(node.attr("is_causal", 0)),
            scale=node.attr("scale"),
            softcap=node.attr("softcap", 0.0))
        if three_d:
            out = self._merge_heads(out)
        results = [out]
        if len(node.outputs) > 1:
            results += [k, v]
            if len(node.outputs) > 3:
                results.append(qk)
        return tuple(results) if len(results) > 1 else out

    def op_MultiHeadAttention(self, node, query, key=None, value=None,
                              bias=None, key_padding_mask=None,
                              attention_bias=None, past_key=None,
                              past_value=None):
        """com.microsoft MultiHeadAttention: separate Q/K/V ([B,S,hidden]),
        packed QKV in ``query`` ([B,S,num_heads,3,head_size]) or packed KV
        in ``key`` ([B,kv_S,num_heads,2,head_size]); an optional fused bias
        (at the query's dtype) and additive attention bias."""
        if past_key is not None or past_value is not None:
            raise UnsupportedOnnxOp("MultiHeadAttention past KV cache")
        if key_padding_mask is not None:
            raise UnsupportedOnnxOp("MultiHeadAttention key_padding_mask")
        n = node.attr("num_heads")
        if not n:
            raise UnsupportedOnnxOp("MultiHeadAttention requires num_heads")
        dev = _device_of(query, key, value, bias, attention_bias)

        def heads(x):  # [B, S, N, D] -> [B, N, S, D]
            return x.permute(0, 2, 1, 3)

        if key is None and value is None:
            query = self._tensor(query, dev)
            if query.ndim != 5 or query.shape[3] != 3:
                raise UnsupportedOnnxOp(
                    "MultiHeadAttention without key/value requires packed "
                    f"QKV [B,S,heads,3,head] (got rank {query.ndim})")
            if bias is not None:
                raise UnsupportedOnnxOp(
                    "MultiHeadAttention bias with packed QKV")
            q, k, v = (heads(query[..., i, :]) for i in range(3))
        elif value is None and key is not None and np.ndim(key) == 5:
            if key.shape[3] != 2:
                raise UnsupportedOnnxOp(
                    "MultiHeadAttention packed KV must be [B,S,heads,2,head]")
            if bias is not None:
                raise UnsupportedOnnxOp(
                    "MultiHeadAttention bias with packed KV")
            key = self._tensor(key, dev)
            q = self._split_heads(self._tensor(query, dev), n)
            k, v = (heads(key[..., i, :]) for i in range(2))
        else:
            q, k, v = (self._tensor(t, dev) for t in (query, key, value))
            if bias is not None:
                b = self._tensor(bias, dev, q.dtype)
                hid = q.shape[-1]
                q = q + b[:hid]
                k = k + b[hid:hid + k.shape[-1]]
                v = v + b[hid + k.shape[-1]:]
            q, k, v = (self._split_heads(t, n) for t in (q, k, v))
        out, _ = self._sdpa(q, k, v, mask=attention_bias,
                            scale=node.attr("scale"))
        return self._merge_heads(out)

    def op_FusedMatMul(self, node, a, b):
        """com.microsoft MatMul with transposes and ``alpha`` folded in:
        compute-dtype operands, fp32 sums, the result at ``a``'s dtype."""
        if node.attr("transBatchA", 0) or node.attr("transBatchB", 0):
            raise UnsupportedOnnxOp("FusedMatMul transBatchA/B")
        a, b = self._mm_cast(_device_of(a, b), a, b)
        if node.attr("transA", 0):
            a = a.transpose(-1, -2)
        if node.attr("transB", 0):
            b = b.transpose(-1, -2)
        out = self._contract(torch.matmul, a, b)
        return out.to(a.dtype) * node.attr("alpha", 1.0)

    def op_FastGelu(self, node, x, bias=None):
        """com.microsoft tanh-approximated gelu with an optional fused bias;
        its constant is a float32 scalar (strongly typed in jnp, so a bf16
        input gives a float32 output). ``x ** 3`` is jnp's integer power,
        ``x * x * x``."""
        m, (x, bias) = self._lib(x, bias)
        if bias is not None:
            x = x + bias
        c = np.sqrt(2.0 / np.pi).astype(np.float32)
        inner = x + 0.044715 * (x * x * x)
        inner = c * inner if m is np else m.mul_f32(c, inner)
        return 0.5 * x * (1.0 + m.tanh(inner))

    def op_BiasGelu(self, node, x, bias):
        """Exact gelu of ``x + bias`` (``jax.nn.gelu``, which the JAX
        evaluator runs on host values too)."""
        t = self._binary(np.add, torch.add, x, bias)
        return _gelu_exact(self._tensor(t, _device_of(t)))

    def op_QuickGelu(self, node, x):
        alpha = node.attr("alpha", 1.702)
        if _is_host(x):
            return x / (1.0 + np.exp(-alpha * x))
        return x * torch.sigmoid(alpha * x)

    def _graph_consumes(self, name: str) -> bool:
        """Whether a tensor name feeds any node (subgraphs included) or is
        a graph output: an op with a declared but unsupported optional
        output fails typed instead of leaking None downstream."""
        names = getattr(self, "_consumed_names", None)
        if names is None:
            names = set()

            def walk(g):
                for nd in g.nodes:
                    names.update(i for i in nd.inputs if i)
                    for a in nd.attrs.values():
                        if a.g is not None:
                            walk(a.g)

            walk(self.graph)
            names.update(o.name for o in self.graph.outputs)
            self._consumed_names = names
        return name in names

    def _skip_layer_norm(self, node, x, skip, gamma, beta, bias, rms):
        eps = node.attr("epsilon", 1e-12)
        m, (x, skip, gamma, beta, bias) = self._lib(x, skip, gamma, beta,
                                                    bias)
        total = x + skip if bias is None else x + skip + bias
        if rms:
            denom = m.sqrt(m.mean(m.square(total), axis=-1, keepdims=True)
                           + eps)
            out = total / denom * gamma
        else:
            # ``total - mu`` once: an eager device run has no CSE.
            d = total - m.mean(total, axis=-1, keepdims=True)
            var = m.mean(d ** 2, axis=-1, keepdims=True)
            out = d / m.sqrt(var + eps) * gamma
            if beta is not None:
                out = out + beta
        # Outputs 2/3 (mean, inv_std_var) are training-only; output 4 is
        # the pre-norm sum some graphs feed the residual stream from.
        for pos in (1, 2):
            if len(node.outputs) > pos and node.outputs[pos] \
                    and self._graph_consumes(node.outputs[pos]):
                raise UnsupportedOnnxOp(
                    f"{node.op_type} training-only output "
                    f"'{node.outputs[pos]}' (mean/inv_std_var) is consumed "
                    "by the graph")
        results = [out]
        if len(node.outputs) > 1:
            results += [None, None]
            if len(node.outputs) > 3:
                results.append(total)
        return tuple(results) if len(results) > 1 else out

    def op_SkipLayerNormalization(self, node, x, skip, gamma, beta=None,
                                  bias=None):
        return self._skip_layer_norm(node, x, skip, gamma, beta, bias,
                                     rms=False)

    def op_SkipSimplifiedLayerNormalization(self, node, x, skip, gamma,
                                            bias=None):
        return self._skip_layer_norm(node, x, skip, gamma, None, bias,
                                     rms=True)

    # -- control flow ----------------------------------------------------------
    #
    # ONNX If/Loop/Scan run at call time, as the JAX evaluator runs them at
    # trace time: a condition and a trip count must be host values, If
    # picks its branch and Loop/Scan unroll their bodies. A device value
    # there is refused (reading it would sync the card every step).

    _LOOP_UNROLL_CAP = 4096

    def _outer_env(self) -> dict:
        stack = getattr(self._tls, "envs", None)
        return stack[-1] if stack else {}

    def _iteration(self, i: int) -> np.int64:
        """The iteration number ``i`` as the same object at every call, so
        that a body's folds on it are made once per iteration."""
        it = self._iters.get(i)
        return it if it is not None else self._iters.setdefault(i,
                                                                np.int64(i))

    def _subgraph_evaluator(self, graph) -> "_Evaluator":
        """One evaluator per subgraph body, made once (Loop and Scan call
        it per iteration) under a lock, for threads that share the function
        (``--jobs`` workers). Always the stock float evaluator: the int8
        and calibration subclasses act on top-level nodes only, so a body
        runs float, never half quantized with missing scales. It shares
        the enclosing evaluator's folds, persistent host arrays, device
        copies and iteration numbers, so that what is constant outside is
        constant inside and each fold is kept once."""
        with self._sub_lock:
            ev = self._sub_evs.get(id(graph))
            if ev is None:
                ev = _Evaluator(graph, compute_dtype=self._compute_dtype,
                                opset=self.opset)
                # Large body weights lifted into the params arrive through
                # the outer environment instead.
                for n in self.lifted_params:
                    ev.const.pop(n, None)
                ev.lifted_params = self.lifted_params
                ev._memos, ev._persistent = self._memos, self._persistent
                ev._device_copies, ev._iters = (self._device_copies,
                                                self._iters)
                self._persistent.update(id(v) for v in ev.const.values()
                                        if isinstance(v, np.ndarray))
                self._sub_evs[id(graph)] = ev
        return ev

    def _run_subgraph(self, graph, feeds: dict, step=None) -> list:
        """Run a subgraph attribute with outer-scope closure (ONNX
        nested-scope semantics: its nodes may read any name visible in the
        enclosing graph; its own initializers and Constants shadow outer
        values of the same name). ``step`` is the Loop or Scan iteration it
        runs for."""
        ev = self._subgraph_evaluator(graph)
        env = dict(ev.const)
        env.update((k, v) for k, v in self._outer_env().items()
                   if k and k not in ev.const)
        env.update(feeds)
        steps = self._steps() if step is None else self._steps() + (step,)
        prev = getattr(ev._tls, "steps", ())
        ev._tls.steps = steps
        try:
            out_env = ev._execute(env)
        finally:
            ev._tls.steps = prev
        return [out_env[vi.name] for vi in graph.outputs]

    def _stack(self, key, vals, axis: int = 0):
        """The outputs of every iteration stacked along ``axis``: on the
        host, once while they are constants; on the device, promoted to
        one dtype."""
        if all(_is_host(v) for v in vals):
            return self._memo(key, vals, lambda: np.stack(
                [np.asarray(v) for v in vals], axis=axis))
        dev = _device_of(*vals)
        return torch.stack(self._promote(*vals, dev=dev, uniform=True),
                           dim=axis)

    def op_If(self, node, cond):
        if not _is_host(cond):
            raise UnsupportedOnnxOp(
                f"If with a data-dependent condition (node "
                f"'{node.name or 'If'}'); conditions must be graph-static")
        branch = node.attr("then_branch") if bool(
            np.asarray(cond).reshape(())) else node.attr("else_branch")
        if branch is None:
            raise UnsupportedOnnxOp("If without branch subgraphs")
        return tuple(self._run_subgraph(branch, {}))

    def op_Loop(self, node, m=None, cond=None, *v_init):
        body = node.attr("body")
        if body is None:
            raise UnsupportedOnnxOp("Loop without a body subgraph")
        if m is None and cond is None:
            raise UnsupportedOnnxOp(
                "Loop with neither trip count nor condition")
        if m is not None and not _is_host(m):
            raise UnsupportedOnnxOp(
                f"Loop with a data-dependent trip count (node "
                f"'{node.name or 'Loop'}')")

        def host_bool(v, what):
            if v is None:
                return True
            if not _is_host(v):
                raise UnsupportedOnnxOp(
                    f"Loop with a data-dependent {what} (node "
                    f"'{node.name or 'Loop'}')")
            return bool(np.asarray(v).reshape(()))

        trip = int(np.asarray(m).reshape(())) if m is not None else None
        if trip is not None and trip > self._LOOP_UNROLL_CAP:
            raise UnsupportedOnnxOp(
                f"Loop trip count {trip} exceeds the unroll cap "
                f"{self._LOOP_UNROLL_CAP}")
        n_vars = len(v_init)
        n_scan = len(body.outputs) - 1 - n_vars
        keep = host_bool(cond, "condition")
        vars_ = list(v_init)
        scans: list[list] = [[] for _ in range(n_scan)]
        i = 0
        while keep and (trip is None or i < trip):
            if trip is None and i >= self._LOOP_UNROLL_CAP:
                raise UnsupportedOnnxOp(
                    f"while-style Loop exceeded the unroll cap "
                    f"{self._LOOP_UNROLL_CAP}")
            feeds = {body.inputs[0].name: self._iteration(i)}
            if len(body.inputs) > 1:
                feeds[body.inputs[1].name] = np.bool_(True)
            for vi, v in zip(body.inputs[2:], vars_):
                feeds[vi.name] = v
            outs = self._run_subgraph(body, feeds, step=i)
            keep = host_bool(outs[0], "loop-carried condition")
            vars_ = list(outs[1:1 + n_vars])
            for acc, v in zip(scans, outs[1 + n_vars:]):
                acc.append(v)
            i += 1
        results = list(vars_)
        for j, acc in enumerate(scans):
            if not acc:
                raise UnsupportedOnnxOp(
                    "Loop with zero iterations and scan outputs")
            results.append(self._stack(("loop_scan", id(node), j), acc))
        return tuple(results) if len(results) != 1 else results[0]

    def op_Scan(self, node, *args):
        """Opset-9+ Scan: N state variables and M scan inputs; the body
        takes one slice of each scan input per step, and the static
        sequence length unrolls like Loop."""
        if self.opset == 8:
            raise UnsupportedOnnxOp(
                "opset-8 Scan (sequence_lens/batch form) is not supported")
        body = node.attr("body")
        m_scan = node.attr("num_scan_inputs")
        if body is None or m_scan is None:
            raise UnsupportedOnnxOp("Scan needs body and num_scan_inputs")
        n_state = len(args) - m_scan
        if n_state < 0:
            raise UnsupportedOnnxOp("Scan with fewer inputs than "
                                    "num_scan_inputs")
        states = list(args[:n_state])
        scan_in = list(args[n_state:])
        in_axes = list(node.attr("scan_input_axes") or [0] * m_scan)
        in_dirs = list(node.attr("scan_input_directions") or [0] * m_scan)
        out_axes = node.attr("scan_output_axes")
        out_dirs = node.attr("scan_output_directions")
        t_len = int(scan_in[0].shape[in_axes[0] % np.ndim(scan_in[0])])
        if t_len > self._LOOP_UNROLL_CAP:
            raise UnsupportedOnnxOp(
                f"Scan length {t_len} exceeds the unroll cap "
                f"{self._LOOP_UNROLL_CAP}")
        n_scan_out = len(body.outputs) - n_state
        accs: list[list] = [[] for _ in range(n_scan_out)]
        for t in range(t_len):
            feeds = dict(zip((vi.name for vi in body.inputs[:n_state]),
                             states))
            for j, (x, ax, d) in enumerate(zip(scan_in, in_axes, in_dirs)):
                idx = t_len - 1 - t if d else t
                ax = ax % np.ndim(x)
                if _is_host(x):
                    sl = self._memo(
                        ("scan_in", id(node), j, idx), (x,),
                        lambda x=x, idx=idx, ax=ax: np.take(x, idx, axis=ax))
                else:
                    sl = x.select(ax, idx)
                feeds[body.inputs[n_state + j].name] = sl
            outs = self._run_subgraph(body, feeds, step=t)
            states = list(outs[:n_state])
            for acc, v in zip(accs, outs[n_state:]):
                acc.append(v)
        results = list(states)
        for j, acc in enumerate(accs):
            if out_dirs and j < len(out_dirs) and out_dirs[j]:
                acc = acc[::-1]
            ax = out_axes[j] if out_axes and j < len(out_axes) else 0
            results.append(self._stack(("scan_out", id(node), j), acc, ax))
        return tuple(results) if len(results) != 1 else results[0]

    # -- recurrent ops ---------------------------------------------------------
    #
    # Static-length recurrences unroll step by step, as the JAX handlers
    # unroll them at trace time: the same gate order, bias split and
    # summation order, so each step is the same arithmetic. Default
    # activations only; other configurations raise typed errors.

    def _rnn_common(self, node, x):
        """Shared RNN/GRU/LSTM setup. Returns (directions, seq_len)."""
        if node.attr("layout", 0) != 0:
            raise UnsupportedOnnxOp(f"{node.op_type} layout=1")
        if node.attr("clip") is not None:
            raise UnsupportedOnnxOp(f"{node.op_type} clip")
        direction = node.attr("direction", b"forward")
        direction = direction.decode() if isinstance(direction, bytes) \
            else direction
        if direction not in ("forward", "reverse", "bidirectional"):
            raise UnsupportedOnnxOp(
                f"{node.op_type} direction '{direction}'")
        seq_len = int(x.shape[0])
        if seq_len > self._LOOP_UNROLL_CAP:
            raise UnsupportedOnnxOp(
                f"{node.op_type} sequence length {seq_len} exceeds the "
                f"unroll cap {self._LOOP_UNROLL_CAP}")
        dirs = ["forward", "reverse"] if direction == "bidirectional" \
            else [direction]
        return dirs, seq_len

    @staticmethod
    def _rnn_acts(node, defaults):
        acts = node.attr("activations")
        if acts is not None:
            names = [a.decode() if isinstance(a, bytes) else a for a in acts]
            # A bidirectional node lists both directions' activations.
            if names not in (defaults, defaults + defaults):
                raise UnsupportedOnnxOp(
                    f"{node.op_type} non-default activations {names}")

    @staticmethod
    def _rnn_run(x, seq_len, reverse, cell):
        """Drive one direction: cell(xt) per step; outputs in time order."""
        steps = range(seq_len - 1, -1, -1) if reverse else range(seq_len)
        ys = [None] * seq_len
        for t in steps:
            ys[t] = cell(x[t])
        return ys

    def op_RNN(self, node, x, w, r, b=None, sequence_lens=None,
               initial_h=None):
        if sequence_lens is not None:
            raise UnsupportedOnnxOp("RNN sequence_lens")
        self._rnn_acts(node, ["Tanh"])
        dirs, seq_len = self._rnn_common(node, x)
        hid = int(np.asarray(node.attr("hidden_size") or w.shape[1]))
        batch = int(x.shape[1])
        m, (x, w, r, b, initial_h) = self._lib(x, w, r, b, initial_h)
        y_dirs, h_dirs = [], []
        for d, dname in enumerate(dirs):
            wd, rd = w[d], r[d]
            wb = b[d][:hid] + b[d][hid:] if b is not None else 0.0
            h = initial_h[d] if initial_h is not None \
                else m.zeros((batch, hid), x.dtype)
            state = {"h": h}

            def cell(xt, wd=wd, rd=rd, wb=wb, state=state):
                state["h"] = m.tanh(m.matmul(xt, wd.T)
                                    + m.matmul(state["h"], rd.T) + wb)
                return state["h"]

            ys = self._rnn_run(x, seq_len, dname == "reverse", cell)
            y_dirs.append(m.stack(ys))
            h_dirs.append(ys[0 if dname == "reverse" else -1])
        return m.stack(y_dirs, 1), m.stack(h_dirs)

    def op_GRU(self, node, x, w, r, b=None, sequence_lens=None,
               initial_h=None):
        if sequence_lens is not None:
            raise UnsupportedOnnxOp("GRU sequence_lens")
        self._rnn_acts(node, ["Sigmoid", "Tanh"])
        dirs, seq_len = self._rnn_common(node, x)
        lbr = node.attr("linear_before_reset", 0)
        hid = int(np.asarray(node.attr("hidden_size") or w.shape[1] // 3))
        batch = int(x.shape[1])
        m, (x, w, r, b, initial_h) = self._lib(x, w, r, b, initial_h)

        def sig(v):
            return 1.0 / (1.0 + m.exp(-v))

        y_dirs, h_dirs = [], []
        for d, dname in enumerate(dirs):
            wz, wr_, wh = (w[d][i * hid:(i + 1) * hid] for i in range(3))
            rz, rr, rh = (r[d][i * hid:(i + 1) * hid] for i in range(3))
            if b is not None:
                (wbz, wbr, wbh, rbz, rbr, rbh) = (
                    b[d][i * hid:(i + 1) * hid] for i in range(6))
            else:
                wbz = wbr = wbh = rbz = rbr = rbh = 0.0
            h = initial_h[d] if initial_h is not None \
                else m.zeros((batch, hid), x.dtype)
            state = {"h": h}

            def cell(xt, wz=wz, wr_=wr_, wh=wh, rz=rz, rr=rr, rh=rh,
                     wbz=wbz, wbr=wbr, wbh=wbh, rbz=rbz, rbr=rbr, rbh=rbh,
                     state=state):
                hp = state["h"]
                z = sig(m.matmul(xt, wz.T) + m.matmul(hp, rz.T) + wbz + rbz)
                rg = sig(m.matmul(xt, wr_.T) + m.matmul(hp, rr.T) + wbr
                         + rbr)
                if lbr:
                    n = m.tanh(m.matmul(xt, wh.T) + wbh
                               + rg * (m.matmul(hp, rh.T) + rbh))
                else:
                    n = m.tanh(m.matmul(xt, wh.T) + wbh
                               + m.matmul(rg * hp, rh.T) + rbh)
                state["h"] = (1.0 - z) * n + z * hp
                return state["h"]

            ys = self._rnn_run(x, seq_len, dname == "reverse", cell)
            y_dirs.append(m.stack(ys))
            h_dirs.append(ys[0 if dname == "reverse" else -1])
        return m.stack(y_dirs, 1), m.stack(h_dirs)

    def op_LSTM(self, node, x, w, r, b=None, sequence_lens=None,
                initial_h=None, initial_c=None, p=None):
        if sequence_lens is not None:
            raise UnsupportedOnnxOp("LSTM sequence_lens")
        if p is not None:
            raise UnsupportedOnnxOp("LSTM peepholes")
        if node.attr("input_forget", 0):
            raise UnsupportedOnnxOp("LSTM input_forget=1")
        self._rnn_acts(node, ["Sigmoid", "Tanh", "Tanh"])
        dirs, seq_len = self._rnn_common(node, x)
        hid = int(np.asarray(node.attr("hidden_size") or w.shape[1] // 4))
        batch = int(x.shape[1])
        m, (x, w, r, b, initial_h, initial_c) = self._lib(
            x, w, r, b, initial_h, initial_c)

        def sig(v):
            return 1.0 / (1.0 + m.exp(-v))

        y_dirs, h_dirs, c_dirs = [], [], []
        for d, dname in enumerate(dirs):
            # ONNX gate order: i, o, f, c.
            wi, wo, wf, wc = (w[d][i * hid:(i + 1) * hid] for i in range(4))
            ri, ro, rf, rc = (r[d][i * hid:(i + 1) * hid] for i in range(4))
            if b is not None:
                (wbi, wbo, wbf, wbc, rbi, rbo, rbf, rbc) = (
                    b[d][i * hid:(i + 1) * hid] for i in range(8))
            else:
                wbi = wbo = wbf = wbc = rbi = rbo = rbf = rbc = 0.0
            h = initial_h[d] if initial_h is not None \
                else m.zeros((batch, hid), x.dtype)
            c = initial_c[d] if initial_c is not None \
                else m.zeros((batch, hid), x.dtype)
            state = {"h": h, "c": c}

            def cell(xt, wi=wi, wo=wo, wf=wf, wc=wc, ri=ri, ro=ro, rf=rf,
                     rc=rc, wbi=wbi, wbo=wbo, wbf=wbf, wbc=wbc, rbi=rbi,
                     rbo=rbo, rbf=rbf, rbc=rbc, state=state):
                hp, cp = state["h"], state["c"]
                i_g = sig(m.matmul(xt, wi.T) + m.matmul(hp, ri.T) + wbi + rbi)
                f_g = sig(m.matmul(xt, wf.T) + m.matmul(hp, rf.T) + wbf + rbf)
                g_g = m.tanh(m.matmul(xt, wc.T) + m.matmul(hp, rc.T) + wbc
                             + rbc)
                o_g = sig(m.matmul(xt, wo.T) + m.matmul(hp, ro.T) + wbo + rbo)
                state["c"] = f_g * cp + i_g * g_g
                state["h"] = o_g * m.tanh(state["c"])
                return state["h"]

            ys = self._rnn_run(x, seq_len, dname == "reverse", cell)
            y_dirs.append(m.stack(ys))
            h_dirs.append(ys[0 if dname == "reverse" else -1])
            c_dirs.append(state["c"])
        return m.stack(y_dirs, 1), m.stack(h_dirs), m.stack(c_dirs)

    # -- normalization extras --------------------------------------------------

    def op_MeanVarianceNormalization(self, node, x):
        axes = node.attr("axes", [0, 2, 3])
        axes = tuple(int(a) % x.ndim for a in np.asarray(axes).reshape(-1))
        m, (x,) = self._lib(x)
        mu = m.mean(x, axis=axes, keepdims=True)
        var = m.mean(m.square(x), axis=axes, keepdims=True) - m.square(mu)
        return (x - mu) / m.sqrt(var + 1e-9)

    def _lp_norm(self, x, p, axes, what):
        """The L1 or L2 norm of ``x`` over ``axes``, kept dims."""
        if p not in (1, 2):
            raise UnsupportedOnnxOp(f"{what} p={p}")
        m, (x,) = self._lib(x)
        if p == 1:
            return m.sum(m.abs(x), axis=axes, keepdims=True)
        return m.sqrt(m.sum(m.square(x), axis=axes, keepdims=True))

    def op_LpNormalization(self, node, x):
        axis = node.attr("axis", -1) % x.ndim
        return x / self._lp_norm(x, node.attr("p", 2), (axis,),
                                 "LpNormalization")

    def op_GlobalLpPool(self, node, x):
        return self._lp_norm(x, node.attr("p", 2), tuple(range(2, x.ndim)),
                             "GlobalLpPool")

    def op_LpPool(self, node, x):
        p = node.attr("p", 2)
        if p not in (1, 2):
            raise UnsupportedOnnxOp(f"LpPool p={p}")
        m = _math(x)
        powered = m.abs(x) if p == 1 else m.square(x)
        out = self._pool(node, powered, "sum")
        return out if p == 1 else _math(out).sqrt(out)


def lower(model: Model | bytes | str, compute_dtype=None) -> "OnnxFunction":
    """Lower an ONNX model (path, bytes, or parsed Model) to a torch
    function. ``compute_dtype=torch.bfloat16`` runs matmuls/convs in mixed
    precision with fp32 accumulation; None is the fp32 route. A
    caller-owned Model is never mutated (the fusion pass splices in
    place), exactly as in the JAX lowering."""
    if isinstance(model, Model):
        return OnnxFunction(model, compute_dtype=compute_dtype)
    model = load_model(model)
    maybe_fuse_frontend(model, compute_dtype)
    return OnnxFunction(model, compute_dtype=compute_dtype)


def maybe_fuse_frontend(model: Model, compute_dtype) -> int:
    """Splice the fused spectrogram front-end into ``model`` when compute is
    bf16, on any device (the kernel's plain version serves the CPU); the
    fp32 route keeps the node-by-node graph. The pass is
    :func:`birda_tpu_torch.onnx.fuse.fuse_mel_frontend`, the JAX package's
    pass as it is."""
    if compute_dtype != torch.bfloat16:
        return 0
    from .fuse import fuse_mel_frontend

    return fuse_mel_frontend(model.graph)


def _subgraphs(graph):
    """Every subgraph attribute under ``graph`` (If branches, Loop and Scan
    bodies), nested ones included."""
    for n in graph.nodes:
        for a in n.attrs.values():
            if a.g is not None:
                yield a.g
                yield from _subgraphs(a.g)


class OnnxFunction:
    """A callable torch function built from an ONNX graph.

    Call with tensors matching the graph's (non-initializer) inputs; returns
    a tuple of outputs (or a single tensor if one output). Large float
    weights live in :attr:`params` (name -> numpy array) and are fed per
    call: pass ``params=`` with device tensors (see
    :func:`birda_tpu_torch.models.zoo.params_from_numpy`) to keep one copy
    on the card. Small initializers stay host numpy, so shape parameters
    fold on the host.
    """

    def __init__(self, model: Model, compute_dtype=None, evaluator=None):
        self.model = model
        self.graph = model.graph
        self._eval = (
            evaluator if evaluator is not None
            else _Evaluator(self.graph, compute_dtype=compute_dtype,
                            opset=model.opset)
        )
        if getattr(self._eval, "opset", 0) == 0:
            self._eval.opset = model.opset
        from .preflight import preflight_or_raise

        preflight_or_raise(model, evaluator=self._eval)
        init_names = set(self.graph.initializers)
        self.input_names = [
            vi.name for vi in self.graph.inputs if vi.name not in init_names
        ]
        self.output_names = [vi.name for vi in self.graph.outputs]
        self.params: dict[str, np.ndarray] = {}
        for name in list(self._eval.const):
            arr = self._eval.const[name]
            if (
                name in init_names
                and isinstance(arr, np.ndarray)
                and (arr.dtype.kind == "f"
                     or (arr.dtype.kind in "iu" and arr.dtype.itemsize == 1))
                and arr.nbytes >= LIFT_PARAM_BYTES
            ):
                self.params[name] = self._eval.const.pop(name)
        # Large float initializers inside If/Loop/Scan bodies lift too,
        # under the JAX lowering's names (so a params dict carries between
        # the two packages); they reach the bodies through the outer
        # environment. A name the top level already holds stays inline.
        for sub in _subgraphs(self.graph):
            for name, t in sub.initializers.items():
                arr = t.array
                if (name and name not in self.params
                        and name not in self._eval.const
                        and isinstance(arr, np.ndarray)
                        and arr.dtype.kind == "f"
                        and arr.nbytes >= LIFT_PARAM_BYTES):
                    self.params[name] = arr
                    self._eval.lifted_params.add(name)

    def input_info(self):
        """The graph's value infos of its fed (non-initializer) inputs."""
        return [vi for vi in self.graph.inputs if vi.name in self.input_names]

    def prepare(self, params: dict[str, torch.Tensor]) -> None:
        """Lay out the weights of every front-end that runs a CUDA kernel
        now (once, at load) rather than on the first call: each fused
        front-end's DFT weight and filterbank, and, in bf16, each
        single-channel long-kernel Conv1d weight, where the kernel can hold
        the node's geometry at any signal of at least one window."""
        bf16 = self._eval.compute_dtype == torch.bfloat16
        for node in self.graph.nodes:
            if node.op_type == "BirdaFusedMelFrontend":
                w, fb = (params.get(n, self._eval.const.get(n))
                         for n in node.inputs[1:3])
                dev = _device_of(w, fb)
                (c, _, k), m = w.shape, fb.shape[1]
                if dev.type == "cuda" and stft_conv.logmel_kernel_fits(
                        k, k, node.attr("hop"), c, m):
                    self._eval._logmel_layout(w, fb, dev)
            elif node.op_type == "Conv" and bf16 and len(node.inputs) > 1:
                w = params.get(node.inputs[1])
                hop = (node.attr("strides") or [1])[0]
                if (isinstance(w, torch.Tensor) and w.device.type == "cuda"
                        and w.ndim == 3 and w.shape[1] == 1
                        and w.shape[2] >= 256
                        and stft_conv.conv1d_kernel_fits(
                            w.shape[2], w.shape[2], hop, w.shape[0])):
                    self._eval._conv1d_layout(node.outputs[0], w,
                                               w.device)

    def __call__(self, *args, params=None, **feeds):
        if args:
            feeds = dict(zip(self.input_names, args)) | feeds
        missing = [n for n in self.input_names if n not in feeds]
        if missing:
            raise ValueError(f"missing graph inputs: {missing}")
        feeds = {k: torch.from_numpy(_host_array(v)) if _is_host(v) else v
                 for k, v in feeds.items()}
        env = dict(params if params is not None else self.params)
        env.update(feeds)
        env = self._eval.run(env)
        outs = tuple(env[n] for n in self.output_names)
        return outs[0] if len(outs) == 1 else outs
