"""ONNX graph -> PyTorch function: the port of ``birda_tpu/onnx/lowering.py``.

A parsed :class:`~birda_tpu_torch.onnx.proto.Model` runs node by node over an
environment of values, the same design as the JAX evaluator:

- Host constants stay numpy. A node whose inputs are all host values is
  folded on the host with numpy (shape, slice and reshape parameters stay
  plain integers), exactly as the JAX evaluator folds them.
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
  dtypes), Python scalars stay weak.
- Integer operands of Conv, MatMul and Gemm (the int8 path of
  :mod:`birda_tpu_torch.onnx.quantize`) accumulate exactly in int32, the
  JAX route's ``preferred_element_type=int32``: :func:`int_conv` and
  :func:`int_matmul` pick a route by static shape (``torch._int_mm`` on the
  card, an fp32 product only where every partial sum is an exact integer,
  float64 products on the CPU) and never round.

The op set is what the full-scale BirdNET v2.4 / v3.0 and Perch v2 graphs
(:mod:`birda_tpu_torch.onnx.fullscale`) emit, plus the fused spectrogram
front-end ``BirdaFusedMelFrontend`` that :func:`maybe_fuse_frontend` splices
in for bf16 compute. In bf16 two hand-written CUDA kernels carry the
front-ends: the fused node runs ``ops/stft_conv.py::fused_logmel``, and a
single-channel long-kernel Conv1d the fusion pass did not take (the unfused
Conv1d-STFT, Perch v2's framing conv) runs ``ops/stft_conv.py::conv1d_stft``.
A graph outside the op set fails at load with the full list
(``preflight_or_raise``).
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
from .proto import Model, load_model
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
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("no tensor operand")


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
#: ``torch._int_mm`` on the card (cuBLASLt, int8 -> int32) takes more than 16
#: rows, and inner and output widths that are multiples of 8.
INT_MM_MIN_ROWS = 17
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
    to the weight's padded depth and to INT_MM_MIN_ROWS rows, and the result
    sliced back."""
    m, k = a.shape
    kp = b.shape[0]
    pm = max(m, INT_MM_MIN_ROWS) - m
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
        return _conv_float(x, prepared, strides, pads, dilations, group)
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
    """An int8 conv computed in ``w``'s float dtype (TF32 off) and returned
    as int32: exact where every partial sum is an exactly held integer."""
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
        #: Per-thread state (the compute-cast suppression).
        self._tls = threading.local()
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
        #: Conv1d-STFT kernel weight layouts: (id(w), device) -> (w, layout).
        self._conv1d_layouts: dict[tuple, tuple] = {}
        #: int8 weights laid out for their integer route: (id(w), route) ->
        #: (w, layout).
        self._int_layouts: dict[tuple, tuple] = {}

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
        env[""] = None
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
                result = handler(node, *args)
                if not isinstance(result, tuple):
                    result = (result,)
                for out_name, val in zip(node.outputs, result):
                    if out_name:
                        env[out_name] = self._store(out_name, val)
        return env

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

    def _binary(self, np_fn, torch_fn, a, b):
        if _is_host(a) and _is_host(b):
            return np_fn(a, b)
        dev = _device_of(a, b)
        a, b = self._operand(a, dev), self._operand(b, dev)
        if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype != b.dtype and 0 in (a.dim(), b.dim())):
            # torch lets a 0-d tensor take the other operand's dtype
            # category; jax.numpy promotes on the dtypes alone.
            dt = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(dt), b.to(dt)
        return torch_fn(a, b)

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

    def op_Sqrt(self, node, x):
        return np.sqrt(x) if _is_host(x) else torch.sqrt(x)

    def op_Log(self, node, x):
        return np.log(x) if _is_host(x) else torch.log(x)

    def op_Sigmoid(self, node, x):
        if _is_host(x):
            z = np.asarray(x).astype(np.float64)
            return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)
        return torch.sigmoid(x)

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

    # -- shape / structure ---------------------------------------------------

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
        """Axes from the input, else the attribute; empty or absent axes
        follow ``noop_with_empty_axes`` (None = every axis)."""
        if axes is None:
            axes = node.attr("axes")
        if axes is not None:
            nd = np.ndim(x)
            t = tuple(int(a) % nd for a in np.asarray(axes).reshape(-1))
            if t:
                return t
        return self._REDUCE_NOOP if node.attr("noop_with_empty_axes", 0) \
            else None

    @staticmethod
    def _mean(x, axes, keepdims: bool):
        """jnp.mean's arithmetic: fp32 accumulation, result at the input's
        float dtype."""
        dims = axes if axes is not None else tuple(range(x.ndim))
        return x.float().mean(dim=dims, keepdim=keepdims).to(x.dtype)

    def op_ReduceMean(self, node, x, axes=None):
        plan = self._reduce_plan(node, x, axes)
        if plan is self._REDUCE_NOOP:
            return x
        keepdims = bool(node.attr("keepdims", 1))
        if _is_host(x):
            return np.mean(x, axis=plan, keepdims=keepdims)
        return self._mean(x, plan, keepdims)

    def op_GlobalAveragePool(self, node, x):
        axes = tuple(range(2, np.ndim(x)))
        if _is_host(x):
            return np.mean(x, axis=axes, keepdims=True)
        return self._mean(x, axes, True)

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
        """Exact int32 product of int8 ``a [..., K]`` and ``b [K, N]``."""
        if a.dtype != torch.int8 or b.dtype != torch.int8 or b.ndim != 2:
            raise UnsupportedOnnxOp(
                f"integer product of {a.dtype} [{tuple(a.shape)}] and "
                f"{b.dtype} [{tuple(b.shape)}]: only int8 [.., K] x [K, N] "
                "has an exact route")
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
                # The hand-written kernel (bf16 operands, fp32 sums, bf16
                # [B, C, T] out); the bias joins after it in bf16, as on
                # the JAX package's kernel path.
                layout = self._conv1d_layout(w, dev) if dev.type == "cuda" \
                    else None
                out = stft_conv.conv1d_stft(
                    self._tensor(x, dev)[:, 0, :],
                    self._tensor(w, dev)[:, 0, :], hop, prepared=layout)
                if b is not None:
                    out = out + self._tensor(b, dev, out.dtype).reshape(
                        1, -1, 1)
                return out
            # fp32: strided frames as an unfold view times the weight
            # matrix, one plain matmul (the JAX fp32 route's gather form).
            xx, wm = self._mm_cast(dev, x[:, 0, :], w[:, 0, :])
            frames = xx.unfold(-1, k, hop)  # [B, T, k]
            out = self._contract(lambda f, m: torch.matmul(f, m.T),
                                 frames, wm).transpose(1, 2)
            return self._mm_out(self._bias(out, b, 1))
        x, w = self._mm_cast(dev, x, w)
        if x.is_floating_point() != w.is_floating_point():
            raise UnsupportedOnnxOp(
                f"Conv (node '{node.name}') of {x.dtype} input and {w.dtype} "
                "weight")
        if not x.is_floating_point():
            # Integer conv (the int8 path): exact int32 sums, no compute-dtype
            # output cast, as the JAX route's preferred_element_type=int32.
            out = self._int_conv(x, w, strides, pads, dilations, group)
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
        layout = self._logmel_layout(w, fb, dev) if dev.type == "cuda" \
            else None
        wm = self._tensor(w, dev)[:, 0, :]
        return stft_conv.fused_logmel(sig, wm, self._tensor(fb, dev),
                                      hop=hop, eps=eps, prepared=layout)

    def _conv1d_layout(self, w, device):
        """The Conv1d-STFT kernel's layout of this conv's weight, made once
        per weight."""
        key = (id(w), device)
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

    def prepare(self, params: dict[str, torch.Tensor]) -> None:
        """Lay out the weights of every front-end that runs a CUDA kernel
        now (once, at load) rather than on the first call: each fused
        front-end's DFT weight and filterbank, and, in bf16, each
        single-channel long-kernel Conv1d weight."""
        bf16 = self._eval.compute_dtype == torch.bfloat16
        for node in self.graph.nodes:
            if node.op_type == "BirdaFusedMelFrontend":
                w, fb = (params.get(n, self._eval.const.get(n))
                         for n in node.inputs[1:3])
                dev = _device_of(w, fb)
                if dev.type == "cuda":
                    self._eval._logmel_layout(w, fb, dev)
            elif node.op_type == "Conv" and bf16 and len(node.inputs) > 1:
                w = params.get(node.inputs[1])
                if (isinstance(w, torch.Tensor) and w.device.type == "cuda"
                        and w.ndim == 3 and w.shape[1] == 1
                        and w.shape[2] >= 256):
                    self._eval._conv1d_layout(w, w.device)

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
