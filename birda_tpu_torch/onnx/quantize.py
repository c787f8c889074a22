"""Post-training int8 quantization: the port of ``birda_tpu/onnx/quantize.py``.

Any float ONNX graph gains two calibrated 8-bit modes from a calibration pass
over representative inputs (the TensorRT-int8 engine analogue; the
reference caches those engines, ``src/inference/classifier.rs:994-1057``):

- **Weights**: per-output-channel symmetric int8 (``scale = amax(|w|)/127``,
  no zero point), half the bf16 footprint.
- **Activations**: per-tensor symmetric int8 with a *static* scale from the
  calibration pass (max or percentile of ``|x|`` over calibration batches),
  with SmoothQuant-style per-channel rebalancing folded into the weights.
- **Compute** (``--precision int8``): int8 x int8 -> exact int32 sums
  through :func:`birda_tpu_torch.onnx.lowering.int_conv` /
  :func:`~birda_tpu_torch.onnx.lowering.int_matmul` (``torch._int_mm`` on
  the card); the int32 result dequantizes with the combined per-channel
  scale in fp32, the bias adds in float, and the graph continues at the
  compute dtype (bf16), exactly as ``--precision bf16`` does.
- **Storage only** (``--precision mixed``, ``boundary_store="storage"``):
  nothing quantizes; the large boundary streams are stored int8 and every
  reader dequantizes them.

The selection rules, the boundary-storage policies, the weight
quantization and the calibration statistics are the JAX package's, copied
as they are (see there for the reasoning behind each guard), so that both
packages choose the same nodes and the same int8 weights for the same
graph and calibration. What is PyTorch here: the calibration statistics
(reduced on the runner's device, one copy to the host per batch), the int8
evaluator, and the cost report, which runs the evaluator on ``meta``
tensors (shapes only).

Calibration inputs should be representative audio;
:func:`calibration_signals` synthesizes a built-in set (pink noise + chirps
at realistic levels) for when none is provided, and the orchestrator accepts
``--calibration-audio`` to calibrate on the user's own recordings.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from .lowering import OnnxFunction, _dtype_kind, _Evaluator, _is_host
from .proto import Model, load_model

QMAX = 127.0
#: Weights below this size stay float: the dequant epilogue costs more than
#: the tiny matmul saves — UNLESS the node's activation is large (see
#: DEFAULT_MIN_ACT_ELEMS): int8's real win on bandwidth-bound backbones is
#: activation bytes, and the early small-channel convs pair tiny weights
#: with the graph's LARGEST activations (v2.4 stem: 1,152 B of weights
#: against a 786k-element/sample input image).
DEFAULT_MIN_WEIGHT_BYTES = 4096
#: Activation-size eligibility gate (``min_act_elems``): a node whose
#: calibrated per-sample activation has at least this many elements
#: quantizes even when its weight is below DEFAULT_MIN_WEIGHT_BYTES — the
#: fusion-boundary byte savings scale with the activation, not the weight.
#: **Off by default** (None): measured on the v2.4 full-scale graph
#: (round-3 boundary A/B, docs/performance.md), widening eligibility to
#: the early small-weight convs LOST 1.6–2.2% — the quantize epilogues on
#: the graph's largest tensors (and int8 depthwise on the VPU) cost more
#: than the saved bytes on this platform. Kept as an opt-in experiment
#: knob; 16_384 is the value that separates spatial backbone tensors from
#: SE squeezes and head matmuls if enabled.
DEFAULT_MIN_ACT_ELEMS = 16_384
#: Skip quantizing a node when the calibrated ``mean(|x|)`` is below this
#: many quantization steps (LSB = scale = amax/127): the grid spends its 7
#: magnitude bits on the outliers and rounds the bulk of the tensor to
#: zero. Post-norm backbone activations measure 5-30 mean-LSBs; pre-log
#: power spectra measure well under 1.
DEFAULT_MIN_MEAN_LSB = 1.0


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------


def _structurally_eligible(graph, node) -> str | None:
    """Weight-initializer name if ``node`` can execute int8, else None."""
    if node.op_type not in ("Conv", "MatMul", "Gemm") or len(node.inputs) < 2:
        return None
    if node.inputs[0] in graph.initializers:
        return None  # constant activation: host-folded, nothing to win
    t = graph.initializers.get(node.inputs[1])
    arr = None if t is None else t.array
    if arr is None or arr.dtype.kind != "f":
        return None
    if node.op_type == "Conv" and arr.ndim == 3 and arr.shape[1] == 1 \
            and arr.shape[2] >= 256:
        return None  # Conv1d-STFT / framer DSP front-end stays float
    if node.op_type == "Gemm" and node.attr("transA", 0):
        return None
    if node.op_type == "MatMul" and arr.ndim != 2:
        return None
    return node.inputs[1]


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


@dataclass
class CalibrationResult:
    """Per-tensor activation statistics from a calibration run.

    ``stats`` maps tensor name ->
    ``{"amax", "pctl", "amean", "ndim", "aelems", "chamax"}``; the activation scale
    is ``amax/127`` (method "max") or ``pctl/127`` (method "percentile" —
    clips the outlier tail, finer grid for the bulk). ``chamax`` is the
    per-channel |x| max (channel = axis 1), feeding the SmoothQuant-style
    outlier rebalancing in :func:`lower_int8`.
    """

    method: str
    percentile: float
    batches: int
    stats: dict

    def scale(self, name: str) -> float | None:
        s = self.stats.get(name)
        if s is None:
            return None
        src = s["pctl"] if self.method == "percentile" else s["amax"]
        return max(float(src) / QMAX, 1e-12)

    def to_json(self) -> str:
        return json.dumps({
            "version": 1, "method": self.method,
            "percentile": self.percentile, "batches": self.batches,
            "stats": self.stats,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationResult":
        d = json.loads(text)
        return cls(method=d["method"], percentile=d["percentile"],
                   batches=d["batches"], stats=d["stats"])


def _percentile(xa: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(xa, q)`` (linear interpolation between the two
    nearest ranks) of a flattened tensor, from its top ``n - floor(pos)``
    values: ``torch.quantile`` refuses inputs above 2^24 elements, which
    full-scale activations at calibration batch 8 exceed."""
    flat = xa.reshape(-1)
    n = flat.numel()
    pos = q / 100.0 * (n - 1)
    lo = int(np.floor(pos))
    top = torch.topk(flat, n - lo, sorted=True).values  # top[-1] = rank lo
    low = top[-1]
    high = top[-2] if lo + 1 < n else low
    return low + (high - low) * (pos - lo)


class _CaptureEvaluator(_Evaluator):
    """Float evaluator recording activation stats at eligible node inputs
    — plus every *large* device intermediate (``_store`` hook), so the
    ``boundary_store="all"`` policy can int8-materialize tensors no
    matmul/conv ever reads (SE pool/gate streams).

    The statistics of one run stay on the device as tensors;
    :meth:`host_stats` copies them to the host in one transfer, and
    :func:`calibrate` reduces them across batches there.
    """

    def __init__(self, graph, targets: set, percentile: float):
        super().__init__(graph)
        self.targets = targets
        self.percentile = percentile
        self.captured: dict = {}
        self.ndims: dict = {}   # static, recorded at run time
        self.aelems: dict = {}  # per-sample activation elements (static)
        self._out_names = {vi.name for vi in graph.outputs}

    def _store(self, name, val):
        # Large-intermediate capture (beyond the eligible node inputs
        # recorded by ``_record``): any big float device tensor gets stats
        # so lower_int8's "all" policy can boundary-store it. Graph
        # outputs never store; targets are recorded at their consumer.
        if (val is not None and not _is_host(val)
                and getattr(val, "ndim", 0) >= 2
                and _dtype_kind(val) == "f"
                and name not in self.targets
                and name not in self._out_names
                and int(np.prod(val.shape[1:])) >= DEFAULT_MIN_ACT_ELEMS):
            self._record_value(name, val)
        return val

    def _record(self, node, x):
        name = node.inputs[0]
        if name not in self.targets or x is None or _is_host(x):
            return
        self._record_value(name, x)

    def _record_value(self, name, x):
        xa = x.float().abs()
        amax = xa.max()
        pctl = _percentile(xa, self.percentile)
        amean = xa.mean()
        # Per-channel |x| max (channel = axis 1 for both NCHW activations
        # and [batch, features] matmul inputs) for outlier rebalancing.
        ch_axes = tuple(a for a in range(x.ndim) if a != 1)
        chamax = xa.amax(dim=ch_axes) if x.ndim >= 2 else xa
        prev = self.captured.get(name)
        if prev is not None:  # same tensor feeds several eligible nodes
            amax = torch.maximum(amax, prev[0])
            pctl = torch.maximum(pctl, prev[1])
            amean = torch.maximum(amean, prev[2])
            chamax = torch.maximum(chamax, prev[3])
        self.captured[name] = (amax, pctl, amean, chamax)
        self.ndims[name] = int(x.ndim)
        # Per-sample element count: the activation-size eligibility gate in
        # lower_int8 keys on this.
        self.aelems[name] = int(np.prod(x.shape[1:])) if x.ndim >= 1 else 1

    def host_stats(self) -> dict:
        """This run's statistics on the host, ``name -> (amax, pctl, amean,
        chamax)`` as float32 numpy, through one device-to-host copy."""
        names = list(self.captured)
        if not names:
            return {}
        parts = []
        for name in names:
            amax, pctl, amean, chamax = self.captured[name]
            parts += [torch.stack([amax, pctl, amean]), chamax.reshape(-1)]
        flat = torch.cat(parts).cpu().numpy()
        out, i = {}, 0
        for name in names:
            c = self.captured[name][3].numel()
            out[name] = (flat[i], flat[i + 1], flat[i + 2],
                         flat[i + 3:i + 3 + c].reshape(
                             self.captured[name][3].shape))
            i += 3 + c
        return out

    def op_Conv(self, node, x, w, b=None):
        self._record(node, x)
        return super().op_Conv(node, x, w, b)

    def op_MatMul(self, node, a, b):
        self._record(node, a)
        return super().op_MatMul(node, a, b)

    def op_Gemm(self, node, a, b, c=None):
        self._record(node, a)
        return super().op_Gemm(node, a, b, c)


def calibrate(
    model: Model | bytes | str,
    batches,
    params: dict | None = None,
    method: str = "max",
    percentile: float = 99.9,
    min_weight_bytes: int = DEFAULT_MIN_WEIGHT_BYTES,
    device: str | torch.device = "cuda",
) -> CalibrationResult:
    """Run calibration batches through the float graph at fp32 (TF32 off),
    collecting activation ranges at every quantization-eligible node input.

    ``batches`` is an iterable of input arrays or tensors (single-input
    graphs) or tuples matching the graph's input order. The graph and its
    weights run on ``device`` (the card unless the caller asks for the
    CPU); the statistics are reduced there and copied to the host once per
    batch. ``params`` overrides the lifted weights (arrays or tensors;
    pass copies already on ``device`` to avoid copying them again), as in
    the JAX package.
    """
    if method not in ("max", "percentile"):
        raise ValueError(f"unknown calibration method {method!r}")
    if not isinstance(model, Model):
        model = load_model(model)
    graph = model.graph
    # Record stats for EVERY structurally eligible node — selection happens
    # in lower_int8, where both size gates (weight bytes OR activation
    # elements) need the stats to decide. ``min_weight_bytes`` is kept for
    # the JAX package's signature but no longer prunes the capture set.
    del min_weight_bytes
    targets = set()
    for node in graph.nodes:
        if _structurally_eligible(graph, node) is not None:
            targets.add(node.inputs[0])

    ev = _CaptureEvaluator(graph, targets, percentile)
    fn = OnnxFunction(model, evaluator=ev)
    dev = torch.device(device)
    if params is None:
        params = fn.params
    params = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.require(v, requirements=["C", "W"]))).to(dev)
        for k, v in params.items()}

    agg: dict = {}
    n = 0
    with torch.inference_mode():
        for batch in batches:
            xs = batch if isinstance(batch, tuple) else (batch,)
            xs = tuple(torch.as_tensor(np.asarray(x, np.float32)
                                       if not isinstance(x, torch.Tensor)
                                       else x).to(dev) for x in xs)
            ev.captured = {}
            fn(*xs, params=params)
            out = ev.host_stats()
            n += 1
            for name, (amax, pctl, amean, chamax) in out.items():
                a, p_, m, c = agg.get(name, (0.0, 0.0, 0.0, None))
                cm = np.asarray(chamax, np.float64)
                # amax/pctl/chamax are extremes (max across batches); amean
                # is the guard's "typical element" statistic, so it averages
                # — one loud batch must not mask a mostly-quiet calibration
                # set.
                agg[name] = (max(a, float(amax)), max(p_, float(pctl)),
                             m + float(amean),
                             cm if c is None else np.maximum(c, cm))
    stats = {
        name: {
            "amax": a, "pctl": p_, "amean": m / max(n, 1),
            "ndim": ev.ndims.get(name, 0),
            "aelems": ev.aelems.get(name, 0),
            # rounded to 6 significant digits: keeps the cached JSON small
            # without moving any scale that matters
            "chamax": [float(f"{v:.6g}") for v in np.atleast_1d(c)],
        }
        for name, (a, p_, m, c) in agg.items()
    }
    return CalibrationResult(method=method, percentile=percentile,
                             batches=n, stats=stats)


def calibration_signals(
    sample_count: int, batch: int = 8, n_batches: int = 4, seed: int = 17
):
    """Built-in calibration set: pink noise + random chirps at realistic
    PCM levels (log-uniform peaks 0.003-0.9), yielding ``n_batches`` arrays
    of ``[batch, sample_count]`` float32.

    Representative *user* audio is better (``--calibration-audio``); this
    covers the no-assets case with the right spectral tilt — bioacoustic
    recordings are pink-ish with sparse tonal foreground.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(sample_count, dtype=np.float64)
    for _ in range(n_batches):
        rows = []
        for _ in range(batch):
            spec = np.fft.rfft(rng.standard_normal(sample_count))
            f = np.maximum(np.arange(spec.size), 1.0)
            pink = np.fft.irfft(spec / np.sqrt(f), n=sample_count)
            pink /= max(np.max(np.abs(pink)), 1e-12)
            sig = pink * rng.uniform(0.2, 1.0)
            for _ in range(rng.integers(0, 4)):
                f0 = rng.uniform(0.002, 0.35)  # cycles/sample
                sweep = rng.uniform(-0.3, 0.3) * f0 / sample_count
                amp = 10 ** rng.uniform(-2.0, 0.0)
                sig = sig + amp * np.sin(
                    2 * np.pi * (f0 * t + 0.5 * sweep * t * t))
            peak = 10 ** rng.uniform(-2.5, -0.05)  # 0.003 .. 0.9
            sig *= peak / max(np.max(np.abs(sig)), 1e-12)
            rows.append(sig.astype(np.float32))
        yield np.stack(rows)


def cached_calibration(model_bytes: bytes, sample_count: int,
                       device: str | torch.device = "cuda"):
    """Synthetic-set calibration memoized per graph digest under the cache
    dir — the TensorRT engine-cache discipline applied to calibration
    scales (reference ``src/inference/classifier.rs:994-1057``). Returns
    ``(CalibrationResult, loaded_from_cache)``. The file name and the JSON
    are the JAX package's, so a cache written by either package serves the
    other.
    """
    import hashlib

    from ..config.paths import cache_dir
    from ..utils.fs import write_atomic

    sha = hashlib.sha256(model_bytes).hexdigest()
    # Keyed on graph digest AND calibration input length (the same graph
    # calibrated at another sample_count has different activation ranges).
    cpath = cache_dir() / "int8_calib" / f"{sha[:24]}-{sample_count}-max-v3b.json"
    if cpath.exists():
        try:
            return CalibrationResult.from_json(cpath.read_text()), True
        except (OSError, ValueError, KeyError):
            pass  # unreadable/stale cache: recalibrate
    calib = calibrate(model_bytes, calibration_signals(sample_count),
                      device=device)
    cpath.parent.mkdir(parents=True, exist_ok=True)
    write_atomic(cpath, calib.to_json().encode())
    return calib, False


# ---------------------------------------------------------------------------
# Quantized execution
# ---------------------------------------------------------------------------


def _smoothing_vectors(graph, calibration, selected, by_weight, qualified,
                       alpha) -> dict:
    """SmoothQuant-style rebalancing vectors, keyed by activation tensor.

    Per-tensor activation quantization spends its 7 magnitude bits on the
    loudest *channel*; when channels differ by orders of magnitude the
    quiet ones quantize to noise. The cure is a pure rescaling: divide the
    activation by ``s_c = a_c^alpha / w_c^(1-alpha)`` per channel and
    multiply the consumer weight's input-channel axis by the same ``s_c``
    — mathematically identity, but the activation grid now covers every
    channel and the imbalance moves into the per-channel weight scales,
    which are already per-channel quantized. (SmoothQuant, Xiao et al.;
    applied here at PTQ time, folded fully into the lowered weights.)

    A weight consumed from several different activation tensors cannot
    fold one vector; smoothing is disabled for those activations.
    """
    if alpha is None:
        return {}
    by_act: dict = {}
    for _key, (node, wname, tr) in selected.items():
        if wname in qualified:
            by_act.setdefault(node.inputs[0], []).append((node, wname, tr))
    banned = set()
    for wname in qualified:
        anames = {n.inputs[0] for n, _tr in by_weight[wname]}
        if len(anames) > 1:
            banned |= anames
    out: dict = {}
    for aname, users in by_act.items():
        if aname in banned:
            continue
        st = calibration.stats.get(aname)
        cha = None if st is None else st.get("chamax")
        if not cha:
            continue
        a_c = np.asarray(cha, np.float32)
        w_c = None
        ok = True
        for node, wname, tr in users:
            w = graph.initializers[wname].array.astype(np.float32)
            if tr == "gemm-tb":
                w = np.ascontiguousarray(w.T)
            if tr == "conv":
                group = node.attr("group", 1)
                if w.shape[1] * group != a_c.size:
                    ok = False
                    break
                if group == 1:
                    wa = np.max(np.abs(w),
                                axis=(0,) + tuple(range(2, w.ndim)))
                elif w.shape[1] == 1 and w.shape[0] == a_c.size:
                    # depthwise, channel multiplier 1: out channel == in
                    # channel. Multiplier > 1 (out = in*m) passes the
                    # group gate above but its per-out-channel maxima
                    # cannot fold into per-in-channel activation scales.
                    wa = np.max(np.abs(w), axis=tuple(range(1, w.ndim)))
                else:  # grouped non-depthwise: channel bookkeeping not worth it
                    ok = False
                    break
            else:
                if w.shape[0] != a_c.size:
                    ok = False
                    break
                wa = np.max(np.abs(w), axis=1)
            w_c = wa if w_c is None else np.maximum(w_c, wa)
        if not ok or w_c is None:
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.power(a_c, alpha) / np.power(w_c, 1.0 - alpha)
        s[~np.isfinite(s)] = 1.0
        s[(a_c <= 0) | (w_c <= 0)] = 1.0
        out[aname] = np.clip(s, 1e-3, 1e3).astype(np.float32)
    return out


class _Int8Evaluator(_Evaluator):
    """Evaluator executing selected Conv/MatMul/Gemm nodes as int8 x int8
    -> int32 with a float dequant epilogue; everything else runs exactly as
    the base evaluator at ``compute_dtype``.

    Tensors in ``store_int8`` are materialized as int8 where they are
    produced (one byte per element). Quantized consumers read the int8 raw
    (skipping their own quantize step); every other reader gets a
    dequantize-on-read via ``_fetch``. The set is chosen by
    :func:`lower_int8`'s ``boundary_store`` policy. In eager PyTorch each
    quantize and dequantize is its own pass over the tensor (XLA fused them
    into the neighbouring ops).
    """

    def __init__(self, graph, qnodes: set, ascale: dict, wscale: dict,
                 compute_dtype, store_int8: set | None = None,
                 asmooth: dict | None = None):
        super().__init__(graph, compute_dtype=compute_dtype)
        self._qnodes = qnodes    # node.outputs[0] of int8-executed nodes
        self._ascale = ascale    # activation tensor name -> float scale
        self._wscale = wscale    # weight name -> np.float32 [out_channels]
        self._store_int8 = store_int8 or set()  # boundary-stored tensors
        self._asmooth = asmooth or {}  # tensor name -> per-channel divisor
        #: When set to a dict, static cost accounting lands here (see
        #: :func:`int8_cost_report`); None = no accounting overhead.
        self.cost: dict | None = None
        #: Host scale vectors made once each (by kind, name and rank) and
        #: then copied to the device once, like the graph's constants.
        self._scales: dict = {}

    def _acct(self, key: str, n):
        if self.cost is not None:
            n = int(n)
            self.cost[key] = self.cost.get(key, 0) + n

    def _scale(self, key: tuple, make) -> np.ndarray:
        arr = self._scales.get(key)
        if arr is None:
            arr = self._scales[key] = np.ascontiguousarray(make(),
                                                           np.float32)
            self._persistent.add(id(arr))
        return arr

    def _qact(self, x, name: str):
        if _dtype_kind(x) == "i":
            return x  # already materialized int8 at the producer boundary
        self._acct("quantize_elems", x.numel())
        mult = np.float32(1.0 / self._ascale[name])
        sm = self._asmooth.get(name)
        xf = x.float()
        if sm is None:
            q = torch.round(xf * float(mult))
        else:  # SmoothQuant: per-channel divide, folded here
            m = self._scale(("qmult", name, x.ndim), lambda: (
                mult / sm).astype(np.float32).reshape(
                    (1, -1) + (1,) * (x.ndim - 2)))
            q = torch.round(xf * self._tensor(m, x.device))
        return q.clamp_(-QMAX, QMAX).to(torch.int8)

    def _store(self, name, val):
        if (name in self._store_int8 and val is not None
                and not _is_host(val) and _dtype_kind(val) == "f"):
            val = self._qact(val, name)
            self._acct("boundary_int8_bytes", val.numel())
        if (self.cost is not None and val is not None and not _is_host(val)
                and hasattr(val, "dtype")):
            self._acct("act_bytes", val.numel() * val.element_size())
        return val

    def _fetch(self, node, pos, name, val):
        """Boundary-stored int8 tensors reach quantized consumers raw (they
        accumulate from int8 directly); every other reader — residual Adds,
        SE pools/Muls, shape ops — gets the dequantized float."""
        if (name in self._store_int8 and val is not None
                and not _is_host(val) and _dtype_kind(val) == "i"):
            if (pos == 0 and node.op_type in ("Conv", "MatMul", "Gemm")
                    and node.outputs and node.outputs[0] in self._qnodes):
                return val
            self._acct("fetch_dequant_elems", val.numel())
            out = self._deq_act(val, name)
            # At the bf16 compute dtype, keep the dequantized tensor bf16 so
            # downstream elementwise chains stay at 2 B/element (the int8
            # grid is coarser than bf16's mantissa anyway).
            if self.compute_dtype is not None:
                out = out.to(self.compute_dtype)
            return out
        return val

    def op_Conv(self, node, x, w, b=None):
        if node.outputs[0] not in self._qnodes:
            return super().op_Conv(node, x, w, b)
        sw = self._wscale[node.inputs[1]]
        spatial = np.ndim(w) - 2
        if _is_host(x):  # safety net: dequantized-weight float path
            return super().op_Conv(node, x, self._deq_weight(node, w, "conv"),
                                   b)
        sx = self._ascale[node.inputs[0]]
        xq = self._qact(x, node.inputs[0])
        with self._no_compute_cast():  # int path: no bf16 casts inside
            acc = super().op_Conv(node, xq, w, None)  # int32 accumulation
        k_red = np.prod(w.shape[1:])  # C_in/group × prod(kernel)
        self._acct("macs", acc.numel() * int(k_red))
        self._acct("dequant_elems", acc.numel())
        scale = self._scale(("conv", node.outputs[0]), lambda: (
            np.float32(sx) * sw).reshape((1, -1) + (1,) * spatial))
        # int32 times a float32 tensor: converted and scaled in one pass.
        out = acc * self._tensor(scale, acc.device)
        if b is not None:
            out = out + self._tensor(b, acc.device, torch.float32).reshape(
                (1, -1) + (1,) * spatial)
        return self._mm_out(out)

    def _int8_matmul(self, node, a, wq):
        sx = self._ascale[node.inputs[0]]
        sw = self._wscale[node.inputs[1]]
        aq = self._qact(a, node.inputs[0])
        acc = self._int_matmul(aq, self._tensor(wq, aq.device))
        self._acct("macs", acc.numel() * int(np.shape(wq)[0]))
        self._acct("dequant_elems", acc.numel())
        scale = self._scale(("mat", node.outputs[0]),
                            lambda: np.float32(sx) * sw)
        return acc * self._tensor(scale, acc.device)

    def _deq_act(self, a, name):
        """Undo a boundary int8 materialization (safety nets only)."""
        if not _is_host(a) and _dtype_kind(a) == "i":
            # int8 times a Python float: float32, converted in the same pass
            out = a * float(np.float32(self._ascale[name]))
            sm = self._asmooth.get(name)
            if sm is not None:
                out = out * self._tensor(self._scale(
                    ("smooth", name, a.ndim),
                    lambda: sm.reshape((1, -1) + (1,) * (a.ndim - 2))),
                    a.device)
            return out
        return a

    def _deq_weight(self, node, w, kind: str):
        """Recover the ORIGINAL float weight from a stored int8 one
        (safety nets only): undo the per-output-channel quantization AND
        the SmoothQuant fold on the input-channel axis."""
        sw = self._wscale[node.inputs[1]]
        host = _is_host(w)
        wf = np.asarray(w, np.float32) if host else w.float()

        def arr(v):
            v = np.ascontiguousarray(v, np.float32)
            return v if host else torch.from_numpy(v).to(wf.device)

        sm = self._asmooth.get(node.inputs[0])
        if kind == "conv":
            wf = wf * arr(sw.reshape((-1,) + (1,) * (wf.ndim - 1)))
            if sm is not None:
                if node.attr("group", 1) == 1:
                    wf = wf / arr(sm.reshape((1, -1) + (1,) * (wf.ndim - 2)))
                else:  # depthwise
                    wf = wf / arr(sm.reshape((-1, 1) + (1,) * (wf.ndim - 2)))
        else:  # [K, N]: sw per output column, sm per input row
            wf = wf * arr(sw)
            if sm is not None:
                wf = wf / arr(sm[:, None])
        return wf

    def op_MatMul(self, node, a, b):
        if node.outputs[0] not in self._qnodes:
            return super().op_MatMul(node, a, b)
        if _is_host(a) or a.ndim != 2:  # safety net
            return super().op_MatMul(node, self._deq_act(a, node.inputs[0]),
                                     self._deq_weight(node, b, "mat"))
        return self._mm_out(self._int8_matmul(node, a, b))

    def op_Gemm(self, node, a, b, c=None):
        if node.outputs[0] not in self._qnodes:
            return super().op_Gemm(node, a, b, c)
        # transB was folded into the stored weight at quantization time;
        # transA nodes are never selected.
        alpha = node.attr("alpha", 1.0)
        beta = node.attr("beta", 1.0)
        if _is_host(a) or a.ndim != 2:  # safety net
            bf = self._deq_weight(node, b, "mat")
            if _is_host(a):
                out = alpha * np.matmul(a, bf)
                return out if c is None else out + beta * c
            a = self._deq_act(a, node.inputs[0]).float()
            out = alpha * torch.matmul(a, self._tensor(bf, a.device))
            if c is not None:
                out = out + self._tensor(c, a.device, torch.float32) * beta
            return self._mm_out(out)
        out = self._int8_matmul(node, a, b)
        if alpha != 1.0:
            out = out * float(np.float32(alpha))
        if c is not None:
            ct = self._tensor(c, out.device)
            out = out + (ct.float() * float(np.float32(beta))
                         if beta != 1.0 else ct)
        return self._mm_out(out)


def lower_int8(
    model: Model | bytes | str,
    calibration: CalibrationResult,
    compute_dtype=None,
    min_weight_bytes: int = DEFAULT_MIN_WEIGHT_BYTES,
    min_mean_lsb: float = DEFAULT_MIN_MEAN_LSB,
    protect_outputs: bool = True,
    smooth_alpha: float | None = 0.5,
    min_act_elems: int | None = None,
    boundary_store: str = "all",
) -> OnnxFunction:
    """Lower an ONNX model with calibrated int8 execution of its heavy
    matmuls/convs (the JAX package's selection rules, see there).

    ``compute_dtype`` governs the *non*-quantized ops: ``torch.bfloat16``
    (what the orchestrator runs, with the fused front-end spliced in) or
    None for fp32. ``smooth_alpha`` controls the SmoothQuant-style channel
    rebalancing (:func:`_smoothing_vectors`); ``None`` disables it.
    ``min_act_elems`` is the opt-in activation-size eligibility gate (None
    disables it). ``boundary_store`` picks the boundary int8
    materialization policy:

    - ``"strict"``: store a tensor int8 only when every consumer is a
      quantized node reading it as its activation;
    - ``"tolerant"``: store every calibrated activation tensor int8 (graph
      outputs excepted); non-quantized consumers dequantize on read;
    - ``"frontier"``: tolerant, minus tensors whose sole consumer is a
      quantized node (that consumer quantizes on read instead);
    - ``"all"``: frontier, plus int8-store every large calibrated
      intermediate that no matmul/conv reads (the SE pool/gate streams);
    - ``"storage"``: int8 STORAGE ONLY (``--precision mixed``) — no node
      quantizes; the "all" walk int8-materializes the large streams and
      every consumer dequantizes on read.

    The result is a drop-in :class:`OnnxFunction`: quantized weights live
    in ``params`` as int8, and extra attributes report the selection —
    ``quantized_nodes`` (list of node output names), ``skipped_nodes``
    (name -> reason), ``int8_boundary_tensors``, and ``smoothed_tensors``.
    """
    storage_only = boundary_store == "storage"
    if storage_only:
        # Mixed storage: nothing quantizes — force every selection gate
        # shut so qnodes/wscale stay empty and only the boundary walk
        # below acts.
        min_weight_bytes = float("inf")
        min_act_elems = None
        smooth_alpha = None
    if not isinstance(model, Model):
        model = load_model(model)
        # The float DSP front-end runs the fused front-end kernel in int8
        # mode too (it never quantizes); the pass gates itself. Only
        # applied to a Model loaded here — never to a caller-owned object
        # (the pass mutates the graph in place).
        from .lowering import maybe_fuse_frontend

        maybe_fuse_frontend(model, compute_dtype)
    graph = model.graph

    consumers: dict = {}
    for node in graph.nodes:
        for inp in node.inputs:
            if inp in graph.initializers:
                consumers.setdefault(inp, []).append(node)

    # Tensors that reach a graph output without passing through another
    # matmul/conv: quantization noise there lands on the scores unabsorbed,
    # so the producing node stays float (the "output head" guard — cuts
    # deep-graph score drift ~14x for a negligible FLOP fraction;
    # ``protect_outputs=False`` quantizes heads too).
    out_marked = {vi.name for vi in graph.outputs} if protect_outputs \
        else set()
    for node in reversed(graph.nodes):
        if any(o in out_marked for o in node.outputs):
            if node.op_type not in ("Conv", "MatMul", "Gemm"):
                out_marked.update(i for i in node.inputs if i)

    selected: dict = {}   # node.outputs[0] -> (node, wname, transform)
    skipped: dict = {}
    for node in graph.nodes:
        wname = _structurally_eligible(graph, node)
        if wname is None:
            if node.op_type in ("Conv", "MatMul", "Gemm"):
                skipped[node.outputs[0]] = "structural"
            continue
        key = node.outputs[0]
        arr = graph.initializers[wname].array
        st = calibration.stats.get(node.inputs[0])
        # Size gate: a big weight OR a big activation justifies the dequant
        # epilogue — the early small-channel backbone convs pair tiny
        # weights with the graph's largest activations, and their
        # fusion-boundary byte savings scale with the activation
        # (``aelems`` absent on pre-v3 calibration caches = 0 = old rule).
        # Grouped (depthwise) convs are exempt from the activation gate:
        # they run on the VPU where int8 execution measured as a net loss
        # on the v2.4 backbone (int32 upcast + quantize epilogues on the
        # graph's largest tensors outweigh the byte savings —
        # docs/performance.md, round-3 boundary A/B).
        aelems = 0 if st is None else st.get("aelems", 0)
        grouped = node.op_type == "Conv" and node.attr("group", 1) > 1
        act_big = (min_act_elems is not None and not grouped
                   and aelems >= min_act_elems)
        if arr.nbytes < min_weight_bytes and not act_big:
            skipped[key] = "small-weight"
            continue
        if st is None:
            skipped[key] = "uncalibrated"
            continue
        if node.op_type == "MatMul" and st["ndim"] != 2:
            skipped[key] = "non-2d-matmul"
            continue
        if key in out_marked:
            skipped[key] = "output-head"
            continue
        scale = calibration.scale(node.inputs[0]) or 0.0
        if scale <= 0.0 or st["amean"] < min_mean_lsb * scale:
            skipped[key] = "heavy-tailed-activation"
            continue
        transform = (
            "conv" if node.op_type == "Conv"
            else ("gemm-tb" if node.op_type == "Gemm"
                  and node.attr("transB", 0) else "mat")
        )
        selected[key] = (node, wname, transform)

    # A weight quantizes only if every consumer is a selected node using it
    # as its weight operand, all with the same layout transform.
    by_weight: dict = {}
    for key, (node, wname, tr) in selected.items():
        by_weight.setdefault(wname, []).append((node, tr))
    qualified = set()
    for wname, users in by_weight.items():
        cons = consumers.get(wname, [])
        ok = len(users) == len(cons) and len({tr for _, tr in users}) == 1
        ok = ok and all(
            c.outputs[0] in selected and c.inputs[1] == wname for c in cons
        )
        if ok:
            qualified.add(wname)

    smooth = _smoothing_vectors(
        graph, calibration, selected, by_weight, qualified, smooth_alpha
    )

    wscale: dict = {}
    const_override: dict = {}
    for wname in qualified:
        node0, tr = by_weight[wname][0]
        w = graph.initializers[wname].array.astype(np.float32)
        if tr == "gemm-tb":
            w = np.ascontiguousarray(w.T)
        sm = smooth.get(node0.inputs[0])
        if sm is not None:
            # SmoothQuant fold: the activation divides by s per channel at
            # quantize time; the weight multiplies by s on its input-channel
            # axis here, so the product is unchanged while the activation's
            # per-tensor grid no longer spends its range on outlier channels.
            if tr == "conv":
                if node0.attr("group", 1) == 1:
                    w = w * sm.reshape((1, -1) + (1,) * (w.ndim - 2))
                else:  # depthwise: input channel == output channel
                    w = w * sm.reshape((-1, 1) + (1,) * (w.ndim - 2))
            else:
                w = w * sm[:, None]
        if tr == "conv":
            amax = np.max(np.abs(w), axis=tuple(range(1, w.ndim)))
            s = np.maximum(amax / QMAX, 1e-12).astype(np.float32)
            q = np.rint(w / s.reshape((-1,) + (1,) * (w.ndim - 1)))
        else:  # [K, N]: per output column
            amax = np.max(np.abs(w), axis=0)
            s = np.maximum(amax / QMAX, 1e-12).astype(np.float32)
            q = np.rint(w / s)
        const_override[wname] = np.clip(q, -QMAX, QMAX).astype(np.int8)
        wscale[wname] = s

    qnodes = set()
    ascale: dict = {}
    for key, (node, wname, _tr) in selected.items():
        if wname in qualified:
            qnodes.add(key)
            aname = node.inputs[0]
            sm = smooth.get(aname)
            if sm is not None:
                cha = np.asarray(calibration.stats[aname]["chamax"],
                                 np.float32)
                scale = float(np.max(cha / sm)) / QMAX
                # chamax is a per-channel MAX; honor a percentile method's
                # clipping intent by shrinking in the same pctl/amax ratio
                # (exactly 1.0 under method "max").
                amax = float(calibration.stats[aname]["amax"])
                if amax > 0:
                    scale *= (calibration.scale(aname) * QMAX) / amax
                ascale[aname] = max(scale, 1e-12)
            else:
                ascale[aname] = calibration.scale(aname)
        else:
            skipped[key] = "weight-shared-with-float-consumer"

    # Fusion-boundary int8 materialization: tensors stored int8 at
    # production time — XLA fuses the quantize into the producer's
    # epilogue, so the HBM-resident tensor costs 1 byte/element instead of
    # 2 (the traffic that binds bandwidth-bound backbones). Quantized
    # consumers read the int8 directly (skipping their own quantize);
    # everyone else transparently dequantizes on read via ``_fetch``
    # (fused into the consumer's own fusion). Policy per ``boundary_store``
    # (see docstring). Graph outputs always stay float.
    if boundary_store not in ("strict", "tolerant", "frontier", "all",
                              "storage"):
        raise ValueError(f"unknown boundary_store policy {boundary_store!r}")
    out_names = {vi.name for vi in graph.outputs}
    if boundary_store == "all" and not qnodes:
        # Nothing quantized (e.g. every node guarded off) under the
        # DEFAULT policy: storage-only int8 is a deliberate opt-in
        # ("storage"), not something "all" should back into — behave like
        # frontier (a no-op).
        boundary_store = "frontier"
    if boundary_store in ("all", "storage"):
        # "all" = frontier + int8-store large calibrated intermediates no
        # matmul/conv reads (SE pool/gate streams — the biggest tensors the
        # consumer-based policies can't reach). Same heavy-tail guard as
        # node selection; custom-op producers (the fused Pallas front-end)
        # are excluded — XLA cannot fuse a quantize into a custom call, so
        # storing would add a standalone pass instead of riding an epilogue.
        producers = {o: n for n in graph.nodes for o in n.outputs if o}
        # DSP guard: tensors that reach a spectral transform through
        # elementwise/shape ops are time-domain audio about to be
        # transformed — 8-bit storage puts a quantization noise floor
        # under the whole spectrum (the same reasoning that keeps the
        # Conv1d-STFT front-end float). Seed from every transform
        # spelling — DFT, opset-17 STFT, the fused Pallas front-end, and
        # the Conv1d-STFT conv shape `_structurally_eligible` excludes —
        # and walk backward, stopping at matmul/conv producers.
        def _is_stft_conv(nd) -> bool:
            if nd.op_type != "Conv" or len(nd.inputs) < 2:
                return False
            t = graph.initializers.get(nd.inputs[1])
            arr = None if t is None else t.array
            return (arr is not None and arr.ndim == 3
                    and arr.shape[1] == 1 and arr.shape[2] >= 256)

        dsp_block: set = set()
        work = [i for nd in graph.nodes
                if nd.op_type in ("DFT", "STFT", "BirdaFusedMelFrontend")
                or _is_stft_conv(nd)
                for i in nd.inputs if i]
        while work:
            t = work.pop()
            if t in dsp_block or t in graph.initializers:
                continue
            dsp_block.add(t)
            prod = producers.get(t)
            if prod is not None and prod.op_type not in (
                    "Conv", "MatMul", "Gemm"):
                work.extend(i for i in prod.inputs if i)
        for name, st in calibration.stats.items():
            # out_marked: tensors on elementwise-only paths to graph
            # outputs (the protect_outputs walk) — int8-rounding them would
            # land the quantization noise on the reported scores, exactly
            # what the output-head guard exists to prevent.
            if (name in ascale or name in out_names or name in out_marked
                    or name in graph.initializers or name in dsp_block
                    or st.get("aelems", 0) < DEFAULT_MIN_ACT_ELEMS):
                continue
            prod = producers.get(name)
            if prod is None or prod.op_type.startswith("Birda"):
                continue
            scale = calibration.scale(name) or 0.0
            if scale <= 0.0 or st["amean"] < min_mean_lsb * scale:
                continue
            ascale[name] = scale
        boundary_store = "frontier"
    act_consumers: dict = {}
    for node in graph.nodes:
        for pos, inp in enumerate(node.inputs):
            if inp:
                act_consumers.setdefault(inp, []).append((node, pos))
    store_int8: set = set()
    for name in ascale:
        # Same out_marked discipline as the "all" loop above: a tensor on
        # an elementwise path to a graph output stays float even when a
        # quantized node also reads it.
        if name in out_names or name in out_marked:
            continue
        cons = act_consumers.get(name, [])
        if not cons:
            continue
        q_reads = [n.outputs[0] in qnodes and pos == 0 for n, pos in cons]
        if boundary_store == "strict":
            if all(q_reads):
                store_int8.add(name)
        elif boundary_store == "frontier":
            if not (len(cons) == 1 and q_reads[0]):
                store_int8.add(name)
        else:  # tolerant
            store_int8.add(name)

    ev = _Int8Evaluator(graph, qnodes, ascale, wscale, compute_dtype,
                        store_int8=store_int8, asmooth=smooth)
    ev.const.update(const_override)
    fn = OnnxFunction(model, evaluator=ev)
    fn.quantized_nodes = sorted(qnodes)
    fn.skipped_nodes = skipped
    fn.int8_boundary_tensors = sorted(store_int8)
    fn.smoothed_tensors = sorted(smooth)
    return fn


# ---------------------------------------------------------------------------
# Static cost accounting + throughput advisory
# ---------------------------------------------------------------------------

def int8_cost_report(fn: OnnxFunction, *example_args) -> dict:
    """Static per-inference cost accounting for an int8-lowered function.

    Runs the program once on ``meta`` tensors (shapes only: no device, no
    arithmetic) and accumulates the quantized subgraph's costs:

    - ``macs``: int8 multiply-accumulates of the quantized Conv/MatMul/Gemm
      nodes (output elements × reduction depth);
    - ``quantize_elems`` / ``dequant_elems``: elements through the runtime
      quantize (float → int8) and dequant (int32 → float) epilogues — the
      elementwise work int8 *adds*;
    - ``act_bytes``: bytes of every node output at its stored dtype
      (boundary tensors count at 1 byte/element);
    - ``boundary_int8_bytes``: the subset stored int8 at fusion boundaries
      (each element here saves 1 activation byte vs bf16);
    - ``weight_bytes_int8`` / ``weight_bytes_float``: parameter footprint
      as shipped vs what the same weights cost at 2 bytes (bf16).

    ``example_args`` are tensors or arrays (anything with ``shape`` and
    ``dtype``) matching the graph inputs at the batch shape of interest.
    """
    ev = fn._eval
    if not isinstance(ev, _Int8Evaluator):
        raise TypeError("int8_cost_report needs a lower_int8() function")
    meta = torch.device("meta")
    args = [torch.empty(tuple(a.shape), dtype=_torch_dtype(a.dtype),
                        device=meta) for a in example_args]
    params = {k: torch.empty(v.shape, dtype=_torch_dtype(v.dtype),
                             device=meta) for k, v in fn.params.items()}
    ev.cost = {}
    try:
        fn(*args, params=params)
        cost = dict(ev.cost)
    finally:
        ev.cost = None
    w_int8 = w_float = 0
    for name, arr in fn.params.items():
        if arr.dtype == np.int8:
            w_int8 += arr.nbytes
            w_float += arr.size * 2  # what the same weight costs in bf16
        else:
            w_float += arr.size * 2
            w_int8 += arr.size * 2  # unquantized params ship as-is
    cost.setdefault("macs", 0)
    cost.setdefault("quantize_elems", 0)
    cost.setdefault("dequant_elems", 0)
    cost.setdefault("fetch_dequant_elems", 0)
    cost.setdefault("act_bytes", 0)
    cost.setdefault("boundary_int8_bytes", 0)
    cost["weight_bytes_int8"] = w_int8
    cost["weight_bytes_float"] = w_float
    cost["bytes_saved"] = (w_float - w_int8) + cost["boundary_int8_bytes"]
    cost["epilogue_elems"] = (cost["quantize_elems"] + cost["dequant_elems"]
                              + cost["fetch_dequant_elems"])
    return cost


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


#: Arithmetic intensity (FLOPs per bf16-equivalent activation byte) of the
#: quantized subgraph above which int8 draws a "validate before trusting
#: the speedup" advisory. The JAX package's threshold as it is, so that
#: both packages warn on the same graphs; it was set from that package's
#: TPU measurements (its ``docs/performance.md``) and has not been measured
#: on the card.
ADVISORY_INTENSITY_FLOP_PER_BYTE = 100.0


def int8_throughput_advisory(fn: OnnxFunction, *example_args) -> dict | None:
    """Warn when int8 execution is unlikely to be a throughput win.

    The reference's variant selection never auto-picks a known-worse
    variant (``src/registry/selection.rs:160``); this is the analogue for
    ``--precision int8``: a static shape-derived heuristic flags graphs far
    more compute-shaped than the families the threshold was set on.

    The discriminator is the quantized subgraph's arithmetic intensity:
    ``2·macs / activation bytes at bf16 storage``. Low intensity means the
    program pays memory traffic per FLOP — what int8's byte cuts attack;
    high intensity means the matrix units are the constraint and smaller
    tensors change nothing.

    Returns None when int8 looks profitable; otherwise a dict with the
    computed intensity and a human-readable rationale (the caller decides
    whether to warn; the explicit user flag is honored either way).
    """
    cost = int8_cost_report(fn, *example_args)
    # What the traced activations would occupy at 2 B/element (boundary
    # tensors were counted at their int8 byte size).
    act_bf16 = cost["act_bytes"] + cost["boundary_int8_bytes"]
    if act_bf16 <= 0:
        return None  # nothing quantized / nothing traced: no claim to make
    intensity = 2.0 * cost["macs"] / act_bf16
    if intensity <= ADVISORY_INTENSITY_FLOP_PER_BYTE:
        return None
    return {
        "intensity_flop_per_byte": intensity,
        "threshold": ADVISORY_INTENSITY_FLOP_PER_BYTE,
        "macs": cost["macs"],
        "act_bytes_bf16": act_bf16,
        "bytes_saved": cost["bytes_saved"],
        "message": (
            "this graph is compute-shaped "
            f"({intensity:.0f} FLOP per activation byte, threshold "
            f"{ADVISORY_INTENSITY_FLOP_PER_BYTE:g}), far beyond the model "
            "families the threshold was set on: the matrix units, not "
            "activation traffic, are likely the constraint here, so expect "
            "the ~2x weight-memory cut rather than a speedup. Validate on "
            "your own data or use --precision bf16."
        ),
    }
