#!/usr/bin/env python3
"""Inference throughput of the port's model families on the CUDA card: the
counterpart of ``bench.py``, measuring the same things through
``birda_tpu_torch``.

Run it from the root of a checkout, with a time limit of its own (the
kernels' ring barriers spin without a timeout):

    timeout 1500 python3 scripts/torch_bench.py [--only KEY,...] \\
        [--batch N] [--iters 6] [--repeats 5] [--seed 0] [--budget 1380] \\
        [--e2e-seconds 600] [--e2e-files 4] [--device auto|cpu]

**Measurements** (``--only`` selects them, by key, in this order):

- ``birdnet_v24`` — the headline: the full-scale BirdNET v2.4 graph
  (``onnx/fullscale.py::BIRDNET_V24_SPEC``) lowered in bf16, its front end
  on ``fused_logmel``;
- ``birdnet_v24_int8``, ``perch_v2``, ``perch_v2_int8``, ``birdnet_v30``,
  ``birdnet_v30_int8``, ``birdnet_v24_mixed`` — the other families and
  precisions (Perch v2's framer on ``conv1d_stft``); int8 and mixed are
  calibrated on the built-in signal set, the scales cached per graph digest
  as ``analyze`` caches them, and compute the ops they do not quantize in
  bf16, as ``--precision int8|mixed`` does on the card;
- ``native_v24`` — the native v2.4 backbone (``models/zoo.py::
  native_model``, synthetic weights) in bf16: the framework's ceiling, not
  a parity claim. ``bench.py`` names it ``native_flax_v24``; the port has
  no flax, so its keys are ``native_v24_*``;
- ``e2e`` — ``analyze`` end to end (``orchestrator.analyze_files``):
  generated 48 kHz recordings (``--e2e-files`` of ``--e2e-seconds``), the
  full-scale v2.4 graph in bf16, CSV out; a warm-up analyze of one file,
  then one timed invocation over all of them.

**Step** (``bench.py``'s): int16 chunks dequantized by 1/32768 inside the
step, the lowered graph, a top-5 of its float32 scores. The inputs are
``--iters`` distinct int16 batches drawn with numpy from ``--seed`` and
copied to the card before any clock starts. After a warm-up step (which
builds nothing: the kernels are built first, timed on their own) and one
timed pass over the batches, which sizes the windows, the run times
``--repeats`` windows that each step through the batches until it lasts
``MIN_WINDOW_S`` (3 s), each ending in ``torch.cuda.synchronize()``, and
reports the realtime factor (segments per second times seconds per
segment) of the median window, beside the fastest and slowest, then a
``torch.profiler`` window of ``PROFILE_STEPS`` steps for the device's busy
time, its idle share and the kernels launched per step. The front-end
kernels' launch counts over the measurement (``stft_conv.LAUNCHES``) must
show ``fused_logmel`` for v2.4 and v3.0 and ``conv1d_stft`` for Perch v2,
and the native backbone must launch neither.

**Correctness**, in the run: each measurement's first batch against the
card's fp32 run of the same batch (the fp32 lowering, or the native model
at fp32): the largest score difference, relative to the largest fp32 score
for Perch's softmax, within ``SCORE_DRIFT_BOUND``, and top-1 agreement.
The native backbone's synthetic weights leave every sigmoid score near
0.5, so its check is on the logits and embeddings instead (see
``native_drift``): within ``NATIVE_DRIFT_BOUND`` of their largest fp32
value, a bound that planted faults in the same run must break.

**Batch**: the port's CUDA defaults (``orchestrator.py``: 64 for v2.4, 32
for the others) unless ``--batch`` is given. **Set-up costs** are their own
numbers: kernel build, graph build, lowering and calibration seconds, and
peak device memory.

**Output**: ``bench.py``'s one line, last: ``{"metric", "value", "unit":
"x realtime", "vs_baseline", "extra"}``; ``vs_baseline`` and the
``*_vs_baseline`` keys divide by ``BASELINE.md``'s reference numbers
(TensorRT batch 32 on an RTX 5080: 10,767x for v2.4, 2,550x for Perch v2),
and ``extra`` holds the card's name and power limit and every measurement's
record.

**Contract** (the opposite of ``bench.py``'s): ``--device auto``, the
default, is ``cuda:0`` and raises ``RuntimeInitialization`` without a card;
``--device cpu`` runs the ``fullscale.tiny_spec`` graphs (and the tiny
native model) on the CPU and says "cpu smoke, tiny" in ``metric``.
``--budget`` (default ``BIRDA_BENCH_BUDGET``, else 1380 s) is a hard
deadline: past it, or on any error in any measurement, the tool prints what
it has on a line of its own marked ``"complete": false`` and exits
non-zero, without the result line. Nothing is skipped by estimate. It
imports no jax and nothing of ``birda_tpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import tempfile
import threading
import time
import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: BASELINE.md's reference numbers: TensorRT batch 32 (v2.4) and CUDA batch
#: 32 (Perch v2) on an RTX 5080, in x realtime.
BASELINE_BIRDNET_V24 = 10_767.0
BASELINE_PERCH_V2 = 2_550.0
#: A measurement's first batch against the card's fp32 run of it: the JAX
#: package's bf16-vs-fp32 score bound (tests/test_stft_kernel.py), as in
#: chip_smoke.py.
SCORE_DRIFT_BOUND = 5e-2
#: The native bf16 backbone's logits and embeddings against its fp32 run,
#: each over its largest fp32 value (``native_drift``).
NATIVE_DRIFT_BOUND = 3e-2
TOP_K = 5
DEFAULT_BUDGET_S = 1380.0
PROFILE_STEPS = 3
#: The least host-clock length of one timed window, in seconds. The JAX
#: tool's ``--iters 6`` filled a window at the TPU's batch of 768; at the
#: card's batches of 32 and 64 six steps last 0.1-0.8 s, where the jitter
#: of a host whose cores are shared moves a window by tens of percent.
MIN_WINDOW_S = 3.0
#: The front-end kernel each family's graph must launch on the card.
FRONT_END = {"birdnet-v24": "fused_logmel", "birdnet-v30": "fused_logmel",
             "perch-v2": "conv1d_stft"}


class BudgetExceeded(RuntimeError):
    """The run passed its ``--budget`` deadline."""


class MeasurementFailed(RuntimeError):
    """A measurement ran but broke one of its checks; ``record`` is what
    it measured."""

    def __init__(self, message: str, record: dict | None = None):
        super().__init__(message)
        self.record = record


@dataclass(frozen=True)
class Measurement:
    key: str
    family: str
    precision: str  # bf16, int8 or mixed
    native: bool = False


#: bench.py's measurements in its order; e2e sits where bench.py runs it.
MEASUREMENTS = {m.key: m for m in (
    Measurement("birdnet_v24", "birdnet-v24", "bf16"),
    Measurement("birdnet_v24_int8", "birdnet-v24", "int8"),
    Measurement("perch_v2", "perch-v2", "bf16"),
    Measurement("perch_v2_int8", "perch-v2", "int8"),
    Measurement("birdnet_v30", "birdnet-v30", "bf16"),
    Measurement("birdnet_v30_int8", "birdnet-v30", "int8"),
    Measurement("birdnet_v24_mixed", "birdnet-v24", "mixed"),
    Measurement("native_v24", "birdnet-v24", "bf16", native=True),
)}
E2E = "e2e"
KEYS = [*list(MEASUREMENTS)[:6], E2E, *list(MEASUREMENTS)[6:]]
HEADLINE = "birdnet_v24"
#: The keys that bench.py divides by a baseline, and by which.
VS_BASELINE = {"birdnet_v24_int8": ("birdnet_v24_int8_vs_baseline",
                                    BASELINE_BIRDNET_V24),
               "perch_v2": ("perch_v2_vs_its_baseline", BASELINE_PERCH_V2),
               "perch_v2_int8": ("perch_v2_int8_vs_its_baseline",
                                 BASELINE_PERCH_V2),
               "birdnet_v24_mixed": ("birdnet_v24_mixed_vs_baseline",
                                     BASELINE_BIRDNET_V24)}


_T0 = time.monotonic()


def log(msg: str) -> None:
    """Progress on stderr: stdout carries the result lines."""
    print(f"[torch_bench +{time.monotonic() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


# -- the run: its deadline and what it has so far -------------------------------

class Run:
    """One run of a tool against a hard deadline. Used as a context: a
    watchdog thread prints the partial line and ends the process (exit 3)
    at the deadline; an exception out of the body prints it and goes on
    up. ``record`` keeps what the run has measured so far."""

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.t0 = time.monotonic()
        self.partial: dict = {}
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._printed = False

    def remaining(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def check_deadline(self) -> None:
        if self.remaining() <= 0:
            raise BudgetExceeded(f"budget of {self.budget_s:g} s exceeded")

    def record(self, key: str, value) -> None:
        snap = json.loads(json.dumps(value))
        with self._lock:
            self.partial[key] = snap

    def incomplete(self, reason: str, failed: dict | None = None) -> None:
        """Print what the run has, once, marked incomplete, with the record
        of a measurement that failed its checks."""
        with self._lock:
            if self._printed:
                return
            self._printed = True
            line = {"complete": False, "error": reason,
                    "elapsed_s": time.monotonic() - self.t0,
                    "partial": self.partial}
            if failed is not None:
                line["failed_record"] = failed
        print(json.dumps(line), flush=True)

    def _watch(self) -> None:
        if not self._done.wait(max(self.remaining(), 0.0)):
            self.incomplete(f"budget of {self.budget_s:g} s exceeded")
            os._exit(3)

    def __enter__(self):
        threading.Thread(target=self._watch, daemon=True).start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._done.set()
        if exc_type is not None:
            self.incomplete(f"{exc_type.__name__}: {exc}",
                            getattr(exc, "record", None))
        return False


def budget_default() -> float:
    return float(os.environ.get("BIRDA_BENCH_BUDGET", DEFAULT_BUDGET_S))


# -- device, specs, inputs ---------------------------------------------------------

def resolve_device(requested: str):
    """``auto`` and ``cuda`` are ``cuda:0`` (``RuntimeInitialization``
    without a card); ``cpu`` is the CPU."""
    from birda_tpu_torch.inference.backend import select_backend

    return select_backend(requested)[0][0]


def card_of(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    from birda_tpu_torch.inference.backend import card_line

    return card_line()


def spec_for(family: str, dev):
    """The full-scale graph spec of ``family`` on the card, its tiny
    variant on the CPU."""
    from birda_tpu_torch.onnx import fullscale as fs

    spec = fs.SPECS[family]
    return spec if dev.type == "cuda" else fs.tiny_spec(spec)


def default_batch(family: str, dev) -> int:
    """The port's default batch of ``family`` on this device (on the card:
    64 for v2.4, 32 for the others)."""
    from birda_tpu_torch.config.types import ModelType
    from birda_tpu_torch.orchestrator import determine_default_batch_size

    return determine_default_batch_size(ModelType(family), dev.type)


def int16_batches(iters: int, batch: int, samples: int, seed: int):
    """``iters`` distinct int16 batches ``[batch, samples]``: normal(0, 0.1)
    signals scaled to int16, as ``bench.py`` draws them, from ``seed``."""
    host = np.random.default_rng(seed).normal(0, 0.1, (iters, batch, samples))
    return np.clip(host * 32767.0, -32768, 32767).astype(np.int16)


def dequantize(x16):
    """The step's int16 transport: float32 samples, x / 32768."""
    return x16.float() * (1.0 / 32768.0)


def realtime(batch: int, iters: int, seconds: float,
             segment_seconds: float) -> float:
    """``bench.py``'s realtime factor: segments per second over a window
    of ``iters`` steps of ``batch`` segments, times seconds per segment."""
    return batch * iters / seconds * segment_seconds


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_counts() -> dict:
    """Launches and routes of the front-end kernels so far."""
    from birda_tpu_torch.ops import stft_conv

    return {"launches": dict(stft_conv.LAUNCHES),
            "routes": dict(stft_conv.ROUTES)}


def counts_since(before: dict) -> dict:
    now = kernel_counts()
    return {k: {n: v - before[k].get(n, 0) for n, v in now[k].items()
                if v != before[k].get(n, 0)} for k in now}


def build_kernels(dev) -> float:
    """Build (or load from their digest) the front-end kernels; seconds."""
    if dev.type != "cuda":
        return 0.0
    from birda_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


# -- a model prepared for measuring ------------------------------------------------

@dataclass
class Prepared:
    """A model of one family and precision on a device: ``scores(x)`` maps
    float32 samples ``[B, S]`` to float32 scores, ``reference(x)`` is the
    fp32 run of the same model, ``setup`` its set-up seconds;
    ``native_check(x)``, for the native backbone, is ``native_drift``."""
    family: str
    precision: str
    spec: object
    scores: object
    reference: object
    setup: dict
    softmax: bool
    kernel: str | None
    quantized_nodes: int | None = None
    param_bytes: int | None = None
    native_check: object = None


def _graph_fn(fn, params):
    def scores(x):
        out = fn(x, params=params)
        return (out[0] if isinstance(out, tuple) else out).float()

    return scores


def prepare(family: str, precision: str, dev, native: bool = False
            ) -> Prepared:
    """Build, lower (and calibrate) one model on ``dev``, timing each."""
    import torch

    from birda_tpu_torch.models import contracts

    contract = contracts.contract_for(family)
    softmax = contract.activation.value == "softmax"
    if native:
        return _prepare_native(family, precision, dev, softmax)
    from birda_tpu_torch.models.zoo import params_from_numpy
    from birda_tpu_torch.onnx import fullscale as fs
    from birda_tpu_torch.onnx.lowering import lower
    from birda_tpu_torch.onnx.quantize import cached_calibration, lower_int8

    spec = spec_for(family, dev)
    setup = {}
    t0 = time.perf_counter()
    g = fs.cached_build(spec, seed=1)
    setup["graph_build_s"] = time.perf_counter() - t0
    quantized = None
    if precision == "bf16":
        t0 = time.perf_counter()
        fn = lower(g.model_bytes, compute_dtype=torch.bfloat16)
        setup["lowering_s"] = time.perf_counter() - t0
    elif precision in ("int8", "mixed"):
        t0 = time.perf_counter()
        calib, cached = cached_calibration(g.model_bytes, spec.sample_count,
                                           device=dev)
        setup["calibration_s"] = time.perf_counter() - t0
        setup["calibration_cached"] = cached
        t0 = time.perf_counter()
        fn = lower_int8(g.model_bytes, calib, compute_dtype=torch.bfloat16,
                        **({"boundary_store": "storage"}
                           if precision == "mixed" else {}))
        setup["lowering_s"] = time.perf_counter() - t0
        quantized = len(fn.quantized_nodes)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    t0 = time.perf_counter()
    params = params_from_numpy(fn.params, dev, torch.bfloat16)
    fn.prepare(params)
    sync(dev)
    setup["params_to_device_s"] = time.perf_counter() - t0

    ref = {}

    def reference(x):
        if not ref:  # the fp32 route, lowered on first use
            f32 = lower(g.model_bytes)
            p32 = params_from_numpy(f32.params, dev)
            f32.prepare(p32)
            ref["fn"] = _graph_fn(f32, p32)
        return ref["fn"](x)

    return Prepared(family, precision, spec, _graph_fn(fn, params),
                    reference, setup, softmax, FRONT_END[family],
                    quantized_nodes=quantized,
                    param_bytes=sum(t.numel() * t.element_size()
                                    for t in params.values()))


def _prepare_native(family, precision, dev, softmax) -> Prepared:
    import torch

    from birda_tpu_torch.models import zoo

    if precision != "bf16":
        raise ValueError("the native family is measured in bf16")
    build = zoo.native_model if dev.type == "cuda" else zoo.tiny_model
    t0 = time.perf_counter()
    model = build(family, dtype=torch.bfloat16)
    setup = {"graph_build_s": time.perf_counter() - t0}
    ref = {}

    def fp32(x):
        if not ref:
            ref["model"] = build(family)
        return ref["model"].apply(x)

    return Prepared(family, precision, model.config,
                    lambda x: model.apply(x)["scores"],
                    lambda x: fp32(x)["scores"], setup, softmax, None,
                    native_check=lambda x: native_drift(model, fp32(x), x,
                                                        dev))


def native_drift(model, want: dict, x, dev) -> dict:
    """The native bf16 backbone's logits and embeddings on ``x`` against
    its fp32 outputs ``want``, each as its largest difference over its
    largest fp32 value, and top-1 agreement of the logits. The synthetic
    weights keep the logits near 1e-4, so the sigmoid scores sit at 0.5
    whatever the backbone computes (their drift reads near 1e-7) and tie
    in float32.

    Beside it, the same reading of planted faults, one at a time: each
    top-level stage that has a swish with its swishes removed, and each
    residual block skipped. The least of them must lie past ``NATIVE_DRIFT_BOUND``, or
    the bound could not fail. (A BatchNorm of the synthetic weights is the
    identity, so a dropped one changes nothing that any run can see; the
    CPU tests hold the BatchNorms at random statistics against flax.) And
    the dtype out of each stage, which must be bf16, as in flax."""
    from birda_tpu_torch.models.backbone import ConvBNAct

    def rel(out, key):
        return float((out[key] - want[key]).abs().max()
                     / want[key].abs().max())

    def reading(out):
        return max(rel(out, "logits"), rel(out, "embeddings"))

    module = model.bind_device(dev)
    layers = module.layers
    dtypes = set()
    hooks = [layer.register_forward_hook(
        lambda m, i, o: dtypes.add(str(o.dtype).removeprefix("torch.")))
        for layer in layers]
    try:
        got = model.apply(x)
    finally:
        for h in hooks:
            h.remove()
    faults = {}
    for j, layer in enumerate(layers):
        acts = [c for c in layer.modules()
                if isinstance(c, ConvBNAct) and c.act]
        try:
            for c in acts:
                c.act = False
            if acts:
                faults[f"stage {j} without swish"] = reading(
                    model.apply(x))
        finally:
            for c in acts:
                c.act = True
        if getattr(layer, "residual", False):
            module.layers = layers[:j] + layers[j + 1:]
            try:
                faults[f"stage {j} skipped"] = reading(model.apply(x))
            finally:
                module.layers = layers
    return {"logits_drift": rel(got, "logits"),
            "embeddings_drift": rel(got, "embeddings"),
            "drift": reading(got), "drift_bound": NATIVE_DRIFT_BOUND,
            "drift_of": "logits and embeddings",
            "drift_relative_to_max_score": True,
            "top1_agree": float((got["logits"].argmax(-1)
                                 == want["logits"].argmax(-1))
                                .float().mean()),
            "planted_fault_drift": faults,
            "planted_fault_drift_min": min(faults.values()),
            "stage_dtypes": sorted(dtypes)}


# -- one measurement ------------------------------------------------------------------

def drift(got, want, relative: bool) -> dict:
    """The largest score difference (over the largest reference score where
    ``relative``) and top-1 agreement, of two ``[B, N]`` arrays."""
    d = float(np.abs(got - want).max())
    top = float(np.abs(want).max())
    return {"max_score_drift": d, "max_fp32_score": top,
            "drift": d / top if relative else d,
            "drift_relative_to_max_score": relative,
            "drift_bound": SCORE_DRIFT_BOUND,
            "top1_agree": float(np.mean(got.argmax(-1) == want.argmax(-1)))}


def measure(prep: Prepared, batch: int, iters: int, repeats: int, seed: int,
            dev) -> dict:
    """Time ``prep``'s step at ``batch`` (see the module docstring) and
    check its launches and its drift against fp32. Raises
    ``MeasurementFailed`` on a failed check."""
    import torch

    from birda_tpu_torch.ops import measure as m

    spec = prep.spec
    segment_s = spec.sample_count / spec.sample_rate
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    xs = torch.from_numpy(int16_batches(iters, batch, spec.sample_count,
                                        seed)).to(dev)
    sync(dev)
    before = kernel_counts()

    def step(i):
        return torch.topk(prep.scores(dequantize(xs[i % iters])), TOP_K)

    def window(steps):
        sync(dev)
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        sync(dev)
        return time.perf_counter() - t0

    rec = {"family": prep.family, "precision": prep.precision,
           "batch": batch, "iters": iters, "repeats": repeats, **prep.setup}
    with torch.inference_mode():
        rec["warmup_s"] = window(1)
        # One pass over the batches sizes the windows: each steps through
        # them until it lasts MIN_WINDOW_S.
        rec["sizing_window_s"] = window(iters)
        steps = max(iters, math.ceil(
            iters * MIN_WINDOW_S / rec["sizing_window_s"]))
        windows = [window(steps) for _ in range(repeats)]
        k = iter(range(PROFILE_STEPS))
        prof = m.profile_steps(lambda: step(next(k)), PROFILE_STEPS)
        counts = counts_since(before)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        first = dequantize(xs[0])
        got = prep.scores(first).cpu().numpy()
        want = prep.reference(first).float().cpu().numpy()
        native = prep.native_check(first) if prep.native_check else {}
    rts = sorted(realtime(batch, steps, w, segment_s) for w in windows)
    median_window = statistics.median(windows)
    step_ms = median_window / steps * 1e3
    busy = prof["device_busy_ms_per_step"]
    rec.update({
        "x_realtime": statistics.median(rts),
        "x_realtime_min": rts[0], "x_realtime_max": rts[-1],
        "x_realtime_windows": rts,
        "steps_per_window": steps, "window_s": median_window,
        "segments_per_window": batch * steps,
        "segments_per_s": batch * steps / median_window,
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": m.idle_share(busy, step_ms),
        "kernels_per_step": prof["kernels_per_step"],
        "top_kernels_ms_per_step": prof["top_kernels_ms_per_step"][:3],
        "steps": 1 + iters + repeats * steps + PROFILE_STEPS,
        "launches": counts["launches"], "routes": counts["routes"],
        "peak_device_memory_bytes": peak,
        **drift(got, want, prep.softmax), **native,
    })
    if prep.quantized_nodes is not None:
        rec["quantized_nodes"] = prep.quantized_nodes
    check_measurement(prep, rec, dev)
    return rec


def check_measurement(prep: Prepared, rec: dict, dev) -> None:
    """The launch, route and drift checks of one measurement."""
    problems = []
    if prep.kernel is None:
        if rec["launches"] or rec["routes"]:
            problems.append(f"a front-end kernel ran: {rec['launches']}, "
                            f"{rec['routes']}")
    else:
        if not rec["routes"].get(f"{prep.kernel}:kernel"):
            problems.append(f"no {prep.kernel} route: {rec['routes']}")
        if dev.type == "cuda" and not rec["launches"].get(prep.kernel):
            problems.append(f"no {prep.kernel} launch: {rec['launches']}")
    if not (np.isfinite(rec["drift"]) and rec["drift"] <= rec["drift_bound"]):
        problems.append(f"drift {rec['drift']} against fp32 over "
                        f"{rec['drift_bound']}")
    if prep.native_check:
        if not rec["planted_fault_drift_min"] > rec["drift_bound"]:
            problems.append("a planted fault within the drift bound: "
                            f"{rec['planted_fault_drift']}")
        if rec["stage_dtypes"] != ["bfloat16"]:
            problems.append(f"stages out in {rec['stage_dtypes']}")
    if not all(v > 0 for v in (rec["x_realtime_min"], rec["step_ms"])):
        problems.append("a non-positive time")
    if problems:
        raise MeasurementFailed(
            f"{prep.family} {prep.precision} batch {rec['batch']}: "
            + "; ".join(problems), rec)


# -- e2e ----------------------------------------------------------------------------

def write_wav16(path: Path, x: np.ndarray, rate: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.clip(x * 24000.0, -32767, 32767).astype("<i2")
                      .tobytes())


def measure_e2e(batch: int, seconds: float, n_files: int, seed: int,
                dev) -> dict:
    """``bench.py``'s ``_bench_e2e`` through the port's
    ``orchestrator.analyze_files``: ``n_files`` generated 48 kHz recordings
    of ``seconds`` (a 3 kHz tone in noise from ``seed``), the v2.4 graph in
    bf16, CSV out at a confidence of 0.1; a warm-up analyze of the first
    file, then one timed invocation over all of them. Every CSV must be
    there and non-empty, the exit code 0, and ``fused_logmel`` launched on
    the card (on the CPU, ``analyze`` computes bf16 in fp32, as the JAX
    package does, and no front end is fused: ``compute_dtype_for``)."""
    from birda_tpu_torch import orchestrator
    from birda_tpu_torch.config.types import Config, ModelType
    from birda_tpu_torch.models.zoo import synthetic_labels
    from birda_tpu_torch.onnx import fullscale as fs
    from birda_tpu_torch.orchestrator import AnalyzeOptions, analyze_files
    from birda_tpu_torch.pipeline.coordinator import OutputFormat

    rec = {"batch": batch, "files": n_files, "file_seconds": seconds}
    with tempfile.TemporaryDirectory(prefix="birda_bench_e2e_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        rate = 48_000
        t = np.arange(int(rate * seconds), dtype=np.float64) / rate
        tone = 0.25 * np.sin(2 * np.pi * 3000.0 * t)
        wavs = []
        for i in range(n_files):
            rng = np.random.default_rng([seed, 100 + i])
            p = tmp / f"rec{i}.wav"
            write_wav16(p, tone + 0.08 * rng.normal(0, 1, t.size), rate)
            wavs.append(p)
        g = fs.cached_build(spec_for("birdnet-v24", dev), seed=1)
        model_path = tmp / "v24.onnx"
        model_path.write_bytes(g.model_bytes)
        labels_path = tmp / "labels.txt"
        labels_path.write_text("\n".join(synthetic_labels(
            g.spec.num_classes)))
        rec["synthesis_s"] = time.perf_counter() - t0

        def opts(inputs):
            return AnalyzeOptions(
                inputs=inputs, model_path=model_path,
                labels_path=labels_path, model_type=ModelType.BIRDNET_V24,
                formats=[OutputFormat.CSV], output_dir=tmp / "out",
                min_confidence=0.1, overlap=0.0, batch_size=batch,
                force=True, precision="bf16",
                device_flags={"cpu": dev.type == "cpu",
                              "gpu": dev.type == "cuda"})

        before = kernel_counts()
        t0 = time.perf_counter()
        code = analyze_files(opts([wavs[0]]), Config())
        rec["warmup_s"] = time.perf_counter() - t0
        if code != 0:
            raise MeasurementFailed(f"e2e warm-up analyze exit code {code}")
        t0 = time.perf_counter()
        code = analyze_files(opts(wavs), Config())
        dt = time.perf_counter() - t0
        if code != 0:
            raise MeasurementFailed(f"e2e analyze exit code {code}")
        counts = counts_since(before)
        csvs = sorted((tmp / "out").glob("*.csv"))
        rec["csv_bytes"] = [c.stat().st_size for c in csvs]
        if len(csvs) != n_files or not all(rec["csv_bytes"]):
            raise MeasurementFailed(f"e2e: CSVs {rec['csv_bytes']} for "
                                    f"{n_files} files")
    rec.update({"x_realtime": n_files * seconds / dt, "seconds": dt,
                **counts})
    fused = orchestrator.compute_dtype_for("bf16", dev.type) is not None
    if fused and (not rec["routes"].get("fused_logmel:kernel") or (
            dev.type == "cuda" and not rec["launches"].get("fused_logmel"))):
        raise MeasurementFailed(f"e2e: fused_logmel did not run: {counts}")
    return rec


# -- the run --------------------------------------------------------------------------

def headline_metric(dev, batch) -> str:
    if dev.type != "cuda":
        return "birdnet-v2.4 ONNX-lowered realtime (cpu smoke, tiny)"
    return ("birdnet-v2.4 ONNX-lowered full-scale inference realtime "
            f"(cuda, batch {batch}, bf16, fused mel front-end)")


def run(args, dev, run_: Run) -> dict:
    """Every selected measurement in order; returns the result line."""
    only = KEYS if not args.only else args.only.split(",")
    unknown = [k for k in only if k not in KEYS]
    if unknown:
        raise ValueError(f"unknown measurement(s) {unknown}; keys: {KEYS}")
    card = card_of(dev)
    extra = {"card": card, "device": str(dev), "seed": args.seed,
             "baseline": "BASELINE.md: TensorRT b32 (v2.4) and CUDA b32 "
                         "(Perch v2) on an RTX 5080",
             "measurements": {}}
    extra["kernel_build_s"] = build_kernels(dev)
    run_.record("extra", extra)
    for key in (k for k in KEYS if k in only):
        run_.check_deadline()
        log(f"{key}: start ({run_.remaining():.0f} s left)")
        if key == E2E:
            rec = measure_e2e(args.batch or default_batch("birdnet-v24", dev),
                              args.e2e_seconds, args.e2e_files, args.seed,
                              dev)
        else:
            mm = MEASUREMENTS[key]
            prep = prepare(mm.family, mm.precision, dev, native=mm.native)
            rec = measure(prep, args.batch or default_batch(mm.family, dev),
                          args.iters, args.repeats, args.seed, dev)
            del prep
            if dev.type == "cuda":
                import torch

                torch.cuda.empty_cache()
        extra["measurements"][key] = rec
        extra[f"{key}_x_realtime"] = rec["x_realtime"]
        if key in VS_BASELINE:
            name, base = VS_BASELINE[key]
            extra[name] = rec["x_realtime"] / base
        run_.record("extra", extra)
        log(f"{key}: {rec['x_realtime']:,.1f}x realtime")
    extra["elapsed_s"] = time.monotonic() - run_.t0
    head = extra["measurements"].get(HEADLINE)
    value = head["x_realtime"] if head else None
    return {"metric": headline_metric(dev, head["batch"] if head else None),
            "value": value, "unit": "x realtime",
            "vs_baseline": (value / BASELINE_BIRDNET_V24
                            if value is not None else None),
            "extra": extra}


def common_parser(description: str, batch: bool = True
                  ) -> argparse.ArgumentParser:
    """The arguments the three tools share: the device, the step counts,
    the seed, the deadline and (where one batch is measured) ``--batch``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="auto",
                    help="auto (the card: cuda:0), cuda or cpu (tiny graphs)")
    if batch:
        ap.add_argument("--batch", type=int, default=None,
                        help="batch of every measurement (default: the "
                        "port's CUDA default of each family)")
    ap.add_argument("--iters", type=int, default=6,
                    help="distinct batches on the device; each timed "
                    f"window steps through them for at least "
                    f"{MIN_WINDOW_S:g} s")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed windows per measurement")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", type=float, default=None,
                    help="hard deadline in seconds (default: "
                    "BIRDA_BENCH_BUDGET, else 1380)")
    return ap


def parser() -> argparse.ArgumentParser:
    ap = common_parser(__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help=f"comma-separated keys of {KEYS}")
    ap.add_argument("--e2e-seconds", type=float, default=600.0)
    ap.add_argument("--e2e-files", type=int, default=4)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    budget = budget_default() if args.budget is None else args.budget
    with Run(budget) as run_:
        dev = resolve_device(args.device)
        line = run(args, dev, run_)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
