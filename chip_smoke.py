#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``birda_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``birda_tpu_torch/csrc`` (one
``nvcc`` each, all at once), prints ``ptxas``'s report of each, and holds
each against its plain PyTorch version at the main paths' shapes and beside
them (v2.4 at the CUDA default batch 64, an odd hop, a bf16 signal), timing
``fused_logmel`` beside a bf16 cuBLAS composition of the same front-end and
``conv1d_stft`` beside ``F.conv1d``. Then it drives
``birda_tpu_torch.api.analyze`` on two full-width graphs with random weights
from a seed:

- BirdNET v2.4 over two generated 120 s recordings (48 kHz; 44.1 kHz, which
  runs the device resampler), through ``fused_logmel``, in bf16, int8 (twice:
  the second run loads the cached calibration scales) and mixed;
- Perch v2 over two generated 160 s recordings (32 kHz; 48 kHz, which runs
  the device resampler), through ``conv1d_stft``, in bf16 and int8 (twice).

Each main path runs with the launch counts set to 0 just before it and read
just after, and must have launched its kernel. Each model's bf16, int8 and
(v2.4) mixed routes are compared with its fp32 route on one chunk, and each
is timed and profiled on that chunk. The ``int8_ops`` phase holds the exact
integer routes of the int8 convs and matmuls (``torch._int_mm`` and the exact
fp32 depthwise route) bit for bit against CPU float64 products at the
shapes of the two graphs' quantized nodes at batch 32, and times them beside
the bf16 call of the same shape. Each phase prints one JSON line; then come
the card's name and power limit, the kernel summary line and, last,
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and no result line is printed, as it is without a CUDA device
or outside a checkout.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

#: Bounds: the JAX package's own on-chip log-mel bound
#: (scripts/verify_kernels_tpu.py), its Conv1d-STFT kernel bound (max error
#: over max |want|, tests/test_stft_kernel.py) and its bf16-vs-fp32 score
#: drift bound (tests/test_stft_kernel.py).
LOGMEL_Q99_BOUND = 5e-2
CONV_REL_BOUND = 2e-2
SCORE_DRIFT_BOUND = 5e-2
BATCH = 32
SEED = 1
#: Timing: calls queued back to back per window, and windows (median).
TIMING_REPS = 20
TIMING_ROUNDS = 7
#: Chunk steps timed on the host clock, and chunk steps profiled.
STEP_ITERS = 10
PROFILE_STEPS = 3
#: Perch v2's softmax over 14,795 classes gives random weights scores far
#: below the default 0.1 confidence: its runs keep the top 5 of each segment
#: above a floor of 1e-6, and its drift is taken relative to the largest
#: score.
PERCH_MIN_CONFIDENCE = 1e-6
PERCH_TOP_K = 5
#: One NVIDIA H100 SXM, from its published specification: HBM bytes per
#: second and dense bf16 tensor-core operations per second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed_ms(fn) -> float:
    """Device time per call of ``fn``: after a warm-up, a sleep kernel lets
    the host queue ``TIMING_REPS`` calls, which then run back to back
    between two CUDA events, so the host's own time per call is not counted;
    the median of ``TIMING_ROUNDS`` such windows."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_ROUNDS):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMING_REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / TIMING_REPS)
    times.sort()
    return times[len(times) // 2]


def bound(n_bytes: int, flops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the bf16 operations over the tensor-core rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"bytes": n_bytes, "flops": flops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def write_wav(path: Path, x, rate: int) -> None:
    import numpy as np

    pcm = (np.clip(x, -1.0, 1.0) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def recording(rate: int, seconds: float, seed: int):
    """Chirps over noise: a deterministic stand-in for a field recording."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    f = 2500 + 1500 * np.sin(2 * np.pi * 0.7 * t)
    chirp = np.sin(2 * np.pi * np.cumsum(f) / rate)
    gate = (np.sin(2 * np.pi * 0.25 * t) > 0.3).astype(np.float64)
    return (0.3 * chirp * gate + rng.normal(0, 0.02, t.shape)) \
        .astype(np.float32)


def dft_weight(n_fft: int):
    """Hann-windowed [cos ; -sin] DFT rows, the Conv1d-STFT weight."""
    import numpy as np

    bins = n_fft // 2 + 1
    n = np.arange(n_fft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft)
    ang = 2 * np.pi * np.arange(bins)[:, None] * n[None, :] / n_fft
    return np.concatenate([np.cos(ang) * win, -np.sin(ang) * win]) \
        .astype(np.float32)


def composed_logmel(x, w, fb, hop, eps):
    """The log-mel front-end as a bf16 cuBLAS composition (unfold, matmul,
    power, matmul, log): the yardstick ``fused_logmel`` is timed against.
    The port never calls it."""
    import torch

    bins = fb.shape[0]
    frames = x.to(torch.bfloat16).unfold(-1, w.shape[1], hop)
    spec = torch.matmul(frames, w.T)
    re, im = spec[..., :bins].float(), spec[..., bins:].float()
    power = (re * re + im * im).to(torch.bfloat16)
    return torch.log(torch.matmul(power, fb).float() + eps).to(torch.bfloat16)


def timed_against_plain(rec, kernel, plain, library=None, key="library_ms"):
    """Adds the kernel's, its plain version's and (where given) a library
    call's times to ``rec``, and the kernel's share of its bound."""
    rec["ms"] = timed_ms(kernel)
    rec["plain_ms"] = timed_ms(plain)
    if library is not None:
        rec[key] = timed_ms(library)
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]


def logmel_kernel_phase(w24, fb24, hop24, eps, dev):
    """fused_logmel against fused_logmel_reference at the main path's
    shapes (v2.4 at batch 16, 32 and 64, the CUDA default), the v3.0
    geometry, an odd hop, a bf16 signal and a T below one frame tile; timed
    beside a bf16 cuBLAS composition of the same front-end."""
    import numpy as np
    import torch

    from birda_tpu_torch.ops import stft_conv

    rng = np.random.default_rng(SEED)
    w30 = torch.from_numpy(dft_weight(1024)).to(dev, torch.bfloat16)
    fb30 = torch.from_numpy(
        rng.uniform(0, 0.05, (513, 128)).astype(np.float32)).to(
            dev, torch.bfloat16)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, w, fb, hop, B, S, signal dtype, timed
        ("v24_b16", w24, fb24, hop24, 16, 144_000, f32, True),
        ("v24_b32", w24, fb24, hop24, BATCH, 144_000, f32, True),
        ("v24_b64", w24, fb24, hop24, 64, 144_000, f32, True),
        ("v30_b16", w30, fb30, 320, 16, 160_000, f32, True),
        ("v24_odd_hop", w24, fb24, hop24 + 1, 4, 144_000, f32, True),
        ("v24_bf16_signal", w24, fb24, hop24, 4, 144_000, bf16, False),
        ("v24_short_t", w24, fb24, hop24, 2, 6_000, f32, False),
    ]
    results = {}
    for name, w, fb, hop, b, s, dtype, timed in cases:
        x = torch.from_numpy(
            rng.normal(0, 0.1, (b, s)).astype(np.float32)).to(dev, dtype)
        layout = stft_conv.prepare_logmel_weights(w, fb)
        got = stft_conv.fused_logmel(x, w, fb, hop, eps, prepared=layout)
        torch.cuda.synchronize()
        want = stft_conv.fused_logmel_reference(x, w, fb, hop, eps)
        t = (s - w.shape[1]) // hop + 1
        check(tuple(got.shape) == (b, t, fb.shape[1]),
              f"{name}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{name}: non-finite log-mel")
        err = (got.float() - want.float()).abs().flatten()
        bins, m = fb.shape
        rec = {"phase": "kernel", "kernel": "fused_logmel", "case": name,
               "shape": list(got.shape), "hop": hop,
               "signal_dtype": str(dtype).removeprefix("torch."),
               "q99_abs_err": float(torch.quantile(err, 0.99)),
               "max_abs_err": float(err.max()),
               "q99_bound": LOGMEL_Q99_BOUND,
               **bound(nbytes(x, w, fb, got),
                       2 * b * t * (w.shape[1] * w.shape[0] + bins * m))}
        check(rec["q99_abs_err"] < LOGMEL_Q99_BOUND,
              f"{name}: log-mel q99 error {rec['q99_abs_err']}")
        if timed:
            timed_against_plain(
                rec,
                lambda: stft_conv.fused_logmel(x, w, fb, hop, eps,
                                               prepared=layout),
                lambda: stft_conv.fused_logmel_reference(x, w, fb, hop, eps),
                lambda: composed_logmel(x, w, fb, hop, eps), "composed_ms")
        emit(rec)
        results[name] = rec
    return results


def conv1d_kernel_phase(dev):
    """conv1d_stft against conv1d_stft_reference at Perch v2's framer
    shape (random and identity weights), the v2.4 unfused geometry, an odd
    hop, a bf16 signal and a T below one frame tile; timed beside
    ``F.conv1d`` in bf16, the one PyTorch call that computes the same
    function."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from birda_tpu_torch.ops import stft_conv

    rng = np.random.default_rng(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, B, S, K, hop, C, weight, signal dtype, timed
        ("perch_b32", BATCH, 160_000, 640, 320, 640, "random", f32, True),
        ("perch_identity", BATCH, 160_000, 640, 320, 640, "identity", f32,
         True),
        ("v24_geometry", 4, 144_000, 2048, 278, 2050, "random", f32, True),
        ("odd_hop", 4, 40_000, 1000, 161, 200, "random", f32, True),
        ("perch_bf16_signal", 4, 160_000, 640, 320, 640, "identity", bf16,
         False),
        ("short_t", 2, 6_000, 2048, 278, 40, "random", f32, False),
    ]
    results = {}
    for name, b, s, k, hop, c, kind, dtype, timed in cases:
        x = torch.from_numpy(
            rng.normal(0, 0.1, (b, s)).astype(np.float32)).to(dev, dtype)
        w = (torch.eye(k) if kind == "identity" else torch.from_numpy(
            rng.normal(0, 0.02, (c, k)).astype(np.float32))).to(dev)
        layout = stft_conv.prepare_conv1d_weights(w)
        got = stft_conv.conv1d_stft(x, w, hop, prepared=layout)
        torch.cuda.synchronize()
        want = stft_conv.conv1d_stft_reference(x, w, hop)
        t = (s - k) // hop + 1
        check(tuple(got.shape) == (b, c, t), f"{name}: shape "
              f"{tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        rec = {"phase": "kernel", "kernel": "conv1d_stft", "case": name,
               "shape": list(got.shape), "hop": hop,
               "signal_dtype": str(dtype).removeprefix("torch."),
               "max_abs_err": err,
               "rel_err": rel, "rel_bound": CONV_REL_BOUND,
               **bound(nbytes(x, got) + c * k * 2, 2 * b * t * k * c)}
        check(rel < CONV_REL_BOUND, f"{name}: relative error {rel}")
        if kind == "identity":
            rec["bit_exact"] = bool(torch.equal(got, want))
            check(rec["bit_exact"], f"{name}: not the bf16 frames exactly")
        if timed:
            xb = x.to(torch.bfloat16)[:, None, :]
            wb = w.to(torch.bfloat16)[:, None, :]
            timed_against_plain(
                rec,
                lambda: stft_conv.conv1d_stft(x, w, hop, prepared=layout),
                lambda: stft_conv.conv1d_stft_reference(x, w, hop),
                lambda: F.conv1d(xb, wb, stride=hop))
        emit(rec)
        results[name] = rec
    return results


def int8_graph_report(name, onnx_path, sample_count):
    """The int8 lowering of ``onnx_path`` (bf16 compute, the scales the
    main path cached): its static cost report at batch 32, from a run on
    meta tensors during which every integer product's shapes are recorded
    (the int8_ops cases come from these). Returns the recorded convs and
    matmuls."""
    from unittest import mock

    import torch

    from birda_tpu_torch.onnx import lowering
    from birda_tpu_torch.onnx.quantize import (cached_calibration,
                                               int8_cost_report, lower_int8)

    data = Path(onnx_path).read_bytes()
    calib, _ = cached_calibration(data, sample_count, device="cuda")
    fn = lower_int8(data, calib, compute_dtype=torch.bfloat16)
    convs, mms = [], []
    conv, matmul = lowering.int_conv, lowering.int_matmul

    def record_conv(x, w, strides, pads, dilations, group, **kw):
        convs.append((tuple(x.shape), tuple(w.shape), tuple(strides),
                      tuple(tuple(p) for p in pads), tuple(dilations),
                      group))
        return conv(x, w, strides, pads, dilations, group, **kw)

    def record_matmul(a, b, n=None):
        mms.append((tuple(a.shape), tuple(b.shape)))
        return matmul(a, b, n)

    with mock.patch.object(lowering, "int_conv", record_conv), \
            mock.patch.object(lowering, "int_matmul", record_matmul):
        cost = int8_cost_report(fn, torch.empty(BATCH, sample_count))
    emit({"phase": f"{name}_int8_cost", "batch": BATCH, **cost,
          "quantized_nodes": len(fn.quantized_nodes),
          "int8_boundary_tensors": len(fn.int8_boundary_tensors),
          "int_convs": len(convs), "int_matmuls": len(mms)})
    return sorted(set(convs)), sorted(set(mms))


def int8_cases(convs24, mms24, convs_perch):
    """The int8_ops cases: the widest (most MACs) and the narrowest (fewest
    output channels) 1x1 conv, the largest 5x5 and 3x3 depthwise conv, and
    Perch's deepest dense 3x3 conv, at batch 32 as the graphs run them; a
    Gemm at v2.4's embedding head, at batch 32 and 1."""
    import numpy as np

    def macs(c):
        x, w = c[0], c[1]
        return int(np.prod(x)) // x[1] * w[0] * int(np.prod(w[1:]))

    every = convs24 + convs_perch
    pointwise = [c for c in every if c[5] == 1 and c[1][2:] == (1, 1)]
    cases = {"widest_1x1": max(pointwise, key=macs),
             "narrowest_1x1": min(pointwise, key=lambda c: (c[1][0], -macs(c)))}
    for k in (5, 3):
        dw = [c for c in every if c[5] > 1 and c[1][2:] == (k, k)]
        if dw:
            cases[f"depthwise_{k}x{k}"] = max(dw, key=macs)
    dense = [c for c in convs_perch if c[5] == 1 and c[1][2:] == (3, 3)]
    if dense:
        cases["perch_deepest_dense_3x3"] = max(
            dense, key=lambda c: (int(np.prod(c[1][1:])), macs(c)))
    gemm = [("gemm_head", (BATCH, 1280), (1280, 1024)),
            ("gemm_head_b1", (1, 1280), (1280, 1024))]
    gemm += [(f"matmul_{i}", a, b) for i, (a, b) in enumerate(mms24)]
    return cases, gemm


def int8_ops_phase(cases, gemms, dev):
    """Each integer route on the card at the quantized nodes' shapes,
    bit for bit against the CPU float64 product (random int8, random-sign
    ±127, and the extreme +127 x -127 operands), timed beside the bf16
    ``F.conv2d``/``matmul`` of the same shape; a 1x1 conv whose depth allows
    it is also timed through the exact fp32 route (the measurement behind
    ``lowering.int_conv_route``'s choice of ``_int_mm`` for 1x1 convs)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from birda_tpu_torch.onnx import lowering

    rng = np.random.default_rng(SEED)

    def operands(shape, kind):
        if kind == "random":
            v = rng.integers(-127, 128, shape)
        elif kind == "pm127":
            v = 127 * rng.choice([-1, 1], shape)
        else:
            v = np.full(shape, 127 if kind == "x" else -127)
        return torch.from_numpy(v.astype(np.int8))

    results = {}
    for name, (xs, ws, strides, pads, dil, group) in cases.items():
        route = lowering.int_conv_route(xs, ws, strides, pads, dil, group,
                                        "cuda")
        exact = {}
        for kind in ("random", "pm127", "extreme"):
            x = operands(xs, "x" if kind == "extreme" else kind)
            w = operands(ws, "w" if kind == "extreme" else kind)
            want = lowering.int_conv(x, w, strides, pads, dil, group,
                                     route="float64")
            xd, wd = x.to(dev), w.to(dev)
            prep = lowering.prepare_int_conv_weight(wd, route)
            got = lowering.int_conv(xd, wd, strides, pads, dil, group,
                                    route=route, prepared=prep)
            exact[kind] = bool(torch.equal(got.cpu(), want))
        depth = int(np.prod(ws[1:]))
        rec = {"phase": "int8_ops", "case": name, "x": list(xs),
               "w": list(ws), "strides": list(strides), "group": group,
               "depth": depth, "route": route, "bit_exact": exact,
               "macs": got.numel() * depth}
        check(all(exact.values()), f"int8_ops {name}: not exact {exact}")
        rec["ms"] = timed_ms(lambda: lowering.int_conv(
            xd, wd, strides, pads, dil, group, route=route, prepared=prep))
        xb, wb = xd.to(torch.bfloat16), wd.to(torch.bfloat16)
        lo = [p[0] for p in pads]
        if lo != [p[1] for p in pads]:
            xb = F.pad(xb, [v for pair in reversed(pads) for v in pair])
            lo = [0] * len(pads)
        rec["bf16_ms"] = timed_ms(lambda: F.conv2d(xb, wb, None, strides, lo,
                                                   dil, group))
        if route == "int_mm" and depth <= lowering.EXACT_FP32_DEPTH:
            f32 = lowering.prepare_int_conv_weight(wd, "fp32")
            got = lowering.int_conv(xd, wd, strides, pads, dil, group,
                                    route="fp32", prepared=f32)
            rec["fp32_route_bit_exact"] = bool(torch.equal(got.cpu(), want))
            check(rec["fp32_route_bit_exact"], f"int8_ops {name}: fp32 route")
            rec["fp32_route_ms"] = timed_ms(lambda: lowering.int_conv(
                xd, wd, strides, pads, dil, group, route="fp32",
                prepared=f32))
        emit(rec)
        results[name] = rec
    for name, a_shape, b_shape in gemms:
        exact = {}
        for kind in ("random", "pm127", "extreme"):
            a = operands(a_shape, "x" if kind == "extreme" else kind)
            b = operands(b_shape, "w" if kind == "extreme" else kind)
            want = lowering.int_matmul(a, b)
            ad = a.to(dev)
            bd = lowering.int_mm_weight(b.to(dev))
            got = lowering.int_matmul(ad, bd, b_shape[1])
            exact[kind] = bool(torch.equal(got.cpu(), want))
        rec = {"phase": "int8_ops", "case": name, "a": list(a_shape),
               "b": list(b_shape), "route": "int_mm", "bit_exact": exact,
               "macs": a_shape[0] * a_shape[1] * b_shape[1]}
        check(all(exact.values()), f"int8_ops {name}: not exact {exact}")
        rec["ms"] = timed_ms(lambda: lowering.int_matmul(ad, bd, b_shape[1]))
        ab = ad.to(torch.bfloat16)
        bb = b.to(dev, torch.bfloat16)
        rec["bf16_ms"] = timed_ms(lambda: torch.matmul(ab, bb))
        emit(rec)
        results[name] = rec
    return results


def write_graph(spec, tmp: Path):
    """The full-scale graph of ``spec`` (random weights from ``SEED``), its
    ONNX file and its labels file."""
    from birda_tpu_torch.models.zoo import synthetic_labels
    from birda_tpu_torch.onnx import fullscale

    t0 = time.perf_counter()
    graph = fullscale.cached_build(spec, seed=SEED)
    onnx_path = tmp / f"{spec.name}.onnx"
    onnx_path.write_bytes(graph.model_bytes)
    labels = synthetic_labels(spec.num_classes)
    labels_path = tmp / f"{spec.name}-labels.txt"
    labels_path.write_text("\n".join(labels) + "\n")
    emit({"phase": "fixture", "graph": spec.name,
          "params": graph.param_count, "macs_per_segment": graph.macs,
          "onnx_bytes": len(graph.model_bytes),
          "seconds": time.perf_counter() - t0})
    return graph, onnx_path, labels_path, labels


def main_path(phase, kernel, wavs, onnx_path, labels_path, model_type,
              precision="bf16", **kw):
    """``analyze`` at ``precision`` and batch 32 on the card, with the
    launch counts set to 0 just before and read just after; checks the run
    went through ``kernel`` and produced finite confidences in [0, 1] for
    every file. Returns the launch counts and the result."""
    import numpy as np
    import torch

    from birda_tpu_torch.api import analyze
    from birda_tpu_torch.ops import stft_conv

    torch.cuda.reset_peak_memory_stats()
    stft_conv.LAUNCHES.clear()
    t0 = time.perf_counter()
    result = analyze(wavs, model_path=onnx_path, labels_path=labels_path,
                     model_type=model_type, device="gpu",
                     precision=precision, batch_size=BATCH, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(stft_conv.LAUNCHES)
    summary = result.summary or {}
    rec = {"phase": phase, "precision": result.precision,
           "backend": result.backend,
           "exit_code": result.exit_code, "launches": launches,
           "files": [{"file": f.path.name, "detections": len(f.detections),
                      "error": f.error} for f in result.files],
           "segments": summary.get("total_segments"),
           "pipeline_ms": summary.get("duration_ms"),
           "wall_s_with_load": wall,
           "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}
    if summary.get("duration_ms"):
        rec["segments_per_s"] = (summary["total_segments"]
                                 / (summary["duration_ms"] / 1000))
        rec["realtime_factor"] = summary["realtime_factor"]
    emit(rec)
    check(result.exit_code == 0, f"{phase}: analyze exit code")
    check((result.backend or {}).get("actual") == "cuda",
          f"{phase}: backend {result.backend}")
    check(launches.get(kernel, 0) > 0,
          f"{phase}: the main path never launched {kernel}")
    check(len(result.files) == len(wavs) and all(
        f.ok and f.detections for f in result.files),
          f"{phase}: detections for every file")
    check(all(0.0 <= d.confidence <= 1.0 and np.isfinite(d.confidence)
              for d in result.detections),
          f"{phase}: confidences in [0, 1]")
    return launches, result


def detections_of(result):
    return [[(d.start_time, d.end_time, d.scientific_name, d.confidence)
             for d in f.detections] for f in result.files]


def quantized_main_paths(suffix, kernel, wavs, onnx_path, labels_path,
                         model_type, calib_log, mixed, **kw):
    """int8 (and, for ``mixed``, mixed) ``analyze`` at batch 32: the first
    int8 run calibrates on the built-in set and caches the scales, a second
    int8 run loads them and must give identical detections, and mixed loads
    them too. Checks each run's precision report: int8 quantizes nodes and
    stores boundary tensors, mixed only stores. Returns the launch counts
    by precision."""
    from birda_tpu_torch.config.paths import cache_dir

    calib_log.records.clear()
    launches, first = main_path(f"main_path_int8{suffix}", kernel, wavs,
                                onnx_path, labels_path, model_type,
                                precision="int8", **kw)
    info = first.precision or {}
    check(info.get("mode") == "int8" and info.get("quantized_nodes", 0) > 0
          and info.get("int8_boundary_tensors", 0) >= 1,
          f"main_path_int8{suffix}: precision report {info}")
    cached = sorted((cache_dir() / "int8_calib").glob("*.json"))
    stamp = [p.stat().st_mtime_ns for p in cached]
    _, again = main_path(f"main_path_int8_cached{suffix}", kernel, wavs,
                         onnx_path, labels_path, model_type,
                         precision="int8", **kw)
    check(sorted((cache_dir() / "int8_calib").glob("*.json")) == cached
          and [p.stat().st_mtime_ns for p in cached] == stamp,
          f"main_path_int8_cached{suffix}: the cached scales were rewritten")
    check(detections_of(again) == detections_of(first),
          f"main_path_int8_cached{suffix}: detections differ from the first run")
    out = {"int8": launches}
    if mixed:
        out["mixed"], res = main_path(f"main_path_mixed{suffix}", kernel,
                                      wavs, onnx_path, labels_path,
                                      model_type, precision="mixed", **kw)
        info = res.precision or {}
        check(info.get("mode") == "mixed"
              and info.get("quantized_nodes") == 0
              and info.get("int8_boundary_tensors", 0) >= 1,
              f"main_path_mixed{suffix}: precision report {info}")
    emit({"phase": f"calibration{suffix}", "cache_files": len(cached),
          "runs": [{"scales": src, "seconds": sec}
                   for src, sec in calib_log.records]})
    check([src for src, _ in calib_log.records][:1] == ["computed"],
          f"calibration{suffix}: the first int8 run did not calibrate")
    check(all(src == "loaded from cache"
              for src, _ in calib_log.records[1:]),
          f"calibration{suffix}: a later run recalibrated")
    return out


class CalibrationLog(logging.Handler):
    """Keeps the orchestrator's calibration records: (scales, seconds)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        if record.getMessage().startswith("int8 calibration scales"):
            self.records.append(record.args)


def bf16_vs_fp32(phase, family, onnx_path, labels, wav, relative: bool,
                 step_phase: str):
    """One 32-row chunk through the bf16 route (the kernels) and the fp32
    route (plain, TF32 off); the largest score drift, absolute or relative
    to the largest fp32 score, within ``SCORE_DRIFT_BOUND``. The bf16 route
    is also timed and profiled on that chunk (``step_phase``)."""
    import numpy as np
    import torch

    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.contracts import contract_for
    from birda_tpu_torch.models.zoo import onnx_model

    contract = contract_for(family)
    n = contract.num_classes
    seg = contract.sample_count
    with wave.open(str(wav)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    chunk = pcm[:(BATCH - 1) * seg + seg].astype(np.float32) / 32767.0
    scores = {}
    torch.cuda.reset_peak_memory_stats()
    for precision, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        model = onnx_model(onnx_path, contract, labels, dtype=dtype)
        clf = BirdClassifier(model, device="cuda", min_confidence=0.0,
                             top_k=n)
        rows = clf.chunk_runner(BATCH, seg).predict_chunk(chunk, BATCH)
        full = np.zeros((BATCH, n), np.float64)
        for r, res in enumerate(rows):
            for p in res.predictions:
                full[r, p.index] = p.confidence
        scores[precision] = full
        if dtype is not None:
            steady_step(step_phase, BirdClassifier(
                model, device="cuda", min_confidence=0.0, top_k=5), chunk)
        del clf, model
    drift = float(np.abs(scores["bf16"] - scores["fp32"]).max())
    top = float(scores["fp32"].max())
    measured = drift / top if relative else drift
    emit({"phase": phase, "rows": BATCH, "classes": n,
          "max_score_drift": drift, "max_fp32_score": top,
          "drift_over_max_score" if relative else "drift": measured,
          "bound": SCORE_DRIFT_BOUND,
          "top1_agreement": float(np.mean(scores["bf16"].argmax(1)
                                          == scores["fp32"].argmax(1))),
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    check(np.isfinite(measured) and measured <= SCORE_DRIFT_BOUND,
          f"{phase}: bf16 score drift {measured}")
    return chunk, scores["fp32"]


def quantized_vs_fp32(phase, family, onnx_path, labels, chunk, fp32,
                      relative: bool, precision: str, step_phase: str):
    """The same 32-row chunk through the ``precision`` (int8 or mixed)
    route, with the scales the main path cached; its drift against the fp32
    scores, absolute or relative to the largest fp32 score, within
    ``SCORE_DRIFT_BOUND``, and ``compare_scores``'s report. The route is
    then timed and profiled on that chunk (``step_phase``)."""
    import numpy as np
    import torch

    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.contracts import contract_for
    from birda_tpu_torch.models.zoo import onnx_model_int8
    from birda_tpu_torch.onnx.int8_accuracy import compare_scores
    from birda_tpu_torch.onnx.quantize import cached_calibration

    contract = contract_for(family)
    n = contract.num_classes
    data = Path(onnx_path).read_bytes()
    calib, from_cache = cached_calibration(data, contract.sample_count,
                                           device="cuda")
    check(from_cache, f"{phase}: no cached scales")
    t0 = time.perf_counter()
    model = onnx_model_int8(data, contract, labels, calib,
                            compute_dtype=torch.bfloat16,
                            storage_only=precision == "mixed")
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    clf = BirdClassifier(model, device="cuda", min_confidence=0.0, top_k=n)
    rows = clf.chunk_runner(BATCH, contract.sample_count).predict_chunk(
        chunk, BATCH)
    got = np.zeros((BATCH, n), np.float64)
    for r, res in enumerate(rows):
        for p in res.predictions:
            got[r, p.index] = p.confidence
    drift = float(np.abs(got - fp32).max())
    top = float(fp32.max())
    measured = drift / top if relative else drift
    rep = compare_scores(fp32, got)
    emit({"phase": phase, "precision": model.precision_info, "rows": BATCH,
          "classes": n, "load_s": load_s, "max_score_drift": drift,
          "max_fp32_score": top,
          "drift_over_max_score" if relative else "drift": measured,
          "bound": SCORE_DRIFT_BOUND,
          "compare_scores": {
              "max_abs_delta": rep.max_abs_delta,
              "mean_abs_delta": rep.mean_abs_delta,
              "top1_agreement": rep.top1_agreement,
              "top5_jaccard": rep.top5_jaccard,
              "crossings": [[x.threshold, x.both, x.fp32_only, x.int8_only]
                            for x in rep.crossings],
              "worst_species": rep.worst_species[:3]},
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    check(np.isfinite(measured) and measured <= SCORE_DRIFT_BOUND,
          f"{phase}: {precision} score drift {measured}")
    del clf
    steady_step(step_phase, BirdClassifier(
        model, device="cuda", min_confidence=0.0, top_k=5), chunk)


def steady_step(phase, clf, chunk):
    """The bf16 chunk step on a warm runner: host-clock time per step over
    ``STEP_ITERS`` steps, then a ``torch.profiler`` window of
    ``PROFILE_STEPS`` steps for the device's busy time (the union of the
    kernels' spans), the launches per step and the kernels that take the
    most device time."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner = clf.chunk_runner(BATCH, clf.sample_count)
    for _ in range(2):
        runner.predict_chunk(chunk, BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEP_ITERS):
        runner.predict_chunk(chunk, BATCH)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEP_ITERS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            runner.predict_chunk(chunk, BATCH)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:80]] += e.time_range.elapsed_us()
    busy_ms = busy_us / PROFILE_STEPS / 1e3
    emit({"phase": phase, "batch": BATCH, "chunk_step_ms": step_ms,
          "segments_per_s": BATCH / step_ms * 1e3,
          "device_busy_ms_per_step": busy_ms,
          "device_idle_share": (1 - busy_ms / step_ms) if busy_ms else None,
          "kernels_per_step": len(kernels) / PROFILE_STEPS,
          "top_kernels_ms_per_step": [
              [name, us / PROFILE_STEPS / 1e3]
              for name, us in by_name.most_common(8)]})


def kernel_entry(name, source, replaces, launches, case, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case.get("library_ms"),
            "share_of_bound": case["share_of_bound"], **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        return 1
    from birda_tpu_torch.models.contracts import ModelFamily
    from birda_tpu_torch.native import audio as native_audio
    from birda_tpu_torch.onnx import fullscale
    from birda_tpu_torch.onnx.lowering import lower
    from birda_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)

    # -- 1. card and kernel builds ----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    # ptxas's report of each build: registers, spills and the wgmma
    # serialisation warnings, per kernel instantiation.
    ptxas = {name: _build.ptxas_summary(
        name, _build.report_path(name).read_text())
        for name in _build.SOURCES}
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels": list(_build.SOURCES), "kernel_build_s": build_s,
          "native_decoder_loaded": native_audio.available(),
          "ptxas": ptxas,
          "ptxas_spilling": [f["function"] for fs in ptxas.values()
                             for f in fs
                             if f["spill_store_bytes"] or f["warnings"]]})

    calib_log = CalibrationLog()
    orchestrator_log = logging.getLogger("birda_tpu_torch.orchestrator")
    orchestrator_log.setLevel(logging.INFO)
    orchestrator_log.addHandler(calib_log)
    with tempfile.TemporaryDirectory(prefix="birda-smoke-") as tmp:
        tmp = Path(tmp)
        os.environ["XDG_CACHE_HOME"] = str(tmp / "cache")
        os.environ["XDG_CONFIG_HOME"] = str(tmp / "config")

        # -- 2. BirdNET v2.4: fused_logmel ---------------------------------
        graph, onnx24, labels24_path, labels24 = write_graph(
            fullscale.BIRDNET_V24_SPEC, tmp)
        wavs24 = []
        for i, rate in enumerate((48_000, 44_100)):
            p = tmp / f"field_{rate}.wav"
            write_wav(p, recording(rate, 120.0, SEED + i), rate)
            wavs24.append(p)
        fn = lower(graph.model_bytes, compute_dtype=torch.bfloat16)
        node = next(n for n in fn.graph.nodes
                    if n.op_type == "BirdaFusedMelFrontend")
        w24 = torch.tensor(fn.params[node.inputs[1]][:, 0, :]).to(
            dev, torch.bfloat16)
        fb24 = torch.tensor(fn.params[node.inputs[2]]).to(
            dev, torch.bfloat16)
        logmel = logmel_kernel_phase(w24, fb24, node.attr("hop"),
                                     node.attr("eps"), dev)
        del fn, graph, w24, fb24
        launches24, _ = main_path("main_path", "fused_logmel", wavs24,
                                  onnx24, labels24_path, "birdnet-v24")
        chunk24, fp32_24 = bf16_vs_fp32(
            "bf16_vs_fp32", ModelFamily.BIRDNET_V24, onnx24, labels24,
            wavs24[0], relative=False, step_phase="step")
        quant24 = quantized_main_paths("", "fused_logmel", wavs24, onnx24,
                                       labels24_path, "birdnet-v24",
                                       calib_log, mixed=True)
        for precision in ("int8", "mixed"):
            quantized_vs_fp32(f"{precision}_vs_fp32", ModelFamily.BIRDNET_V24,
                              onnx24, labels24, chunk24, fp32_24,
                              relative=False, precision=precision,
                              step_phase=f"step_{precision}")
        convs24, mms24 = int8_graph_report(
            "v24", onnx24, fullscale.BIRDNET_V24_SPEC.sample_count)

        # -- 3. Perch v2: conv1d_stft --------------------------------------
        conv = conv1d_kernel_phase(dev)
        graph, onnx_perch, labels_perch_path, labels_perch = write_graph(
            fullscale.PERCH_V2_SPEC, tmp)
        del graph
        wavs_perch = []
        for i, rate in enumerate((32_000, 48_000)):
            p = tmp / f"perch_field_{rate}.wav"
            write_wav(p, recording(rate, 160.0, SEED + 10 + i), rate)
            wavs_perch.append(p)
        launches_perch, _ = main_path(
            "main_path_perch", "conv1d_stft", wavs_perch, onnx_perch,
            labels_perch_path, "perch-v2",
            min_confidence=PERCH_MIN_CONFIDENCE, top_k=PERCH_TOP_K)
        chunk_perch, fp32_perch = bf16_vs_fp32(
            "bf16_vs_fp32_perch", ModelFamily.PERCH_V2, onnx_perch,
            labels_perch, wavs_perch[0], relative=True,
            step_phase="step_perch")
        quant_perch = quantized_main_paths(
            "_perch", "conv1d_stft", wavs_perch, onnx_perch,
            labels_perch_path, "perch-v2", calib_log, mixed=False,
            min_confidence=PERCH_MIN_CONFIDENCE, top_k=PERCH_TOP_K)
        quantized_vs_fp32("int8_vs_fp32_perch", ModelFamily.PERCH_V2,
                          onnx_perch, labels_perch, chunk_perch, fp32_perch,
                          relative=True, precision="int8",
                          step_phase="step_int8_perch")
        convs_perch, _ = int8_graph_report(
            "perch", onnx_perch, fullscale.PERCH_V2_SPEC.sample_count)

        # -- 4. the exact integer routes at the quantized nodes' shapes ----
        int8_ops_phase(*int8_cases(convs24, mms24, convs_perch), dev)

    print(smi, flush=True)
    emit({"kernels": [
        kernel_entry("fused_logmel", "birda_tpu_torch/csrc/fused_logmel.cu",
                     "birda_tpu/ops/stft_conv.py:241",
                     launches24.get("fused_logmel", 0), logmel["v24_b32"],
                     composed_ms=logmel["v24_b32"]["composed_ms"],
                     launches_int8=quant24["int8"].get("fused_logmel", 0),
                     launches_mixed=quant24["mixed"].get("fused_logmel", 0)),
        kernel_entry("conv1d_stft", "birda_tpu_torch/csrc/conv1d_stft.cu",
                     "birda_tpu/ops/stft_conv.py:121",
                     launches_perch.get("conv1d_stft", 0),
                     conv["perch_b32"],
                     launches_int8=quant_perch["int8"].get("conv1d_stft", 0)),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
