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

Then the secondary heads, each through ``analyze`` on the card in bf16:
the bat two-stage head (``bat="uk"``, a Gemm + Sigmoid head [B,1024] -> 38
over v2.4's embeddings, one 60 s recording at 256 kHz), the geomodel range
filter on v2.4 (the fixture geomodel at the real 12,012 species), regional
slicing on Perch v2 (softmax, renormalized) and on v2.4 (sigmoid), and
``api.species`` on the fixture geomodel, each held against a float64
evaluation on the host.

Then the parallel modes and the native family: ``main_path_jobs`` (v2.4
bf16 with ``jobs=2`` over the same two recordings: the sequential run's
detections and ``fused_logmel`` launches), ``sharded_step`` (the v2.4 bf16
chunk runner at batch 32 sharded over two replicas on ``cuda:0``, the
double of a second card: each replica launches ``fused_logmel`` on 16
rows, and the gathered scores agree with the unsharded step),
``main_path_native`` (``synthetic:full`` v2.4, the native backbone in fp32,
over the two v2.4 recordings: no hand kernel lies on it, so neither may
launch; one chunk against the port's CPU run of it, and ``step_native``)
and ``main_path_v30`` (full-scale BirdNET v3.0 over one generated 60 s
recording at 32 kHz, through ``fused_logmel``, in bf16, int8 (twice) and
mixed; bf16, int8 and mixed against fp32 on one chunk, the int8 and mixed
drifts printed and not held to the bound (ROADMAP C12: the JAX package
drifts as far), and ``step_v30``, ``step_v30_int8``, ``step_v30_mixed``).
``v30_int8_reference`` then runs the port's full-scale v3.0 int8 and
mixed at fp32 compute, lowered from the port's CPU calibration, on the
card and on the CPU: every value the two quantize apart must be a rounding
tie one step apart, and with those taken from the CPU run the card's
scores are the CPU's within 5e-3 with the same argmax (the CPU's are held
to the JAX package's so by ``tests/test_torch_int8_fullscale.py``); each
run left alone is printed against the JAX package's scores of the same
rows (``tests/data/v30_int8_jax_scores.npz``).

Then ``main_path_perch_qdq``: Perch v2 rewritten into the QDQ form of its
registry ``int8-arm`` variant (:func:`qdq_graph`) through ``analyze`` in
bf16, ``conv1d_stft`` taking the framer weight a DequantizeLinear makes on
the card; one chunk against the port's fp32 CPU run and one step with no
host sync (``torch.cuda.set_sync_debug_mode("error")``). And
``main_path_seq``: a spectrogram transformer at AST-base width and depth
(``tests/torch_seq_graphs.py``: v3.0's front end, 12 encoder layers as one
scan-over-layers ``Loop`` of ORT-optimizer layers, the head behind an
``If``) through ``analyze`` in bf16, through ``fused_logmel``; one chunk
in bf16 and fp32 on the card and on the CPU (``seq_chunk``), one step
with no host sync and ``step_seq``. At the end, ``qlinear_ops`` (the
QOperator integer products bit for bit at the ``int8_ops`` shapes) and
``ops_breadth`` (every case of ``tests/torch_op_cases.py`` on the card
against the CPU, each refusal refused on the card, each case that runs
called a second time with no host sync, and the recurrences' kernels per
time step).

Then the tools and the rest of the command line, on v2.4: ``kernel_routes``
(each geometry of ``tests/torch_route_graphs.py`` through ``lower`` in bf16
against the port's CPU run: the shipped and the wide front ends on their
kernels, an 80,000-sample window on ``conv1d_stft`` with its span streamed
in pieces, one window past the JAX package's budget too on its composed
route, none raising), ``verify_kernels`` (``scripts/verify_kernels_cuda.py``'s
cases: both kernels at ``verify_kernels_tpu.py``'s three geometries and at
the wide ones, and ``conv1d_stft`` at two long windows, against float64,
timed), ``parity_v24`` (``onnx/parity.py``'s
captures of the card's fp32 and bf16 runs of the full-scale graph walked
against recordings of the port's CPU runs, and its walk naming a planted
perturbation), ``accept_v24``
(``scripts/torch_accept_asset.py`` with that recording as its reference)
and ``cli_commands`` (the port's CLI in subprocesses: ``version``,
``providers``, ``config``, ``models add``/``check``/``list``, a bare-file
``analyze`` in bf16 and ``clip`` on its CSV). Then ``stft_gather`` (the one
phase that sets ``BIRDA_STFT_KERNEL``, to ``gather``: the v2.4 front end on
its composed route with no kernel launch, against the CPU),
``recall_report`` (``scripts/torch_int8_recall_report.py`` on 32 segments
of a v2.4 recording, on ``cuda:0``), ``host_budget``
(``scripts/torch_bench_host_budget.py`` at batch 32 over 120 s) and
``bench_tools`` (``scripts/torch_bench.py``, ``torch_bench_int8.py`` and
``torch_sweep_int8_batch.py`` in subprocesses, a few steps each, at the
port's CUDA default batches: v2.4 bf16, Perch v2 int8, v3.0 bf16, e2e on
one 60 s file, the native v2.4 backbone in bf16, v2.4 int8 against bf16,
and Perch v2 int8 at batch 32 and 64).

Each main path runs with the launch counts set to 0 just before it and read
just after, and must have launched its kernel (the native path: none). Each model's bf16, int8 and
(v2.4) mixed routes are compared with its fp32 route on one chunk, and each
is timed and profiled on that chunk. The ``int8_ops`` phase holds the exact
integer routes of the int8 convs and matmuls (``torch._int_mm`` and the exact
fp32 depthwise route) bit for bit against CPU float64 products at the
shapes of the two graphs' quantized nodes at batch 32, and times them beside
the bf16 call of the same shape, and a grouped conv of depth 1089 on the
split fp32 route. Each phase prints one JSON line; then come
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

# The port's measurement helpers: the card's name and power limit, device
# time per call, the device's busy time over a window of steps and the
# card's least time for a piece of work.
from birda_tpu_torch.inference.backend import card_line
from birda_tpu_torch.ops.measure import (bound, idle_share, profile_steps,
                                         timed_ms)

#: Bounds: the JAX package's own on-chip log-mel bound
#: (scripts/verify_kernels_tpu.py), its Conv1d-STFT kernel bound (max error
#: over max |want|, tests/test_stft_kernel.py) and its bf16-vs-fp32 score
#: drift bound (tests/test_stft_kernel.py).
LOGMEL_Q99_BOUND = 5e-2
CONV_REL_BOUND = 2e-2
SCORE_DRIFT_BOUND = 5e-2
#: The spectrogram transformer's fp32 scores on the card against the
#: port's fp32 CPU run of the same chunk (the product's fp32 parity budget).
SEQ_FP32_BOUND = 1e-3
BATCH = 32
SEED = 1
#: The JAX package's full-scale v3.0 int8 and mixed scores at fp32 compute
#: on its int8 bench's probe rows, and the same with one value rounded the
#: other way (``tests/torch_int8_fullscale.py`` writes them), and the bound
#: the card's are held to the CPU's there, tie for tie: the int8-fp32
#: bound of ``tests/test_torch_quantize.py::test_scores_match_jax``.
REFERENCE_SCORES = (Path(__file__).resolve().parent / "tests" / "data"
                    / "v30_int8_jax_scores.npz")
REFERENCE_BOUND = 5e-3
REFERENCE_ROWS = 8
REFERENCE_SEED = 123
#: Chunk steps timed on the host clock, and chunk steps profiled.
STEP_ITERS = 10
PROFILE_STEPS = 3
#: Perch v2's softmax over 14,795 classes gives random weights scores far
#: below the default 0.1 confidence: its runs keep the top 5 of each segment
#: above a floor of 1e-6, and its drift is taken relative to the largest
#: score.
PERCH_MIN_CONFIDENCE = 1e-6
PERCH_TOP_K = 5
#: Secondary heads: the bat head's classes (the widest regional head), the
#: geomodel's species (the BirdNET Geomodel v3.0.2 contract), the bound on
#: a head's card scores against float64 on the host, the bound on the
#: geomodel's scores, and the bound on renormalized regional Perch scores
#: relative to the largest.
BAT_CLASSES = 38
GEO_SPECIES = 12_012
HEAD_BOUND = 1e-5
GEO_BOUND = 1e-6
REGION_REL_BOUND = 1e-5
#: (lat, lon, week) of the range-filter and species queries: the fixture
#: geomodel's weights are N(0, 0.8) per unit of input, so near the origin
#: and early in the year its scores spread over (0, 1) instead of
#: saturating.
GEO_QUERY = (0.5, -1.2, 2)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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
    """fused_logmel against fused_logmel_reference at the main paths'
    shapes (v2.4 at batch 16, 32 and 64, the CUDA default; the v3.0
    geometry at batch 16 and at batch 32, which the v3.0 and spectrogram
    transformer paths run), an odd hop, a bf16 signal and a T below one
    frame tile; timed beside a bf16 cuBLAS composition of the same
    front-end."""
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
        ("v30_b32", w30, fb30, 320, BATCH, 160_000, f32, True),
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


#: The ops whose float input and initializer weight the QDQ rewrite
#: quantizes (ONNX Runtime quantize_static's defaults quantize these).
QDQ_OPS = ("Conv", "MatMul", "Gemm")


def qdq_activation_scales(model_bytes: bytes, signal, device="cpu") -> dict:
    """The uint8 (scale, zero point) of the float input of every Conv,
    MatMul and Gemm with an initializer weight, from one fp32 pass of
    ``signal`` ``[B, S]`` through the port: ONNX Runtime's MinMax
    calibration (the range widened to hold 0, scale = range / 255, zero
    point = round(-min / scale))."""
    import numpy as np
    import torch

    from birda_tpu_torch.onnx.lowering import OnnxFunction, _Evaluator
    from birda_tpu_torch.onnx.proto import load_model

    model = load_model(model_bytes)
    g = model.graph
    targets = {n.inputs[0] for n in g.nodes if n.op_type in QDQ_OPS
               and len(n.inputs) > 1 and n.inputs[1] in g.initializers}
    ranges = {}

    class Ranges(_Evaluator):
        def _store(self, name, val):
            if name in targets:
                ranges[name] = (float(val.min()), float(val.max()))
            return val

    fn = OnnxFunction(model, evaluator=Ranges(g, opset=model.opset))
    params = {k: torch.from_numpy(np.array(v)).to(device)
              for k, v in fn.params.items()}
    with torch.inference_mode():
        fn(torch.as_tensor(signal, dtype=torch.float32).to(device),
           params=params)
    scales = {}
    for name, (lo, hi) in ranges.items():
        lo, hi = min(lo, 0.0), max(hi, 0.0)
        scale = np.float32((hi - lo) / 255.0 or 1.0)
        scales[name] = (scale, np.uint8(np.clip(np.round(-lo / scale), 0,
                                                255)))
    return scales


def qdq_graph(model_bytes: bytes, act_scales: dict) -> bytes:
    """``model_bytes`` rewritten into the QDQ form that ONNX Runtime's
    ``quantize_static`` emits by default, the form of the registry's
    ``int8-arm`` variants:

    - the float input of every Conv, MatMul and Gemm with an initializer
      weight (named in ``act_scales``: name -> (float32 scale, uint8 zero
      point), from :func:`qdq_activation_scales`) goes through a uint8
      ``QuantizeLinear -> DequantizeLinear`` pair;
    - its weight becomes int8, symmetric per output channel (scale
      ``max|w| / 127``, values in [-127, 127], zero point 0) behind a
      ``DequantizeLinear`` on the output-channel axis;
    - its bias becomes int32 at scale ``x_scale * w_scale`` behind a
      ``DequantizeLinear``.

    A test fixture, not a feature of the package."""
    import numpy as np
    from torch_op_cases import encode_attribute

    from birda_tpu_torch.onnx import encode as E
    from birda_tpu_torch.onnx.proto import load_model

    model = load_model(model_bytes)
    g = model.graph
    arrays = {n: t.array for n, t in g.initializers.items()}
    inits, nodes, dq_of, dropped = {}, [], {}, set()

    def dequantized(name, q, scale, zp, axis=None):
        inits[f"{name}_quantized"] = q
        inits[f"{name}_scale"] = scale
        inits[f"{name}_zero_point"] = zp
        attrs = [] if axis is None else [E.attr_int("axis", axis)]
        nodes.append(E.node("DequantizeLinear", [
            f"{name}_quantized", f"{name}_scale", f"{name}_zero_point"],
            [f"{name}_dequantized"], name=f"{name}_DequantizeLinear",
            attrs=attrs))
        dropped.add(name)
        return f"{name}_dequantized"

    for node in g.nodes:
        ins = list(node.inputs)
        w = arrays.get(ins[1]) if node.op_type in QDQ_OPS \
            and len(ins) > 1 else None
        if w is not None and w.dtype == np.float32 and ins[0] in act_scales:
            x = ins[0]
            x_s, x_zp = act_scales[x]
            if x not in dq_of:
                inits[f"{x}_scale"] = np.asarray(x_s, np.float32)
                inits[f"{x}_zero_point"] = np.asarray(x_zp, np.uint8)
                qin = [x, f"{x}_scale", f"{x}_zero_point"]
                nodes.append(E.node("QuantizeLinear", qin, [f"{x}_quantized"],
                                    name=f"{x}_QuantizeLinear"))
                nodes.append(E.node(
                    "DequantizeLinear", [f"{x}_quantized"] + qin[1:],
                    [f"{x}_dequantized"], name=f"{x}_DequantizeLinear"))
                dq_of[x] = f"{x}_dequantized"
            axis = 1 if node.op_type != "Conv" and not (
                node.op_type == "Gemm" and node.attr("transB", 0)) else 0
            others = tuple(i for i in range(w.ndim) if i != axis)
            shape = [1] * w.ndim
            shape[axis] = -1
            w_s = (np.maximum(np.abs(w).max(axis=others), 1e-12)
                   / 127.0).astype(np.float32)
            w_q = np.clip(np.rint(w / w_s.reshape(shape)), -127, 127)
            ins[0] = dq_of[x]
            ins[1] = dequantized(ins[1], w_q.astype(np.int8), w_s,
                                 np.zeros(w_s.size, np.int8), axis)
            if len(ins) > 2 and ins[2] in arrays:
                b_s = (np.float32(x_s) * w_s).astype(np.float32)
                b_q = np.round(arrays[ins[2]] / b_s).astype(np.int32)
                ins[2] = dequantized(ins[2], b_q, b_s,
                                     np.zeros(b_s.size, np.int32), 0)
        nodes.append(E.node(node.op_type, ins, list(node.outputs),
                            name=node.name, domain=node.domain,
                            attrs=[encode_attribute(k, a)
                                   for k, a in node.attrs.items()]))
    kept = {n: a for n, a in arrays.items() if n not in dropped}
    return E.model(
        nodes,
        inputs=[E.value_info(vi.name, [d if d is not None else "batch"
                                       for d in vi.shape], vi.elem_type)
                for vi in g.inputs if vi.name not in g.initializers],
        outputs=[E.value_info(vi.name, [d if d is not None else "batch"
                                        for d in vi.shape], vi.elem_type)
                 for vi in g.outputs],
        initializers=[E.tensor(n, a) for n, a in {**kept, **inits}.items()],
        opset=model.opset, graph_name=f"{g.name}-qdq")


def ops_breadth_phase(dev):
    """Every case of the op table (``tests/torch_op_cases.py``: every
    family of the evaluator's 178 handlers, bf16 variants included) through
    the port on the card against its CPU run: integer, bool, shape, index
    and quantized outputs bit for bit, floats within the case family's
    bound. A device value the card run returns must be on the card (no
    handler falls back to the CPU), and each refusal case is refused on the
    card as in the table. Every case that runs then makes a second call
    with no host sync (:func:`case_sync`). Beside them, the recurrences'
    kernels per time step."""
    import torch
    import torch_op_cases as oc

    from birda_tpu_torch.onnx.proto import load_model

    t0 = time.perf_counter()
    failed, ops, runs = [], set(), 0
    for c in oc.all_cases():
        ops.update(n.op_type for n in load_model(c.model).graph.nodes)
        if c.refused:
            runs += 1
            why = refusal_on_card(c, dev)
            if why is not None:
                failed.append(f"{c.id}: {why}")
            continue
        for bf16 in ((False, True) if c.bf16 else (False,)):
            model, feeds = oc.bf16_model(c) if bf16 else (c.model, c.feeds)
            card, _ = oc.run_port(model, feeds, bf16, dev)
            host, _ = oc.run_port(model, feeds, bf16, "cpu")
            runs += 1
            for i, (g, w) in enumerate(zip(card, host)):
                why = oc.mismatch(g, w, c.family, bf16)
                if why is None and isinstance(g, torch.Tensor) \
                        and g.device.type != "cuda":
                    why = f"on {g.device}"
                if why is not None:
                    failed.append(f"{c.id}{'-bf16' if bf16 else ''}"
                                  f"[{i}]: {why}")
    torch.cuda.synchronize()
    synced, sync_runs = [], 0
    for c in oc.all_cases():
        if c.refused:
            continue
        for bf16 in ((False, True) if c.bf16 else (False,)):
            model, feeds = oc.bf16_model(c) if bf16 else (c.model, c.feeds)
            sync_runs += 1
            why = case_sync(model, feeds, bf16, dev)
            if why is not None:
                synced.append(f"{c.id}{'-bf16' if bf16 else ''}: {why}")
    emit({"phase": "ops_breadth", "cases": runs, "op_types": len(ops),
          "failed": failed[:20], "n_failed": len(failed),
          "sync_checked": sync_runs, "synced": synced[:20],
          "n_synced": len(synced),
          "recurrent_launches": recurrent_launches(dev),
          "seconds": time.perf_counter() - t0})
    check(not failed, f"ops_breadth: {len(failed)} cases differ: "
          f"{failed[:5]}")
    check(not synced, f"ops_breadth: {len(synced)} cases sync the card: "
          f"{synced[:5]}")


def case_sync(model, feeds, bf16, dev):
    """A case graph's second call on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, after a warm call that
    copies its constants once: None when no handler syncs the card (a host
    value read back, or a fresh host array copied to the card), else the
    error."""
    import numpy as np
    import torch

    from birda_tpu_torch.onnx import lowering as tl
    from birda_tpu_torch.onnx.proto import load_model

    fn = tl.OnnxFunction(load_model(model),
                         compute_dtype=torch.bfloat16 if bf16 else None)
    params = {k: torch.from_numpy(np.array(v)).to(dev)
              for k, v in fn.params.items()}
    args = [torch.from_numpy(np.array(f)).to(dev) for f in feeds]
    with torch.inference_mode():
        fn(*args, params=params)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*args, params=params)
        except RuntimeError as e:
            return str(e)[:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return None


def qlinear_ops_phase(cases, int8_results, dev):
    """QLinearConv and ConvInteger at the widest 1x1, Perch's deepest dense
    3x3 and the largest 3x3 depthwise conv, and QLinearMatMul,
    MatMulInteger and QGemm at the head Gemm [32,1280]x[1280,1024], on the
    card: uint8 activations with nonzero zero points, int8 weights holding
    -128 (per-channel scales and zero points), each conv's padding. The
    integer products bit for bit against the port's CPU run (float64
    products there, float64 on the card too: the wide-integer route); QGemm
    (a float product of dequantized values, as the JAX evaluator computes
    it) within 1e-5 of its largest magnitude. Each timed beside the int8_ops
    route and the bf16 call of the same shape."""
    import numpy as np
    import torch

    import torch_op_cases as oc
    from birda_tpu_torch.onnx import encode as E
    from birda_tpu_torch.onnx.lowering import lower

    rng = np.random.default_rng(SEED)

    def one_node(op, ins, feeds, inits, attrs=(), domain=""):
        return oc.graph(op, ins, feeds, inits, attrs, opset=13,
                        domain=domain)[0]

    def run(name, op, mb, x, exact, extra):
        card, _ = oc.run_port(mb, [x], device=dev)
        host, _ = oc.run_port(mb, [x], device="cpu")
        g, w = oc.to_numpy(card[0]), oc.to_numpy(host[0])
        if exact:
            ok = bool(np.array_equal(g, w))
        else:
            ok = float(np.abs(g - w).max()) <= 1e-5 * float(np.abs(w).max())
        fn = lower(mb)
        fn.params = {k: torch.from_numpy(np.array(v)).to(dev)
                     for k, v in fn.params.items()}
        xd = torch.from_numpy(x).to(dev)
        base = int8_results.get(name, {})
        rec = {"phase": "qlinear_ops", "case": name, "op": op,
               "bit_exact" if exact else "within_1e-5": ok,
               "out_dtype": str(g.dtype), **extra,
               "ms": timed_ms(lambda: fn(xd)),
               "int8_ops_route": base.get("route"),
               "int8_ops_ms": base.get("ms"), "bf16_ms": base.get("bf16_ms")}
        emit(rec)
        check(ok, f"qlinear_ops {name} {op}: card against CPU")
        return rec

    def uint8(shape):
        return rng.integers(0, 256, shape).astype(np.uint8)

    def int8(shape):
        v = rng.integers(-128, 128, shape).astype(np.int8)
        v.reshape(-1)[0] = -128
        return v

    results = []
    for name in ("widest_1x1", "perch_deepest_dense_3x3", "depthwise_3x3"):
        if name not in cases:
            continue
        xs, ws, strides, pads, dil, group = cases[name]
        x, w = uint8(xs), int8(ws)
        c_out = ws[0]
        attrs = [E.attr_ints("kernel_shape", list(ws[2:])),
                 E.attr_ints("strides", list(strides)),
                 E.attr_ints("dilations", list(dil)),
                 E.attr_ints("pads", [p[0] for p in pads]
                             + [p[1] for p in pads]),
                 E.attr_int("group", group)]
        w_zp = rng.integers(-3, 4, c_out).astype(np.int8)
        extra = {"x": list(xs), "w": list(ws), "group": group,
                 "pads": [list(p) for p in pads]}
        qconv = one_node(
            "QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz",
                            "b"], {"x": x},
            {"xs": np.float32(0.02), "xz": np.uint8(131), "w": w,
             "ws": rng.uniform(0.002, 0.02, c_out).astype(np.float32),
             "wz": w_zp, "ys": np.float32(0.5), "yz": np.uint8(120),
             "b": rng.integers(-5000, 5000, c_out).astype(np.int32)}, attrs)
        results.append(run(name, "QLinearConv", qconv, x, True, extra))
        cint = one_node("ConvInteger", ["x", "w", "xz", "wz"], {"x": x},
                         {"w": w, "xz": np.uint8(131), "wz": w_zp}, attrs)
        results.append(run(name, "ConvInteger", cint, x, True, extra))
    a, b = uint8((BATCH, 1280)), int8((1280, 1024))
    extra = {"a": [BATCH, 1280], "b": [1280, 1024]}
    b_zp = rng.integers(-3, 4, 1024).astype(np.int8)
    qmm = one_node("QLinearMatMul",
                    ["a", "as", "az", "b", "bs", "bz", "ys", "yz"], {"a": a},
                    {"as": np.float32(0.02), "az": np.uint8(128), "b": b,
                     "bs": np.float32(0.01), "bz": np.int8(0),
                     "ys": np.float32(2.0), "yz": np.uint8(128)})
    results.append(run("gemm_head", "QLinearMatMul", qmm, a, True, extra))
    mmi = one_node("MatMulInteger", ["a", "b", "az", "bz"], {"a": a},
                    {"b": b, "az": np.uint8(128), "bz": b_zp})
    results.append(run("gemm_head", "MatMulInteger", mmi, a, True, extra))
    qgemm = one_node(
        "QGemm", ["a", "as", "az", "b", "bs", "bz", "c"], {"a": a},
        {"as": np.float32(0.02), "az": np.uint8(128), "b": b,
         "bs": rng.uniform(0.002, 0.02, 1024).astype(np.float32),
         "bz": np.zeros(1024, np.int8),
         "c": rng.integers(-5000, 5000, 1024).astype(np.int32)},
        domain="com.microsoft")
    results.append(run("gemm_head", "QGemm", qgemm, a, False, extra))
    return results


def refusal_on_card(c, dev):
    """None when the port refuses the refusal case ``c`` on the card as
    the case table says (``lower`` with ``OnnxGraphUnsupported``, or the
    call with ``UnsupportedOnnxOp``), else why not."""
    import torch_op_cases as oc

    from birda_tpu_torch.errors import OnnxGraphUnsupported
    from birda_tpu_torch.onnx.lowering import UnsupportedOnnxOp

    want = OnnxGraphUnsupported if c.refused == "preflight" \
        else UnsupportedOnnxOp
    try:
        oc.run_port(c.model, c.feeds, False, dev)
    except want:
        return None
    except Exception as e:  # noqa: BLE001 - reported as the case's failure
        return f"{type(e).__name__} instead of {want.__name__}: {e}"[:200]
    return f"ran instead of raising {want.__name__}"


def recurrent_launches(dev):
    """Kernel launches per time step of the unrolled recurrences: the case
    table's RNN, GRU and LSTM graphs (5 steps, batch 2, hidden 3) on the
    card, one profiled call after a warm one, over the steps and directions
    run: the runtime's launch calls on the host (``launches``) beside the
    kernels the device trace shows (``kernels``)."""
    import torch
    import torch_op_cases as oc
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from birda_tpu_torch.onnx.lowering import lower

    cases = {c.id: c for c in oc.recurrent_cases()}
    out = {}
    for cid, dirs in (("rnn-forward", 1), ("gru-forward", 1),
                      ("lstm-forward", 1), ("lstm-bidirectional", 2)):
        c = cases[cid]
        fn = lower(c.model)
        x = torch.from_numpy(c.feeds[0]).to(dev)
        fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
        events = prof.events()
        kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA)
        launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                       and "LaunchKernel" in e.name)
        steps = c.feeds[0].shape[0] * dirs
        out[cid] = {"launches": launches, "kernels": kernels, "steps": steps,
                    "launches_per_step": launches / steps}
    return out


def sync_check(model, rows, dev):
    """One step of ``model`` on ``rows`` (``[B, S]`` float32) on the card
    under ``torch.cuda.set_sync_debug_mode("error")``, after a warm step
    that carries the params to the card and copies the host folds once:
    None when no handler reads a device value on the host, else the error
    and the port's frames it came from."""
    import traceback

    import numpy as np
    import torch

    x = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    sync = None
    with torch.inference_mode():
        model.apply(x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.apply(x)
        except RuntimeError as e:
            frames = [f"{f.filename.split('birda_tpu_torch/')[-1]}:{f.lineno}"
                      f" {f.name}" for f in traceback.extract_tb(
                          e.__traceback__) if "birda_tpu_torch" in f.filename]
            sync = {"error": str(e)[:300], "where": frames[-3:]}
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return sync


def perch_qdq_phase(tmp: Path, onnx_perch, labels_path, labels, chunk,
                    fp32_float, dev):
    """Perch v2 in its ``int8-arm`` QDQ form (:func:`qdq_graph` of the
    full-scale graph, the activation scales from one fp32 pass of four
    segments on the card): ``analyze(device="auto", precision="bf16")`` over
    one 60 s recording at 32 kHz, which must launch ``conv1d_stft`` on the
    framer's weight that a DequantizeLinear makes on the card each step.
    Then one 32-row chunk on the card in bf16 against the port's fp32 CPU
    run of the same graph (relative to the top score, within
    ``SCORE_DRIFT_BOUND``), with its top-1 agreement with the float graph's
    fp32 scores; one step of the lowered graph under
    ``torch.cuda.set_sync_debug_mode("error")`` (no handler reads a device
    value on the host); and the steady step (``step_perch_qdq``). Returns
    the launch counts."""
    import numpy as np
    import torch

    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.contracts import ModelFamily, contract_for
    from birda_tpu_torch.models.zoo import onnx_model

    contract = contract_for(ModelFamily.PERCH_V2)
    n, seg = contract.num_classes, contract.sample_count
    t0 = time.perf_counter()
    calib = chunk[:4 * seg].reshape(4, seg)
    data = Path(onnx_perch).read_bytes()
    scales = qdq_activation_scales(data, calib, device=dev)
    qdq = qdq_graph(data, scales)
    path = tmp / "perch_v2_int8_arm.onnx"
    path.write_bytes(qdq)
    emit({"phase": "fixture", "graph": "perch_v2_int8_arm (QDQ)",
          "quantized_inputs": len(scales), "onnx_bytes": len(qdq),
          "float_onnx_bytes": len(data),
          "seconds": time.perf_counter() - t0})
    wav = tmp / "perch_qdq_32k.wav"
    write_wav(wav, recording(32_000, 60.0, SEED + 60), 32_000)
    launches, _ = main_path(
        "main_path_perch_qdq", "conv1d_stft", [wav], path, labels_path,
        "perch-v2", device="auto", min_confidence=PERCH_MIN_CONFIDENCE,
        top_k=PERCH_TOP_K)

    scores, seconds = {}, {}
    for name, dtype, where in (("card_bf16", torch.bfloat16, "cuda"),
                               ("cpu_fp32", None, "cpu")):
        clf = BirdClassifier(onnx_model(path, contract, labels, dtype=dtype),
                             device=where, min_confidence=0.0, top_k=n)
        t = time.perf_counter()
        scores[name] = full_scores(
            clf.chunk_runner(BATCH, seg).predict_chunk(chunk, BATCH), n)
        seconds[name] = time.perf_counter() - t
        del clf
    top = float(scores["cpu_fp32"].max())
    drift = float(np.abs(scores["card_bf16"] - scores["cpu_fp32"]).max())

    model = onnx_model(path, contract, labels, dtype=torch.bfloat16)
    sync = sync_check(model, chunk[:BATCH * seg].reshape(BATCH, seg), dev)
    emit({"phase": "perch_qdq_chunk", "rows": BATCH, "classes": n,
          "max_score_drift": drift, "max_fp32_score": top,
          "drift_over_max_score": drift / top, "bound": SCORE_DRIFT_BOUND,
          "card_vs_cpu": agreement(scores["card_bf16"], scores["cpu_fp32"]),
          "top1_agreement_with_float_graph": agreement(
              scores["card_bf16"], fp32_float)["top1_agreement"],
          "cpu_fp32_top1_agreement_with_float_graph": agreement(
              scores["cpu_fp32"], fp32_float)["top1_agreement"],
          "first_chunk_s": seconds, "sync_check": sync or "no sync"})
    check(np.isfinite(drift) and drift / top <= SCORE_DRIFT_BOUND,
          f"perch_qdq_chunk: drift {drift / top}")
    check(sync is None, f"perch_qdq_chunk: a host sync in the step: {sync}")
    steady_step("step_perch_qdq", BirdClassifier(
        model, device="cuda", min_confidence=0.0, top_k=5), chunk)
    return launches


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
              precision="bf16", device="gpu", **kw):
    """``analyze`` at ``precision`` and batch 32 on the card (``device``
    ``gpu`` or ``auto``), with the launch counts set to 0 just before and
    read just after; checks the run went through ``kernel`` (``None``: a
    path on which no hand kernel lies, so none may launch) and produced
    finite confidences in [0, 1] for every file. Returns the launch counts
    and the result."""
    import numpy as np
    import torch

    from birda_tpu_torch.api import analyze
    from birda_tpu_torch.ops import stft_conv
    from birda_tpu_torch.orchestrator import compute_dtype_for

    torch.cuda.reset_peak_memory_stats()
    stft_conv.LAUNCHES.clear()
    t0 = time.perf_counter()
    result = analyze(wavs, model_path=onnx_path, labels_path=labels_path,
                     model_type=model_type, device=device,
                     precision=precision, batch_size=BATCH, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(stft_conv.LAUNCHES)
    summary = result.summary or {}
    actual = (result.backend or {}).get("actual")
    rec = {"phase": phase, "precision": result.precision,
           "compute_dtype": str(compute_dtype_for(precision, actual)),
           "backend": result.backend,
           "exit_code": result.exit_code, "launches": launches,
           "files": [{"file": f.path.name, "detections": len(f.detections),
                      "error": f.error} for f in result.files],
           "segments": summary.get("total_segments"),
           "detections": len(result.detections),
           "pipeline_ms": summary.get("duration_ms"),
           "wall_s_with_load": wall,
           "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}
    if summary.get("duration_ms"):
        rec["segments_per_s"] = (summary["total_segments"]
                                 / (summary["duration_ms"] / 1000))
        rec["realtime_factor"] = summary["realtime_factor"]
    emit(rec)
    check(result.exit_code == 0, f"{phase}: analyze exit code")
    check(actual == "cuda", f"{phase}: backend {result.backend}")
    check(rec["compute_dtype"] == ("None" if precision == "fp32"
                                   else "torch.bfloat16"),
          f"{phase}: compute dtype {rec['compute_dtype']} on the card")
    if kernel is None:
        check(not any(launches.values()),
              f"{phase}: a hand kernel launched on a path without one: "
              f"{launches}")
    else:
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
        scores[precision] = full_scores(
            clf.chunk_runner(BATCH, seg).predict_chunk(chunk, BATCH), n)
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
                      relative: bool, precision: str, step_phase: str,
                      held: bool = True):
    """The same 32-row chunk through the ``precision`` (int8 or mixed)
    route, with the scales the main path cached; its drift against the fp32
    scores, absolute or relative to the largest fp32 score, within
    ``SCORE_DRIFT_BOUND`` (``held=False``: printed, not asserted), and
    ``compare_scores``'s report. The route is then timed and profiled on
    that chunk (``step_phase``). Returns the drift and the top-1
    agreement."""
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
    got = full_scores(clf.chunk_runner(BATCH, contract.sample_count)
                      .predict_chunk(chunk, BATCH), n)
    drift = float(np.abs(got - fp32).max())
    top = float(fp32.max())
    measured = drift / top if relative else drift
    rep = compare_scores(fp32, got)
    emit({"phase": phase, "precision": model.precision_info, "rows": BATCH,
          "classes": n, "load_s": load_s, "max_score_drift": drift,
          "max_fp32_score": top,
          "drift_over_max_score" if relative else "drift": measured,
          "bound": SCORE_DRIFT_BOUND, "bound_held": held,
          "compare_scores": {
              "max_abs_delta": rep.max_abs_delta,
              "mean_abs_delta": rep.mean_abs_delta,
              "top1_agreement": rep.top1_agreement,
              "top5_jaccard": rep.top5_jaccard,
              "crossings": [[x.threshold, x.both, x.fp32_only, x.int8_only]
                            for x in rep.crossings],
              "worst_species": rep.worst_species[:3]},
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    check(np.isfinite(measured) and (not held
                                     or measured <= SCORE_DRIFT_BOUND),
          f"{phase}: {precision} score drift {measured}")
    del clf
    steady_step(step_phase, BirdClassifier(
        model, device="cuda", min_confidence=0.0, top_k=5), chunk)
    return {"drift": measured, "top1_agreement": rep.top1_agreement}


def steady_step(phase, clf, chunk):
    """The bf16 chunk step on a warm runner: host-clock time per step over
    ``STEP_ITERS`` steps, then a ``torch.profiler`` window of
    ``PROFILE_STEPS`` steps (``measure.profile_steps``) for the device's
    busy time, the launches per step and the kernels that take the most
    device time."""
    import torch

    runner = clf.chunk_runner(BATCH, clf.sample_count)
    for _ in range(2):
        runner.predict_chunk(chunk, BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEP_ITERS):
        runner.predict_chunk(chunk, BATCH)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEP_ITERS * 1e3
    prof = profile_steps(lambda: runner.predict_chunk(chunk, BATCH),
                         PROFILE_STEPS)
    busy_ms = prof["device_busy_ms_per_step"]
    emit({"phase": phase, "batch": BATCH, "chunk_step_ms": step_ms,
          "segments_per_s": BATCH / step_ms * 1e3,
          "device_busy_ms_per_step": busy_ms,
          "device_idle_share": idle_share(busy_ms, step_ms),
          "kernels_per_step": prof["kernels_per_step"],
          "top_kernels_ms_per_step": prof["top_kernels_ms_per_step"]})


def read_wav(path: Path):
    import numpy as np

    with wave.open(str(path)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return pcm.astype(np.float32) / 32767.0


def bat_phase(tmp: Path, onnx24, labels24_path, labels24):
    """``analyze(bat="uk", device="auto")`` on full-scale v2.4 in bf16 over
    one 60 s recording at 256 kHz, with a Gemm + Sigmoid head [B,1024] ->
    38 (weights from ``SEED``) under ``models_dir()/bat``: every detection
    is a head label and the windows step by 0.5625 · 0.75 s. Then one
    32-window chunk through the classifier with embeddings: the head's
    card scores over the returned embeddings against a float64 head on the
    host, within ``HEAD_BOUND``. Returns the launch counts."""
    import numpy as np
    import torch

    from birda_tpu_torch import constants
    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.contracts import ModelFamily, contract_for
    from birda_tpu_torch.models.custom import CustomClassifier
    from birda_tpu_torch.models.zoo import onnx_model
    from birda_tpu_torch.onnx.encode import model, node, tensor, value_info
    from birda_tpu_torch.registry.installer import models_dir

    rng = np.random.default_rng(SEED)
    w = rng.normal(0, 0.05, (1024, BAT_CLASSES)).astype(np.float32)
    b = rng.normal(0, 0.5, BAT_CLASSES).astype(np.float32)
    head_labels = [f"Batus sp{i:02d}_Bat {i:02d}" for i in range(BAT_CLASSES)]
    bat_dir = models_dir() / "bat"
    bat_dir.mkdir(parents=True, exist_ok=True)
    head_path = bat_dir / "BattyBirdNET-UK-256kHz_fp32.onnx"
    head_path.write_bytes(model(
        [node("Gemm", ["input", "W", "B"], ["logits"]),
         node("Sigmoid", ["logits"], ["probabilities"])],
        inputs=[value_info("input", ["batch", 1024])],
        outputs=[value_info("probabilities", ["batch", BAT_CLASSES])],
        initializers=[tensor("W", w), tensor("B", b)]))
    head_labels_path = bat_dir / "BattyBirdNET-UK-256kHz_Labels.txt"
    head_labels_path.write_text("".join(f"{x}\n" for x in head_labels))

    rate = constants.bat.SAMPLE_RATE
    wav = tmp / "bats_256k.wav"
    write_wav(wav, recording(rate, 60.0, SEED + 20), rate)
    launches, result = main_path("main_path_bat", "fused_logmel", [wav],
                                 onnx24, labels24_path, "birdnet-v24",
                                 device="auto", bat="uk")
    check(all(f"{d.scientific_name}_{d.common_name}" in head_labels
              for d in result.detections),
          "main_path_bat: a detection that is not a head label")
    step = constants.bat.SEGMENT_DURATION - constants.bat.OVERLAP
    starts = sorted({d.start_time for d in result.detections})
    on_grid = [abs(t / step - round(t / step)) < 1e-9 for t in starts[:-1]]
    check(len(starts) > 2 and starts[0] == 0.0 and all(on_grid),
          f"main_path_bat: window starts {starts[:4]} off the "
          f"{step} s grid")

    seg = constants.bat.CHUNK_SAMPLES
    hop = seg - int(round(constants.bat.OVERLAP * rate))
    chunk = read_wav(wav)[:(BATCH - 1) * hop + seg]
    contract = contract_for(ModelFamily.BIRDNET_V24)
    clf = BirdClassifier(onnx_model(onnx24, contract, labels24,
                                    dtype=torch.bfloat16),
                         device="auto", min_confidence=0.0, top_k=5,
                         want_embeddings=True)
    rows = clf.chunk_runner(BATCH, hop).predict_chunk(chunk, BATCH)
    emb = np.stack([r.embeddings for r in rows])
    head = CustomClassifier.from_onnx(head_path, head_labels_path,
                                      device="auto")
    got = head.scores(emb).cpu().numpy()
    want = 1 / (1 + np.exp(-(emb.astype(np.float64) @ w.astype(np.float64)
                             + b)))
    err = float(np.abs(got - want).max())
    emit({"phase": "bat_head_chunk", "windows": BATCH,
          "embeddings": list(emb.shape), "head_device": str(head.device),
          "max_abs_err": err, "bound": HEAD_BOUND,
          "window_step_s": step, "distinct_starts": len(starts)})
    check(emb.shape == (BATCH, 1024) and bool(np.isfinite(emb).all()),
          f"bat_head_chunk: embeddings {emb.shape}")
    check(err <= HEAD_BOUND, f"bat_head_chunk: head error {err}")
    return launches


def fixture_geomodel(tmp: Path, labels24):
    """The fixture geomodel at the real 12,012 species (weights from
    ``SEED``): the classifier's first 6,000 labels and 6,012 others.
    Returns (graph path, labels path, labels, W, B)."""
    from birda_tpu_torch.onnx.encode import make_fixture_geomodel
    from birda_tpu_torch.onnx.proto import load_model

    data = make_fixture_geomodel(num_species=GEO_SPECIES, seed=SEED)
    geo = tmp / "geomodel.onnx"
    geo.write_bytes(data)
    labels = labels24[:6000] + [f"Geo only{i:05d}_Geo bird {i:05d}"
                                for i in range(GEO_SPECIES - 6000)]
    labels_path = tmp / "geomodel-labels.txt"
    labels_path.write_text("".join(f"{x}\n" for x in labels))
    inits = load_model(data).graph.initializers
    return geo, labels_path, labels, inits["W"].array, inits["B"].array


def geomodel_scores(w, b):
    """The fixture geomodel at ``GEO_QUERY`` in float64 on the host."""
    import numpy as np

    x = np.asarray(GEO_QUERY, np.float64)
    return 1 / (1 + np.exp(-(x @ w.astype(np.float64) + b)))


def range_phase(tmp: Path, onnx24, labels24_path, labels24, geo):
    """``analyze`` on full-scale v2.4 in bf16 with lat/lon/week,
    ``range_threshold=0.03`` and ``range_unmatched="drop"`` over one 60 s
    recording at 48 kHz: every detection is a species that a float64 Gemm +
    sigmoid of the fixture's weights puts in range. Returns the launch
    counts."""
    from birda_tpu_torch.config.types import Config

    geo_path, geo_labels_path, geo_labels, w, b = geo
    cfg = Config()
    cfg.defaults.geomodel = geo_path
    cfg.defaults.geomodel_labels = geo_labels_path
    wav = tmp / "range_48k.wav"
    write_wav(wav, recording(48_000, 60.0, SEED + 30), 48_000)
    lat, lon, week = GEO_QUERY
    launches, result = main_path(
        "main_path_range", "fused_logmel", [wav], onnx24, labels24_path,
        "birdnet-v24", lat=lat, lon=lon, week=week, range_threshold=0.03,
        range_unmatched="drop", config=cfg)
    scores = geomodel_scores(w, b)
    index = {label: i for i, label in enumerate(geo_labels)}
    where = [index.get(f"{d.scientific_name}_{d.common_name}")
             for d in result.detections]
    check(all(i is not None and scores[i] >= 0.03 - GEO_BOUND
              for i in where),
          "main_path_range: a detection out of range or unmatched")
    info = result.range_filter or {}
    mapped = scores[:6000]
    emit({"phase": "range_filter_info", **info,
          "species_in_range_host": int((mapped >= 0.03).sum()),
          "near_threshold_host": int((abs(mapped - 0.03) <= GEO_BOUND).sum()),
          "detected_species": len({i for i in where})})
    check(info.get("total_species") == len(labels24)
          and info.get("mapped_species") == 6000
          and info.get("unmatched_policy") == "drop",
          f"range_filter_info: {info}")
    check(abs(info["species_in_range"] - int((mapped >= 0.03).sum()))
          <= int((abs(mapped - 0.03) <= GEO_BOUND).sum()),
          "range_filter_info: species in range differ from the host's")
    return launches


def region_phase(phase, kernel, tmp: Path, family, onnx_path, labels_path,
                 labels, rate, softmax, dev, **kw):
    """``analyze`` with a regional label file that keeps every 8th label,
    over one 60 s recording at the model's rate; every detection is a
    regional label and, as in the JAX package, no precision is reported.
    Then one 32-window chunk through the regional view in bf16: its scores
    against the same forward pass's full scores gathered (sigmoid: bit for
    bit) or gathered and renormalized in float64 on the host (softmax:
    within ``REGION_REL_BOUND`` of the largest). Returns the launch
    counts."""
    import numpy as np
    import torch

    from birda_tpu_torch.models.contracts import contract_for
    from birda_tpu_torch.models.regional import slice_to_region
    from birda_tpu_torch.models.zoo import onnx_model

    region = labels[::8]
    region_path = tmp / f"{family}-every-8th.txt"
    region_path.write_text("".join(f"{x}\n" for x in region))
    wav = tmp / f"{family}-region.wav"
    write_wav(wav, recording(rate, 60.0, SEED + 40), rate)
    launches, result = main_path(phase, kernel, [wav], onnx_path,
                                 labels_path, family, precision="bf16",
                                 region_labels=region_path, **kw)
    kept = set(region)
    check(all(f"{d.scientific_name}_{d.common_name}" in kept
              for d in result.detections),
          f"{phase}: a detection outside the region")
    check(result.precision is None, f"{phase}: precision {result.precision}")

    contract = contract_for(family)
    seg = contract.sample_count
    pcm = torch.from_numpy(read_wav(wav))
    x = pcm.unfold(0, seg, (len(pcm) - seg) // (BATCH - 1))[:BATCH]
    model = onnx_model(onnx_path, contract, labels, dtype=torch.bfloat16)
    model.bind_device(dev)
    full = {}
    base = model.apply
    model.apply = lambda wave: full.setdefault("out", base(wave))
    view = slice_to_region(model, region, region="every-8th")
    with torch.inference_mode():
        out = view.apply(x.to(dev))
        got = out["scores"].cpu().numpy()
        scores = full["out"]["scores"].cpu().numpy()
        emb_same = bool(torch.equal(out["embeddings"],
                                    full["out"]["embeddings"]))
    gathered = scores[:, ::8]
    rec = {"phase": f"{phase}_chunk", "rows": BATCH,
           "classes": len(region), "of": len(labels), "softmax": softmax,
           "embeddings_pass_through": emb_same}
    if softmax:
        want = gathered.astype(np.float64)
        want = want / want.sum(-1, keepdims=True)
        rec["max_err_over_top"] = float(np.abs(got - want).max()
                                        / want.max())
        rec["bound"] = REGION_REL_BOUND
        rec["row_sums"] = [float(got.sum(-1).min()), float(got.sum(-1).max())]
        ok = rec["max_err_over_top"] <= REGION_REL_BOUND
    else:
        rec["bit_exact"] = ok = bool(np.array_equal(got, gathered))
    emit(rec)
    check(ok and emb_same and got.shape == (BATCH, len(region)),
          f"{phase}_chunk: {rec}")
    return launches


def species_phase(geo):
    """``api.species`` on the card (``device="auto"``) against a float64
    evaluation of the fixture geomodel on the host: the same species, each
    score within ``GEO_BOUND``, sorted as the command sorts (score
    descending, then name) and in the host's order wherever the host's
    neighbouring scores differ by more than twice the bound."""
    import numpy as np

    from birda_tpu_torch.api import species

    geo_path, geo_labels_path, geo_labels, w, b = geo
    lat, lon, week = GEO_QUERY
    t0 = time.perf_counter()
    got = species(lat, lon, week=week, threshold=0.03,
                  geomodel_path=geo_path,
                  geomodel_labels_path=geo_labels_path, device="auto")
    seconds = time.perf_counter() - t0
    scores = geomodel_scores(w, b)
    host = sorted(((lab, float(s)) for lab, s in zip(geo_labels, scores)
                   if s >= 0.03), key=lambda e: (-e[1], e[0].lower()))
    near = {lab for lab, s in zip(geo_labels, scores)
            if abs(s - 0.03) <= GEO_BOUND}
    card = [(e.label, e.score) for e in got]
    host_score = dict(zip(geo_labels, scores))
    same_set = ({lab for lab, _ in card} - near) == \
        ({lab for lab, _ in host} - near)
    err = max(abs(s - host_score[lab]) for lab, s in card)
    sorted_ok = card == sorted(card, key=lambda e: (-e[1], e[0].lower()))
    firm = [i for i in range(min(len(card), len(host)))
            if all(abs(host[i][1] - host[j][1]) > 2 * GEO_BOUND
                   for j in (i - 1, i + 1) if 0 <= j < len(host))]
    order_ok = all(card[i][0] == host[i][0] for i in firm)
    emit({"phase": "species", "entries": len(card),
          "host_entries": len(host), "max_abs_err": err, "bound": GEO_BOUND,
          "same_species": same_set, "sorted": sorted_ok,
          "positions_held_to_host_order": len(firm),
          "in_host_order": order_ok, "seconds": seconds})
    check(card and same_set and sorted_ok and order_ok and err <= GEO_BOUND,
          "species: the card's list differs from the host's")


def full_scores(rows, n):
    """A chunk's results as a ``[rows, n]`` score matrix (zeros where a
    class was not returned)."""
    import numpy as np

    out = np.zeros((len(rows), n), np.float64)
    for r, res in enumerate(rows):
        for p in res.predictions:
            out[r, p.index] = p.confidence
    return out


def agreement(got, want) -> dict:
    """Largest score error, and the top-1 and top-5 agreement of two
    ``[rows, n]`` score matrices."""
    import numpy as np

    top5 = [len(set(np.argsort(-g)[:5]) & set(np.argsort(-w)[:5])) / 5
            for g, w in zip(got, want)]
    return {"max_abs_err": float(np.abs(got - want).max()),
            "top1_agreement": float(np.mean(got.argmax(1) == want.argmax(1))),
            "top5_agreement": float(np.mean(top5))}


def native_phase(wavs):
    """``analyze`` on ``synthetic:full`` BirdNET v2.4, the native backbone
    in fp32 with weights synthesized from the seed, on the card over the
    v2.4 recordings. Neither hand kernel lies on this path: both must have
    launched 0 times. Then one 32-row chunk on the card against the port's
    CPU run of the same chunk (fp32 on both), within
    ``SCORE_DRIFT_BOUND``, and the steady step on the card
    (``step_native``). Returns the launch counts."""
    import torch

    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.contracts import ModelFamily
    from birda_tpu_torch.models.zoo import native_model

    launches, result = main_path("main_path_native", None, wavs,
                                 "synthetic:full", "synthetic:full",
                                 "birdnet-v24", precision="fp32")
    check(result.precision is None, f"main_path_native: precision "
          f"{result.precision}")
    model = native_model(ModelFamily.BIRDNET_V24)
    n, seg = model.num_classes, model.config.sample_count
    chunk = read_wav(wavs[0])[:BATCH * seg]
    scores, seconds = {}, {}
    for where in ("cuda", "cpu"):
        clf = BirdClassifier(model, device=where, min_confidence=0.0,
                             top_k=n)
        runner = clf.chunk_runner(BATCH, seg)
        check(runner._mel_cfg is not None,
              "main_path_native: the chunk runner is off the mel path")
        t0 = time.perf_counter()
        scores[where] = full_scores(runner.predict_chunk(chunk, BATCH), n)
        seconds[where] = time.perf_counter() - t0
    rec = {"phase": "native_vs_cpu", "rows": BATCH, "classes": n,
           **agreement(scores["cuda"], scores["cpu"]),
           "bound": SCORE_DRIFT_BOUND,
           "max_score": float(scores["cpu"].max()),
           "first_chunk_s": seconds}
    emit(rec)
    check(rec["max_abs_err"] <= SCORE_DRIFT_BOUND,
          f"native_vs_cpu: card against CPU {rec['max_abs_err']}")
    steady_step("step_native", BirdClassifier(
        model, device="cuda", min_confidence=0.0, top_k=5), chunk)
    del model
    torch.cuda.empty_cache()
    return launches


def jobs_phase(wavs, onnx24, labels24_path, sequential, seq_launches):
    """``analyze`` in bf16 with ``jobs=2`` over the v2.4 recordings: the
    same detections as the sequential ``main_path`` run and the same
    ``fused_logmel`` launches. Its pipeline timer stands beside that of a
    sequential run made just before it (the first ``main_path`` run of the
    process also pays the card's first-use costs); both are the host
    clock. Returns the launch counts."""
    _, warm = main_path("main_path_sequential_warm", "fused_logmel", wavs,
                        onnx24, labels24_path, "birdnet-v24")
    launches, result = main_path("main_path_jobs", "fused_logmel", wavs,
                                 onnx24, labels24_path, "birdnet-v24",
                                 jobs=2)

    def by_file(res):
        return {f.path.name: [(d.start_time, d.end_time, d.scientific_name,
                               d.confidence) for d in f.detections]
                for f in res.files}

    got, want = by_file(result), by_file(sequential)
    same_rows = got.keys() == want.keys() and all(
        [r[:3] for r in got[k]] == [r[:3] for r in want[k]] for k in want)
    diff = max((abs(a[3] - b[3]) for k in want if same_rows
                for a, b in zip(got[k], want[k])), default=float("inf"))
    emit({"phase": "jobs_vs_sequential", "jobs": 2,
          "same_detections": same_rows, "max_confidence_diff": diff,
          "identical": got == want,
          "launches": launches, "launches_sequential": seq_launches,
          "pipeline_ms_jobs": (result.summary or {}).get("duration_ms"),
          "pipeline_ms_sequential":
              (warm.summary or {}).get("duration_ms"),
          "pipeline_ms_first_sequential":
              (sequential.summary or {}).get("duration_ms"),
          "clock": "host"})
    check(same_rows and diff <= 1e-6,
          f"main_path_jobs: detections differ from the sequential run "
          f"(max confidence difference {diff})")
    check(launches.get("fused_logmel") == seq_launches.get("fused_logmel"),
          f"main_path_jobs: launches {launches} against {seq_launches}")
    return launches


def sharded_phase(onnx24, labels24, chunk, dev):
    """``shard_data_parallel`` over two replicas on one card, the double
    of a second card: the v2.4 bf16 chunk runner at batch 32 with
    ``mesh=[cuda:0, cuda:0]``, each replica launching ``fused_logmel`` on
    its 16 rows, against the unsharded runner on the same chunk (gathered
    scores within ``SCORE_DRIFT_BOUND``, top-1/top-5 agreement). The
    launch counts are read over the sharded step alone; the batch of each
    launch is read by a wrapper around the kernel's wrapper. Returns the
    sharded step's launch counts."""
    import torch

    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.contracts import ModelFamily, contract_for
    from birda_tpu_torch.models.zoo import onnx_model
    from birda_tpu_torch.ops import stft_conv

    contract = contract_for(ModelFamily.BIRDNET_V24)
    n, seg = contract.num_classes, contract.sample_count
    model = onnx_model(onnx24, contract, labels24, dtype=torch.bfloat16)
    kernel = stft_conv.fused_logmel
    batches = []

    def recorded(x, *args, **kw):
        batches.append(int(x.shape[0]))
        return kernel(x, *args, **kw)

    scores, launches, rows_per_launch, step_ms = {}, {}, {}, {}
    for name, mesh in (("unsharded", None), ("sharded", [dev, dev])):
        clf = BirdClassifier(model, device="cuda", min_confidence=0.0,
                             top_k=n, mesh=mesh)
        runner = clf.chunk_runner(BATCH, seg)
        runner.ensure_warm()
        torch.cuda.synchronize()
        stft_conv.LAUNCHES.clear()
        batches.clear()
        stft_conv.fused_logmel = recorded
        try:
            rows = runner.predict_chunk(chunk, BATCH)
        finally:
            stft_conv.fused_logmel = kernel
        launches[name] = dict(stft_conv.LAUNCHES)
        rows_per_launch[name] = list(batches)
        scores[name] = full_scores(rows, n)
        # Timed at top 5: decoding every class of 32 rows on the host
        # would outweigh the step.
        runner = BirdClassifier(model, device="cuda", min_confidence=0.0,
                                top_k=5, mesh=mesh).chunk_runner(BATCH, seg)
        runner.predict_chunk(chunk, BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_ITERS):
            runner.predict_chunk(chunk, BATCH)
        step_ms[name] = (time.perf_counter() - t0) / STEP_ITERS * 1e3
    rec = {"phase": "sharded_step", "replicas": [str(dev), str(dev)],
           "batch": BATCH, "classes": n,
           **agreement(scores["sharded"], scores["unsharded"]),
           "bound": SCORE_DRIFT_BOUND, "launches": launches,
           "fused_logmel_rows_per_launch": rows_per_launch,
           "chunk_step_ms_host_clock": step_ms}
    emit(rec)
    check(rows_per_launch["sharded"] == [BATCH // 2] * 2
          and launches["sharded"].get("fused_logmel") == 2,
          f"sharded_step: launches {launches} rows {rows_per_launch}")
    check(rec["max_abs_err"] <= SCORE_DRIFT_BOUND,
          f"sharded_step: against the unsharded step {rec['max_abs_err']}")
    return launches["sharded"]


def v30_phase(tmp: Path, calib_log):
    """Full-scale BirdNET v3.0 (``BIRDNET_V30_SPEC``, random weights from
    ``SEED``): ``analyze`` in bf16 over one generated 60 s recording at
    32 kHz, through ``fused_logmel``, then in int8 (twice: the second run
    loads the cached scales) and mixed; bf16 against fp32 on one 32-row
    chunk of a 160 s recording and the bf16 step (``step_v30``); int8 and
    mixed against fp32 on that chunk, printed and not held to
    ``SCORE_DRIFT_BOUND`` (ROADMAP C12: the JAX package drifts as far on
    this graph), and their steps (``step_v30_int8``, ``step_v30_mixed``);
    then :func:`v30_reference_phase`, which holds the port's int8 and mixed
    against the JAX package's. Returns the launch counts by precision."""
    from birda_tpu_torch.models.contracts import ModelFamily
    from birda_tpu_torch.onnx import fullscale

    graph, onnx30, labels30_path, labels30 = write_graph(
        fullscale.BIRDNET_V30_SPEC, tmp)
    del graph
    wav = tmp / "v30_32k.wav"
    write_wav(wav, recording(32_000, 60.0, SEED + 50), 32_000)
    launches, _ = main_path("main_path_v30", "fused_logmel", [wav], onnx30,
                            labels30_path, "birdnet-v30")
    quant = quantized_main_paths("_v30", "fused_logmel", [wav], onnx30,
                                 labels30_path, "birdnet-v30", calib_log,
                                 mixed=True)
    long_wav = tmp / "v30_32k_160s.wav"
    write_wav(long_wav, recording(32_000, 160.0, SEED + 51), 32_000)
    chunk, fp32 = bf16_vs_fp32("bf16_vs_fp32_v30", ModelFamily.BIRDNET_V30,
                               onnx30, labels30, long_wav, relative=False,
                               step_phase="step_v30")
    card = {precision: quantized_vs_fp32(
        f"{precision}_vs_fp32_v30", ModelFamily.BIRDNET_V30, onnx30,
        labels30, chunk, fp32, relative=False, precision=precision,
        step_phase=f"step_v30_{precision}", held=False)
        for precision in ("int8", "mixed")}
    v30_reference_phase(onnx30, card)
    return {"bf16": launches, **quant}


#: How near a rounding boundary (``k + 0.5`` in quantization steps) a
#: value two fp32 runs (the two packages', or the card's and the CPU's)
#: quantize one step apart may lie, relative to its magnitude: their float
#: arithmetic differs by rounding (measured: under 7e-6).
TIE_REL = 1e-4


def quantizer_scale(ev, name: str, ndim: int):
    """The multiplier the int8 evaluator ``ev`` quantizes activation
    ``name`` with (its ``_qact``): ``1/scale``, over the channel's
    smoothing divisor where there is one."""
    import numpy as np

    mult = np.float32(1.0 / ev._ascale[name])
    sm = ev._asmooth.get(name)
    if sm is not None:
        mult = (mult / sm).astype(np.float32).reshape(
            (1, -1) + (1,) * (ndim - 2))
    return mult


def record_quantized(fn, run):
    """``run()`` with the port's int8 evaluator of ``fn`` recording each
    activation it quantizes (name -> int8 array on the host, the first
    time each is quantized). Returns ``(run(), recorded)``."""
    ev, plain, seen = fn._eval, fn._eval._qact, {}

    def recording(x, name):
        q = plain(x, name)
        if name not in seen:
            seen[name] = q.cpu().numpy()
        return q

    ev._qact = recording
    try:
        return run(), seen
    finally:
        del ev._qact


def forced_quantized(fn, run, reference: dict, tie_rel: float):
    """``run()`` with each activation the port's int8 evaluator of ``fn``
    quantizes taken from ``reference`` (another run's, by name) where the
    two differ: the runs then agree up to float rounding, if every value
    they quantize apart lies one step apart within ``tie_rel`` of its
    magnitude from a rounding boundary (a tie the two round differently).
    Returns ``(run(), stats)``: tensors quantized, tensors and elements
    apart, the largest step and the largest distance from the boundary
    over the magnitude."""
    import numpy as np
    import torch

    ev, plain = fn._eval, fn._eval._qact
    stats = {"tensors": 0, "tensors_apart": 0, "elements_apart": 0,
             "max_steps_apart": 0, "max_tie_distance_rel": 0.0,
             "tie_rel": tie_rel}

    def forced(x, name):
        q = plain(x, name)
        if not x.is_floating_point():
            return q  # stored int8 at its producer, already forced there
        ref = torch.from_numpy(reference[name]).to(q.device)
        stats["tensors"] += 1
        apart = q != ref
        if bool(apart.any()):
            y = (x.float() * torch.from_numpy(np.asarray(
                quantizer_scale(ev, name, x.ndim))).to(x.device))[apart]
            dist = ((y - y.floor() - 0.5).abs() / y.abs().clamp_min(1.0))
            stats["tensors_apart"] += 1
            stats["elements_apart"] += int(apart.sum())
            stats["max_steps_apart"] = max(stats["max_steps_apart"], int(
                (q.int() - ref.int()).abs().max()))
            stats["max_tie_distance_rel"] = max(
                stats["max_tie_distance_rel"], float(dist.max()))
        return ref

    ev._qact = forced
    try:
        return run(), stats
    finally:
        del ev._qact


def ties_only(stats) -> bool:
    """Every value two runs quantized apart was a tie one step apart."""
    return (stats["max_steps_apart"] <= 1
            and stats["max_tie_distance_rel"] <= stats["tie_rel"])


def v30_reference_phase(onnx30, card):
    """The port's full-scale v3.0 int8 and mixed at fp32 compute, lowered
    from its fp32 calibration on the CPU on the built-in set, on the JAX
    int8 bench's 8 probe rows (``calibration_signals(..., batch=8,
    n_batches=1, seed=123)``), on the card and on the CPU. Held: every
    value the card quantizes apart from the CPU is a rounding tie one step
    apart (``TIE_REL``), and with those taken from the CPU run the card's
    scores are the CPU's within ``REFERENCE_BOUND`` with the same argmax
    (``tests/test_torch_int8_fullscale.py`` holds the CPU's against the
    JAX package's so, tie for tie). Printed beside, not held: each run left
    alone against the JAX package's scores (``REFERENCE_SCORES``), the JAX
    package's own move when one value rounds the other way, ``card`` (the
    bf16-compute routes against fp32 on the 32-row chunk), and on the probe
    rows the bf16-compute int8 (with and without its smoothing,
    ``smooth_alpha=None``) and mixed against the card's fp32 and bf16 runs
    of the float graph, as the JAX package's own drifts are read on the
    CPU."""
    import numpy as np
    import torch

    from birda_tpu_torch.models.contracts import ModelFamily, contract_for
    from birda_tpu_torch.models.zoo import params_from_numpy
    from birda_tpu_torch.onnx.lowering import lower
    from birda_tpu_torch.onnx.quantize import (calibrate,
                                               calibration_signals,
                                               lower_int8)

    want = np.load(REFERENCE_SCORES)
    seg = contract_for(ModelFamily.BIRDNET_V30).sample_count
    data = Path(onnx30).read_bytes()
    t0 = time.perf_counter()
    calib = calibrate(data, calibration_signals(seg), device="cpu")
    rec = {"phase": "v30_int8_reference", "calibration_device": "cpu",
           "calibration_s": time.perf_counter() - t0,
           "rows": REFERENCE_ROWS, "bound": REFERENCE_BOUND}
    rows = torch.from_numpy(next(calibration_signals(
        seg, batch=REFERENCE_ROWS, n_batches=1, seed=REFERENCE_SEED)))

    def lowered(route):
        precision, compute = route.split("-")[0], route.split("-")[-1]
        dtype = torch.bfloat16 if compute == "bf16" else None
        if precision in ("fp32", "bf16"):
            return lower(data, compute_dtype=dtype), dtype
        return lower_int8(data, calib, compute_dtype=dtype,
                          boundary_store="storage" if precision == "mixed"
                          else "all",
                          smooth_alpha=None if "nosmooth" in route
                          else 0.5), dtype

    def on(fn, dtype, device):
        params = params_from_numpy(fn.params, device, dtype)
        if device != "cpu":
            fn.prepare(params)
        x = rows.to(device)

        def run():
            with torch.inference_mode():
                return fn(x, params=params)[0].float().cpu().numpy()
        return run

    def drift(got, ref):
        return {"max_abs": float(np.abs(got - ref).max()),
                "top1_agreement": float(np.mean(got.argmax(-1)
                                                == ref.argmax(-1)))}

    for precision in ("int8", "mixed"):
        fn, _ = lowered(f"{precision}-fp32")
        cpu, recorded = record_quantized(fn, on(fn, None, "cpu"))
        card_run = on(fn, None, "cuda")
        alone = card_run()
        forced, ties = forced_quantized(fn, card_run, recorded, TIE_REL)
        del fn, recorded, card_run
        rec[precision] = {
            "card_forced_vs_cpu": drift(forced, cpu), "ties": ties,
            "card_vs_cpu": drift(alone, cpu),
            "card_vs_jax": drift(alone, want[precision]),
            "cpu_vs_jax": drift(cpu, want[precision]),
            "jax_one_flip_vs_jax": drift(want[f"{precision}_one_flip"],
                                         want[precision]),
            "card_bf16_compute_chunk_vs_fp32": card[precision]}
    scores = {}
    for route in ("fp32-fp32", "bf16-bf16", "int8-bf16",
                  "int8-nosmooth-bf16", "mixed-bf16"):
        fn, dtype = lowered(route)
        scores[route] = on(fn, dtype, "cuda")()
        del fn
    rec["probe_rows_bf16_compute"] = {
        f"{route} vs {ref}": drift(scores[route], scores[ref])
        for route in ("int8-bf16", "int8-nosmooth-bf16", "mixed-bf16")
        for ref in ("fp32-fp32", "bf16-bf16")}
    emit(rec)
    for precision in ("int8", "mixed"):
        r = rec[precision]
        check(ties_only(r["ties"])
              and r["card_forced_vs_cpu"]["max_abs"] <= REFERENCE_BOUND
              and r["card_forced_vs_cpu"]["top1_agreement"] == 1.0,
              f"v30_int8_reference: {precision} on the card against the "
              f"CPU {r}")


def seq_phase(tmp: Path, dev):
    """The spectrogram transformer of ``tests/torch_seq_graphs.py`` at full
    width and depth (BirdNET v3.0's front end, a 16x16/10 patch embedding
    into 588 tokens, 12 ORT-form encoder layers as one scan-over-layers
    Loop at hidden 768, 12 heads, MLP 3072, the head behind an If with its
    [768, 11560] weight a branch initializer; random weights from
    ``SEED``): ``analyze(device="auto")`` in bf16 at batch 32 over one
    generated 60 s recording at 32 kHz, through ``fused_logmel``. Then one
    32-row chunk of a 160 s recording on the card and on the CPU, each in
    bf16 and fp32: bf16 against fp32 on the card within
    ``SCORE_DRIFT_BOUND``, the card's fp32 against the CPU's within
    ``SEQ_FP32_BOUND``, and, reported beside them, the CPU's bf16 against
    its fp32 and the card's bf16 against the CPU's; one step with no host
    sync; and the steady step (``step_seq``). Returns the launch counts."""
    import torch
    import torch_seq_graphs as sg

    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.contracts import ModelFamily, contract_for
    from birda_tpu_torch.models.zoo import onnx_model, synthetic_labels

    t0 = time.perf_counter()
    graph = sg.build(sg.FULL, seed=SEED)
    path = tmp / f"{sg.FULL.name}.onnx"
    path.write_bytes(graph.model_bytes)
    labels = synthetic_labels(sg.FULL.num_classes)
    labels_path = tmp / f"{sg.FULL.name}-labels.txt"
    labels_path.write_text("\n".join(labels) + "\n")
    emit({"phase": "fixture", "graph": sg.FULL.name,
          "params": graph.param_count, "macs_per_segment": graph.macs,
          "tokens": graph.tokens, "layers": sg.FULL.layers,
          "hidden": sg.FULL.hidden, "heads": sg.FULL.heads,
          "mlp": sg.FULL.mlp, "onnx_bytes": len(graph.model_bytes),
          "seconds": time.perf_counter() - t0})
    del graph
    wav = tmp / "seq_32k.wav"
    write_wav(wav, recording(32_000, 60.0, SEED + 70), 32_000)
    launches, _ = main_path("main_path_seq", "fused_logmel", [wav], path,
                            labels_path, "birdnet-v30", device="auto")

    contract = contract_for(ModelFamily.BIRDNET_V30)
    n, seg = contract.num_classes, contract.sample_count
    long_wav = tmp / "seq_32k_160s.wav"
    write_wav(long_wav, recording(32_000, 160.0, SEED + 71), 32_000)
    chunk = read_wav(long_wav)[:BATCH * seg]
    scores, seconds = {}, {}
    for name, dtype, where in (("card_bf16", torch.bfloat16, "cuda"),
                               ("card_fp32", None, "cuda"),
                               ("cpu_fp32", None, "cpu"),
                               ("cpu_bf16", torch.bfloat16, "cpu")):
        clf = BirdClassifier(onnx_model(path, contract, labels, dtype=dtype),
                             device=where, min_confidence=0.0, top_k=n)
        t = time.perf_counter()
        scores[name] = full_scores(
            clf.chunk_runner(BATCH, seg).predict_chunk(chunk, BATCH), n)
        seconds[name] = time.perf_counter() - t
        del clf
    bf16 = agreement(scores["card_bf16"], scores["card_fp32"])
    fp32 = agreement(scores["card_fp32"], scores["cpu_fp32"])
    # A second witness of the bf16 drift: the CPU's bf16 route (the same
    # arithmetic: bf16-rounded operands, fp32 sums, bf16 outputs) against
    # the CPU's fp32, and the card's bf16 against it.
    witness = {"cpu_bf16_vs_cpu_fp32": agreement(scores["cpu_bf16"],
                                                 scores["cpu_fp32"]),
               "card_bf16_vs_cpu_bf16": agreement(scores["card_bf16"],
                                                  scores["cpu_bf16"])}
    model = onnx_model(path, contract, labels, dtype=torch.bfloat16)
    sync = sync_check(model, chunk.reshape(BATCH, seg), dev)
    emit({"phase": "seq_chunk", "rows": BATCH, "classes": n,
          "card_bf16_vs_card_fp32": bf16, "bound_bf16": SCORE_DRIFT_BOUND,
          "card_fp32_vs_cpu_fp32": fp32, "bound_fp32": SEQ_FP32_BOUND,
          **witness,
          "max_fp32_score": float(scores["cpu_fp32"].max()),
          "first_chunk_s": seconds, "sync_check": sync or "no sync"})
    check(bf16["max_abs_err"] <= SCORE_DRIFT_BOUND,
          f"seq_chunk: bf16 against fp32 on the card {bf16['max_abs_err']}")
    check(fp32["max_abs_err"] <= SEQ_FP32_BOUND,
          f"seq_chunk: fp32 card against CPU {fp32['max_abs_err']}")
    check(sync is None, f"seq_chunk: a host sync in the step: {sync}")
    steady_step("step_seq", BirdClassifier(
        model, device="cuda", min_confidence=0.0, top_k=5), chunk)
    del model
    torch.cuda.empty_cache()
    return launches


# -- the front-end routes, the kernel check, the parity tool, the acceptance
# -- rehearsal and the CLI ----------------------------------------------------

def _script(name: str):
    """A module of ``scripts/`` (the port's tools), imported by name."""
    scripts = str(Path(__file__).resolve().parent / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import importlib

    return importlib.import_module(name)


def kernel_routes_phase(dev):
    """Every geometry of ``tests/torch_route_graphs.py`` through ``lower``
    in bf16 on the card against the port's CPU bf16 run of the same graph
    (within 2e-2 of the largest magnitude): the shipped front ends and the
    wide ones (hop 512 and 1024 convs, a hop 640 and a 320-mel fused front
    end, in fewer frames per block or two mel passes) on their kernels, a
    conv of an 80,000-sample window on its kernel with the span streamed
    in pieces, a conv whose one window outgrows both the kernel's shared
    memory and the JAX package's VMEM budget on the JAX package's composed
    route, none raising. Returns the launch counts."""
    import torch_route_graphs as rg

    from birda_tpu_torch.ops import stft_conv

    verify = _script("verify_kernels_cuda")
    total = {}
    for case in rg.CASES:
        stft_conv.LAUNCHES.clear()
        rec = verify.route_case(case, 2, dev)
        for k, v in stft_conv.LAUNCHES.items():
            total[k] = total.get(k, 0) + v
        emit({"phase": "kernel_routes", **rec})
        check(rec["ok"], f"kernel_routes {case.name}: {rec}")
    return total


def verify_kernels_phase(dev):
    """``scripts/verify_kernels_cuda.py``'s kernel cases: both kernels at
    ``verify_kernels_tpu.py``'s three geometries and at the wide ones
    (fewer frames per block, two mel passes), and ``conv1d_stft`` at the
    long windows whose span it streams in pieces (ROADMAP C9), batch 4,
    against float64 (conv max error over max |want| < 2e-2, log-mel q99 <
    5e-2) and their plain versions, timed. Returns the records of both
    kernels, those of the long windows and the checked calls' launch
    counts."""
    verify = _script("verify_kernels_cuda")
    records, long_windows, total = {}, {}, {}
    for name, s, k, hop, mels in verify.STFT_CASES + verify.WIDE_CASES:
        rec = verify.stft_case(name, s, k, hop, mels, 4, dev)
        for kernel, n in rec["launches"].items():
            total[kernel] = total.get(kernel, 0) + n
        emit({"phase": "verify_kernels", **rec})
        check(rec["ok"], f"verify_kernels {name}: {rec}")
        records[name] = rec
    for name, s, k, hop, c in verify.C9_CASES:
        rec = verify.conv_case(name, s, k, hop, c, 4, dev)
        total["conv1d_stft"] = total.get("conv1d_stft", 0) + rec["launches"]
        emit({"phase": "verify_kernels", **rec})
        check(rec["ok"], f"verify_kernels {name}: {rec}")
        long_windows[name] = rec
    return records, long_windows, total


def stft_gather_phase(onnx_path, dev):
    """``BIRDA_STFT_KERNEL=gather`` (the only phase that sets it) on
    full-scale v2.4 in bf16, two rows: the fused front end takes the
    composed route on the card and launches no front-end kernel, and its
    scores agree with the CPU's run of the same route within the bf16
    score bound; unset, the same function takes the kernel again (one
    ``fused_logmel`` launch). Returns the gather run's launch counts."""
    import torch

    from birda_tpu_torch.models.zoo import params_from_numpy
    from birda_tpu_torch.onnx import fullscale
    from birda_tpu_torch.onnx.lowering import lower
    from birda_tpu_torch.ops import stft_conv

    spec = fullscale.BIRDNET_V24_SPEC
    x = torch.from_numpy(recording(spec.sample_rate,
                                   2 * spec.sample_count / spec.sample_rate,
                                   SEED + 50).reshape(2, -1))
    fn = lower(onnx_path.read_bytes(), compute_dtype=torch.bfloat16)
    params = params_from_numpy(fn.params, dev, torch.bfloat16)
    fn.prepare(params)

    def run(device, p):
        routes = dict(stft_conv.ROUTES)
        stft_conv.LAUNCHES.clear()
        with torch.inference_mode():
            out = fn(x.to(device), params=p)
        scores = (out[0] if isinstance(out, tuple) else out).float().cpu()
        took = {k: v - routes.get(k, 0) for k, v in stft_conv.ROUTES.items()
                if v != routes.get(k, 0)}
        return scores, took, dict(stft_conv.LAUNCHES)

    os.environ["BIRDA_STFT_KERNEL"] = "gather"
    try:
        card, routes, launches = run(dev, params)
        cpu, cpu_routes, _ = run(torch.device("cpu"), params_from_numpy(
            fn.params, "cpu", torch.bfloat16))
    finally:
        del os.environ["BIRDA_STFT_KERNEL"]
    kernel, kernel_routes, kernel_launches = run(dev, params)
    err = float((card - cpu).abs().max())
    emit({"phase": "stft_gather", "rows": 2, "routes": routes,
          "launches": launches, "cpu_routes": cpu_routes,
          "max_abs_err_vs_cpu": err,
          "max_abs_diff_vs_kernel_route": float(
              (card - kernel).abs().max()),
          "unset_routes": kernel_routes, "unset_launches": kernel_launches})
    check(routes == cpu_routes == {"fused_logmel:composed": 1}
          and not any(launches.values()),
          f"stft_gather: routes {routes}, launches {launches}")
    check(bool(torch.isfinite(card).all()) and err <= SCORE_DRIFT_BOUND,
          f"stft_gather: {err} against the CPU")
    check(kernel_routes == {"fused_logmel:kernel": 1}
          and kernel_launches == {"fused_logmel": 1},
          f"stft_gather unset: {kernel_routes}, {kernel_launches}")
    return launches


def recall_report_phase(onnx_path, labels_path, wav):
    """``scripts/torch_int8_recall_report.py`` in a subprocess on full-scale
    v2.4 with random weights, over 32 segments of a generated recording
    (``--audio``): it must run on ``cuda:0`` and print its report. A
    failed recall criterion (exit 1) is a result of random weights, printed
    with the criteria lines, not a failure of the phase."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "scripts"
                             / "torch_int8_recall_report.py"),
         str(onnx_path), "--audio", str(wav), "--limit", "32",
         "--labels", str(labels_path)],
        capture_output=True, text=True, timeout=900)
    lines = r.stdout.splitlines()
    emit({"phase": "recall_report", "exit_code": r.returncode,
          "seconds": time.perf_counter() - t0,
          "device": lines[0] if lines else None,
          "report": [ln for ln in lines[1:] if ln.strip()
                     and not ln.startswith("    ")],
          "stderr_tail": r.stderr[-2000:] if r.returncode not in (0, 1)
          else ""})
    check(r.returncode in (0, 1) and lines
          and lines[0].startswith("device: cuda:0")
          and any("int8 accuracy report: 32 segments" in ln for ln in lines),
          f"recall_report: exit {r.returncode}\n{r.stdout}\n{r.stderr}")


def host_budget_phase():
    """``scripts/torch_bench_host_budget.py`` at batch 32 over a 120 s
    file: the host's decode, assembly and quantize costs per chunk on the
    card's machine (no card needed)."""
    r = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "scripts"
                             / "torch_bench_host_budget.py"),
         "--batch", str(BATCH), "--seconds", "120"],
        capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"host_budget: exit {r.returncode}\n"
          f"{r.stdout}\n{r.stderr}")
    rec = json.loads(r.stdout)
    emit({"phase": "host_budget", "batch": BATCH, "seconds": 120, **rec})
    check(all(v > 0 for k, v in rec["host"].items() if k != "note"),
          f"host_budget: {rec}")


#: The measuring tools as ``bench_tools`` runs them: (name, environment,
#: arguments, time limit in seconds). Few steps and one short e2e file, so
#: the phase stays near two minutes; the full runs are the tools' own.
BENCH_TOOLS = (
    ("torch_bench", {}, ["--only", "birdnet_v24,perch_v2_int8,birdnet_v30,"
                         "e2e,native_v24", "--iters", "2", "--repeats", "2",
                         "--e2e-seconds", "60",
                         "--e2e-files", "1", "--budget", "400"], 480),
    ("torch_bench_int8", {}, ["birdnet-v24", "--iters", "2", "--repeats",
                              "2", "--budget", "300"], 360),
    ("torch_sweep_int8_batch", {"BATCHES": "32,64"},
     ["perch-v2", "--iters", "2", "--repeats", "2", "--budget", "300"],
     360),
)


def _bench_records(name: str, lines: list) -> list:
    """The measurement records in a tool's output lines."""
    if name == "torch_bench":
        return list(lines[-1]["extra"]["measurements"].values())
    if name == "torch_bench_int8":
        return [r for fam in lines[-1].values()
                for r in fam["measurements"].values()]
    return [ln for ln in lines[:-1] if "oom" not in ln]


def bench_tools_phase():
    """``scripts/torch_bench.py`` (v2.4 bf16, Perch v2 int8, v3.0 bf16,
    e2e on one 60 s file and the native v2.4 backbone in bf16),
    ``scripts/torch_bench_int8.py`` (v2.4) and
    ``scripts/torch_sweep_int8_batch.py`` (Perch v2 int8 at batch 32 and
    64), each in a subprocess with its own time limit, on the main paths'
    cached graphs and scales: each exits 0, names the card, reports
    positive rates and times, launches its family's front-end kernel (the
    native backbone none, its stages out in bf16 and its planted faults
    past its bound) and holds the drift bound. Returns the launch counts
    of all three."""
    import torch

    kind = torch.cuda.get_device_name(0)
    launches: dict = {}
    for name, env, args, limit in BENCH_TOOLS:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(Path(__file__).resolve().parent / "scripts"
                                 / f"{name}.py"), *args],
            capture_output=True, text=True, timeout=limit,
            env={**os.environ, **env})
        check(r.returncode == 0, f"bench_tools {name}: exit {r.returncode}\n"
              f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
        lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
        records = _bench_records(name, lines)
        got = {}
        for rec in records:
            for kernel, n in rec["launches"].items():
                got[kernel] = got.get(kernel, 0) + n
        emit({"phase": "bench_tools", "tool": name, "args": args, **env,
              "seconds": time.perf_counter() - t0, "launches": got,
              "last_line": lines[-1]})
        check(kind in r.stdout, f"bench_tools {name}: no card name")
        check(records and all(
            (rec["launches"].get(("conv1d_stft" if rec.get("family") ==
                                  "perch-v2" else "fused_logmel"), 0) > 0
             if "planted_fault_drift" not in rec else
             rec["launches"] == {} and rec["stage_dtypes"] == ["bfloat16"]
             and rec["planted_fault_drift_min"] > rec["drift_bound"])
            and rec["x_realtime"] > 0
            and rec.get("drift", 0.0) <= rec.get("drift_bound",
                                                 SCORE_DRIFT_BOUND)
            and all(rec[k] > 0 for k in ("x_realtime_min", "step_ms",
                                         "device_busy_ms_per_step",
                                         "kernels_per_step")
                    if k in rec)
            for rec in records), f"bench_tools {name}: {records}")
        if name == "torch_bench":
            line = lines[-1]
            check(line["value"] > 0 and line["vs_baseline"] > 0
                  and line["extra"]["e2e_x_realtime"] > 0,
                  f"bench_tools torch_bench: {line}")
        for kernel, n in got.items():
            launches[kernel] = launches.get(kernel, 0) + n
    return launches


def _tensor_errors(got: dict, want: dict, order: list) -> list:
    """(tensor, max |got - want|, max |want|) over the tensors both hold,
    in execution order (the recorded magnitude scales a bf16 error)."""
    import numpy as np

    out = []
    for name in order:
        if name in got and name in want and np.size(want[name]):
            g = np.asarray(got[name], np.float64)
            w = np.asarray(want[name], np.float64)
            if g.shape == w.shape:
                out.append((name, float(np.abs(g - w).max()),
                            float(np.abs(w).max())))
    return out


def _first_over(errs: list, tol: float):
    """The first tensor of ``_tensor_errors``' list, in execution order,
    whose error exceeds ``tol`` times its largest recorded magnitude (None
    when none does): the bisection walk with a bound that scales with the
    values a run rounds."""
    return next(({"tensor": name, "max_abs_err": err, "magnitude": mag}
                 for name, err, mag in errs if err > tol * mag), None)


def parity_phase(spec, onnx_path, dev):
    """The per-node bisection tool (``onnx/parity.py``) on full-scale v2.4:
    a recording of the port's CPU run (``capture_activations``), then the
    card's captures walked against it in execution order, fp32 at 1e-3 and
    bf16 (against the CPU's bf16 run, the front end fused) at 5e-2, each of
    the tensor's largest recorded magnitude (the power spectrum reaches
    2.3e4, where one fp32 step is 2e-3, past the tool's absolute 1e-3),
    neither diverging; the bf16 capture launches ``fused_logmel`` once.
    ``find_first_divergence`` itself, with its absolute 1e-3, names a
    perturbation planted in the stem conv's weight against the card's own
    fp32 capture. Returns the fp32 recording, the signal rows, the CPU's
    fp32 scores of them and the bf16 capture's launch counts."""
    import numpy as np
    import torch

    from birda_tpu_torch.models.zoo import params_from_numpy
    from birda_tpu_torch.onnx import parity
    from birda_tpu_torch.onnx.lowering import lower
    from birda_tpu_torch.ops import stft_conv

    rows = 8
    s = spec.sample_count
    x = recording(spec.sample_rate, rows * s / spec.sample_rate,
                  SEED + 30).reshape(rows, s)
    model_bytes = onnx_path.read_bytes()
    t0 = time.perf_counter()
    fn32 = lower(model_bytes)
    order = list(fn32.input_names) + [o for n in fn32.graph.nodes
                                      for o in n.outputs if o]
    recorded = parity.capture_activations(fn32, x[:1], device="cpu")
    with torch.inference_mode():
        scores = fn32(torch.from_numpy(x))[0].numpy()
    cpu_s = time.perf_counter() - t0
    p32 = params_from_numpy(fn32.params, dev)
    card32 = parity.capture_activations(fn32, x[:1], params=p32)
    err32 = _tensor_errors(card32, recorded, order)
    div32 = _first_over(err32, 1e-3)

    fnb = lower(model_bytes, compute_dtype=torch.bfloat16)
    orderb = list(fnb.input_names) + [o for n in fnb.graph.nodes
                                      for o in n.outputs if o]
    cpub = parity.capture_activations(
        fnb, x[:1], params=params_from_numpy(fnb.params, "cpu",
                                             torch.bfloat16), device="cpu")
    pb = params_from_numpy(fnb.params, dev, torch.bfloat16)
    fnb.prepare(pb)
    stft_conv.LAUNCHES.clear()
    cardb = parity.capture_activations(fnb, x[:1], params=pb)
    launches = dict(stft_conv.LAUNCHES)
    errb = _tensor_errors(cardb, cpub, orderb)
    errb32 = _tensor_errors(cardb, recorded, orderb)
    divb = _first_over(errb, 5e-2)

    # The stem conv: the first 2-D Conv (its weight an inline constant,
    # which a run's params override).
    weights = {**fn32._eval.const, **fn32.params}
    stem = next(n for n in fn32.graph.nodes if n.op_type == "Conv"
                and np.ndim(weights[n.inputs[1]]) == 4)
    bad = {**p32, stem.inputs[1]: torch.from_numpy(
        np.asarray(weights[stem.inputs[1]]) * np.float32(1.05)).to(dev)}
    planted = parity.find_first_divergence(fn32, x[:1], card32, tol=1e-3,
                                           params=bad)

    def worst(errs):
        name, err, mag = max(errs, key=lambda e: e[1])
        return {"tensor": name, "max_abs_err": err, "magnitude": mag}

    rec = {"phase": "parity_v24", "tensors_fp32": len(err32),
           "tensors_bf16": len(errb), "cpu_recording_s": cpu_s,
           "fp32_worst": worst(err32),
           "fp32_worst_rel": max(e / m for _, e, m in err32 if m),
           "fp32_divergence": div32,
           "bf16_worst_vs_cpu_bf16": worst(errb),
           "bf16_worst_rel_vs_cpu_bf16": max(
               e / m for _, e, m in errb if m),
           "bf16_worst_rel_vs_cpu_fp32": max(
               e / m for _, e, m in errb32 if m),
           "bf16_divergence": divb,
           "bf16_launches": launches,
           "planted": {"conv": stem.name,
                       "named": planted.render() if planted else None}}
    emit(rec)
    check(div32 is None, f"parity_v24 fp32: {div32}")
    check(divb is None, f"parity_v24 bf16: {divb}")
    check(launches == {"fused_logmel": 1},
          f"parity_v24 bf16 capture launches {launches}")
    check(planted is not None and planted.tensor == stem.outputs[0]
          and planted.op_type == "Conv",
          f"parity_v24 planted: {rec['planted']}")
    return recorded, x, scores, launches


def accept_phase(tmp: Path, onnx_path, labels_path, recorded, x, scores):
    """``scripts/torch_accept_asset.py`` on the full-scale v2.4 graph with
    the parity phase's CPU recording as ``--reference`` (8 rows of scores,
    every activation of the first): no gate may FAIL. Returns the launch
    counts (the bf16 bench goes through ``fused_logmel``)."""
    import numpy as np

    from birda_tpu_torch.ops import stft_conv

    ref = tmp / "v24_reference.npz"
    np.savez(ref, inputs=x, scores=scores, node_input_rows=1,
             **{f"node:{k}": v for k, v in recorded.items()})
    out = tmp / "accept_v24.json"
    accept = _script("torch_accept_asset")
    stft_conv.LAUNCHES.clear()
    t0 = time.perf_counter()
    rc = accept.main([str(onnx_path), str(labels_path), "--reference",
                      str(ref), "--json", str(out)])
    launches = dict(stft_conv.LAUNCHES)
    report = json.loads(out.read_text())
    gates = {g["gate"]: g for g in report["gates"]}
    emit({"phase": "accept_v24", "exit_code": rc,
          "seconds": time.perf_counter() - t0, "launches": launches,
          "gates": {k: [g["status"], g["detail"]] for k, g in gates.items()}})
    check(rc == 0 and not any(g["status"] == "FAIL"
                              for g in gates.values()),
          f"accept_v24: {report['gates']}")
    check(launches.get("fused_logmel", 0) > 0,
          f"accept_v24: the bf16 bench launched {launches}")
    return launches


#: Runs the port's CLI as ``python -m birda_tpu_torch.cli.main`` does and
#: then prints the process's kernel launch counts.
CLI_WITH_LAUNCHES = (
    "import json, sys\n"
    "from birda_tpu_torch.cli.main import main\n"
    "from birda_tpu_torch.ops import stft_conv\n"
    "rc = main(sys.argv[1:])\n"
    "print('launches ' + json.dumps(dict(stft_conv.LAUNCHES)))\n"
    "sys.exit(rc)\n")


def clip_samples(csv_path: Path, wav: Path) -> list:
    """The clips the JAX package's clipper cuts from ``csv_path`` at the
    default padding: each detection group's sample count,
    ``int(end * rate) - int(start * rate)``, cut at the end of the file
    (``birda_tpu/clipper/extractor.py``); groups by
    ``clipper/grouper.py``, a copy of the JAX package's."""
    from birda_tpu_torch.clipper.grouper import group_detections
    from birda_tpu_torch.clipper.parser import parse_detection_file
    from birda_tpu_torch.constants import clipper as consts

    with wave.open(str(wav)) as w:
        rate, total = w.getframerate(), w.getnframes()
    groups = group_detections(parse_detection_file(csv_path),
                              consts.DEFAULT_PRE_PADDING,
                              consts.DEFAULT_POST_PADDING)
    return sorted(min(int(g.end * rate), total) - int(g.start * rate)
                  for g in groups)


def cli_phase(tmp: Path, onnx_path, labels_path):
    """The port's CLI in subprocesses on the card, from a fresh home:
    ``version``, ``providers`` (naming the card), ``config init``/``set``/
    ``show``, ``models add`` of the full-scale v2.4 graph, ``models
    check`` (OK) and ``models list``, a bare-file ``analyze`` of a 30 s
    recording in bf16 (it must launch ``fused_logmel``), and ``clip`` on
    that run's CSV: as many clips as detection groups, each of the JAX
    clipper's sample count. Returns the analyze run's launch counts."""
    import torch

    root = tmp / "cli"
    home = {f"XDG_{d.upper()}_HOME": str(root / d)
            for d in ("config", "cache", "data")}
    envs = {**os.environ, **home}
    envs.pop("BIRDA_OUTPUT_MODE", None)
    repo = str(Path(__file__).resolve().parent)
    timings = {}

    def cli(*argv, code=0, runner=("-m", "birda_tpu_torch.cli.main")):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *runner, *map(str, argv)],
                           cwd=repo, env=envs, capture_output=True,
                           text=True, timeout=600)
        timings[" ".join(map(str, argv[:2]))] = time.perf_counter() - t0
        check(r.returncode == code,
              f"cli {argv}: exit {r.returncode}\n{r.stdout}\n{r.stderr}")
        return r.stdout

    check(cli("version") == "birda 0.1.0\n", "cli version")
    name = torch.cuda.get_device_name(0)
    check(f"cuda: CUDA ({name})" in cli("providers"),
          "cli providers: the card is not named")
    providers = json.loads(cli("providers", "--output-mode", "json"))
    cli("config", "init")
    cli("config", "set", "defaults.min_confidence", "0.1")
    check("min_confidence = 0.1" in cli("config", "show"), "cli config show")
    cli("models", "add", "v24", "--path", onnx_path, "--labels",
        labels_path, "--type", "birdnet-v24", "--default")
    check("v24: OK" in cli("models", "check"), "cli models check")
    check("v24 (default): birdnet-v24" in cli("models", "list"),
          "cli models list")
    wav = root / "rec.wav"
    write_wav(wav, recording(48_000, 30.0, SEED + 40), 48_000)
    out_dir = root / "out"
    out = cli(wav, "-m", "v24", "--precision", "bf16", "-b", BATCH, "-o",
              out_dir, "-q", runner=("-c", CLI_WITH_LAUNCHES))
    launches = json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])
    check(launches.get("fused_logmel", 0) > 0,
          f"cli analyze: fused_logmel launched {launches}")
    csv = out_dir / "rec.BirdNET.results.csv"
    want = clip_samples(csv, wav)
    clips = json.loads(cli("clip", csv, "--base-dir", root, "-o",
                           root / "clips", "--output-mode", "json"))
    payload = next(e for e in clips if e["event"] == "result")["payload"]
    got = []
    for c in payload["clips"]:
        with wave.open(c["output_file"]) as w:
            got.append(w.getnframes())
    rec = {"phase": "cli_commands", "launches": launches,
           "providers": providers[0]["payload"]["providers"],
           "detection_groups": len(want), "clips": payload["total_clips"],
           "clip_samples": sorted(got), "seconds": timings}
    emit(rec)
    check(len(want) > 0, "cli analyze: no detections to clip")
    check(payload["total_clips"] == len(want) and sorted(got) == want,
          f"cli clip: {len(got)} clips {sorted(got)} against the JAX "
          f"clipper's {want}")
    return launches


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
    from birda_tpu_torch.ops import _build, stft_conv

    dev = torch.device("cuda", 0)
    # The op case table (numpy and the port's encoder only).
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

    # -- 1. card and kernel builds ----------------------------------------
    smi = card_line()
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
        os.environ["XDG_DATA_HOME"] = str(tmp / "data")

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
        launches24, result24 = main_path("main_path", "fused_logmel",
                                         wavs24, onnx24, labels24_path,
                                         "birdnet-v24")
        chunk24, fp32_24 = bf16_vs_fp32(
            "bf16_vs_fp32", ModelFamily.BIRDNET_V24, onnx24, labels24,
            wavs24[0], relative=False, step_phase="step")
        launches_jobs = jobs_phase(wavs24, onnx24, labels24_path, result24,
                                   launches24)
        launches_sharded = sharded_phase(onnx24, labels24, chunk24, dev)
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

        # -- 2b. the native family (synthetic:full) and BirdNET v3.0 -------
        launches_native = native_phase(wavs24)
        launches_v30 = v30_phase(tmp, calib_log)
        launches_seq = seq_phase(tmp, dev)

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
        launches_perch_qdq = perch_qdq_phase(
            tmp, onnx_perch, labels_perch_path, labels_perch, chunk_perch,
            fp32_perch, dev)

        # -- 4. the secondary heads --------------------------------------
        launches_bat = bat_phase(tmp, onnx24, labels24_path, labels24)
        geo = fixture_geomodel(tmp, labels24)
        launches_range = range_phase(tmp, onnx24, labels24_path, labels24,
                                     geo)
        species_phase(geo)
        launches_region_perch = region_phase(
            "main_path_region_perch", "conv1d_stft", tmp, "perch-v2",
            onnx_perch, labels_perch_path, labels_perch, 32_000,
            softmax=True, dev=dev, min_confidence=PERCH_MIN_CONFIDENCE,
            top_k=PERCH_TOP_K)
        launches_region24 = region_phase(
            "main_path_region_v24", "fused_logmel", tmp, "birdnet-v24",
            onnx24, labels24_path, labels24, 48_000, softmax=False, dev=dev)

        # -- 4b. the front-end routes, the kernel check, the parity tool,
        # -- the acceptance rehearsal and the CLI, on v2.4 ----------------
        stft_conv.LAUNCHES.clear()
        launches_routes = kernel_routes_phase(dev)
        verify, verify_c9, launches_verify = verify_kernels_phase(dev)
        recorded, rows24, scores24, launches_parity = parity_phase(
            fullscale.BIRDNET_V24_SPEC, onnx24, dev)
        launches_accept = accept_phase(tmp, onnx24, labels24_path,
                                       recorded, rows24, scores24)
        del recorded
        launches_cli = cli_phase(tmp, onnx24, labels24_path)
        launches_gather = stft_gather_phase(onnx24, dev)
        recall_report_phase(onnx24, labels24_path, wavs24[0])
        host_budget_phase()
        launches_bench = bench_tools_phase()

        # -- 5. the exact integer routes at the quantized nodes' shapes ----
        cases, gemms = int8_cases(convs24, mms24, convs_perch)
        # A grouped conv deeper than the exact fp32 depth (33 · 33 = 1089):
        # the split fp32 route.
        cases["grouped_depth_1089"] = ((BATCH, 132, 64, 16), (4, 33, 33, 1),
                                       (1, 1), ((16, 16), (0, 0)), (1, 1), 4)
        int8_results = int8_ops_phase(cases, gemms, dev)

        # -- 6. the ported op families, and the quantized integer ops -----
        qlinear_ops_phase(cases, int8_results, dev)
        ops_breadth_phase(dev)

    print(smi, flush=True)
    emit({"kernels": [
        kernel_entry("fused_logmel", "birda_tpu_torch/csrc/fused_logmel.cu",
                     "birda_tpu/ops/stft_conv.py:241",
                     launches24.get("fused_logmel", 0), logmel["v24_b32"],
                     composed_ms=logmel["v24_b32"]["composed_ms"],
                     v30_b32={k: logmel["v30_b32"][k] for k in (
                         "max_abs_err", "q99_abs_err", "ms", "plain_ms",
                         "composed_ms", "bound_ms", "bound_by",
                         "share_of_bound")},
                     launches_int8=quant24["int8"].get("fused_logmel", 0),
                     launches_mixed=quant24["mixed"].get("fused_logmel", 0),
                     launches_bat=launches_bat.get("fused_logmel", 0),
                     launches_range=launches_range.get("fused_logmel", 0),
                     launches_region=launches_region24.get("fused_logmel",
                                                           0),
                     launches_native=launches_native.get("fused_logmel", 0),
                     launches_jobs=launches_jobs.get("fused_logmel", 0),
                     launches_sharded=launches_sharded.get("fused_logmel",
                                                           0),
                     launches_v30=launches_v30["bf16"].get("fused_logmel",
                                                           0),
                     launches_v30_int8=launches_v30["int8"].get(
                         "fused_logmel", 0),
                     launches_v30_mixed=launches_v30["mixed"].get(
                         "fused_logmel", 0),
                     launches_seq=launches_seq.get("fused_logmel", 0),
                     launches_perch_qdq=launches_perch_qdq.get(
                         "fused_logmel", 0),
                     launches_routes=launches_routes.get("fused_logmel", 0),
                     launches_verify=launches_verify.get("fused_logmel", 0),
                     launches_parity=launches_parity.get("fused_logmel", 0),
                     launches_accept=launches_accept.get("fused_logmel", 0),
                     launches_cli=launches_cli.get("fused_logmel", 0),
                     launches_gather=launches_gather.get("fused_logmel", 0),
                     launches_bench=launches_bench.get("fused_logmel", 0),
                     verify={name: {"q99_err": rec["logmel_q99_err"],
                                    "frames_per_block": rec[
                                        "frames_per_block"]["fused_logmel"],
                                    "mel_passes": rec["mel_passes"],
                                    **rec["fused_logmel"]}
                             for name, rec in verify.items()}),
        kernel_entry("conv1d_stft", "birda_tpu_torch/csrc/conv1d_stft.cu",
                     "birda_tpu/ops/stft_conv.py:121",
                     launches_perch.get("conv1d_stft", 0),
                     conv["perch_b32"],
                     launches_int8=quant_perch["int8"].get("conv1d_stft", 0),
                     launches_bat=launches_bat.get("conv1d_stft", 0),
                     launches_range=launches_range.get("conv1d_stft", 0),
                     launches_region=launches_region_perch.get("conv1d_stft",
                                                               0),
                     launches_native=launches_native.get("conv1d_stft", 0),
                     launches_jobs=launches_jobs.get("conv1d_stft", 0),
                     launches_sharded=launches_sharded.get("conv1d_stft", 0),
                     launches_v30=launches_v30["bf16"].get("conv1d_stft",
                                                           0),
                     launches_seq=launches_seq.get("conv1d_stft", 0),
                     launches_perch_qdq=launches_perch_qdq.get(
                         "conv1d_stft", 0),
                     launches_routes=launches_routes.get("conv1d_stft", 0),
                     launches_verify=launches_verify.get("conv1d_stft", 0),
                     launches_parity=launches_parity.get("conv1d_stft", 0),
                     launches_accept=launches_accept.get("conv1d_stft", 0),
                     launches_cli=launches_cli.get("conv1d_stft", 0),
                     launches_gather=launches_gather.get("conv1d_stft", 0),
                     launches_bench=launches_bench.get("conv1d_stft", 0),
                     verify={name: {"rel_err": rec["conv_rel_err"],
                                    "frames_per_block": rec[
                                        "frames_per_block"]["conv1d_stft"],
                                    **rec["conv1d_stft"]}
                             for name, rec in verify.items()},
                     verify_long_windows={
                         name: {"rel_err": rec["conv_rel_err"],
                                "frames_per_block": rec["frames_per_block"],
                                "span_window_samples": rec[
                                    "span_window_samples"],
                                **rec["conv1d_stft"]}
                         for name, rec in verify_c9.items()}),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
