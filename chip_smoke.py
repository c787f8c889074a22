#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``birda_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``birda_tpu_torch/csrc``, holds each
against its plain PyTorch version at the main path's shapes, drives
``birda_tpu_torch.api.analyze`` on the full-scale BirdNET v2.4 graph (random
weights from a seed, bf16) over two generated 120 s recordings, checks that
the main path went through the kernels, and compares the bf16 route with the
fp32 route on one chunk. Each phase prints one JSON line; then come the
kernel summary line and, last, ``{"ok": true, "device": {...}}``. Any failed
check raises: the exit code is then non-zero and no result line is printed,
as it is without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

#: Bounds: the JAX package's own on-chip log-mel bound
#: (scripts/verify_kernels_tpu.py) and bf16-vs-fp32 score drift bound
#: (tests/test_stft_kernel.py).
LOGMEL_Q99_BOUND = 5e-2
SCORE_DRIFT_BOUND = 5e-2
BATCH = 32
SEED = 1
TIMING_ITERS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


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


def kernel_phase(w24, fb24, hop24, eps, dev):
    """fused_logmel against fused_logmel_reference at the main path's
    shapes (v2.4 at batch 16 and 32), the v3.0 geometry, and a T below
    one frame tile."""
    import numpy as np
    import torch

    from birda_tpu_torch.ops import stft_conv

    rng = np.random.default_rng(SEED)
    w30 = torch.from_numpy(dft_weight(1024)).to(dev, torch.bfloat16)
    fb30 = torch.from_numpy(
        rng.uniform(0, 0.05, (513, 128)).astype(np.float32)).to(
            dev, torch.bfloat16)
    cases = [
        ("v24_b16", w24, fb24, hop24, 16, 144_000, True),
        ("v24_b32", w24, fb24, hop24, BATCH, 144_000, True),
        ("v30_b16", w30, fb30, 320, 16, 160_000, True),
        ("v24_short_t", w24, fb24, hop24, 2, 6_000, False),
    ]
    results = {}
    for name, w, fb, hop, b, s, timed in cases:
        x = torch.from_numpy(
            rng.normal(0, 0.1, (b, s)).astype(np.float32)).to(dev)
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
        rec = {"phase": "kernel", "kernel": "fused_logmel", "case": name,
               "shape": list(got.shape),
               "q99_abs_err": float(torch.quantile(err, 0.99)),
               "max_abs_err": float(err.max()),
               "q99_bound": LOGMEL_Q99_BOUND}
        check(rec["q99_abs_err"] < LOGMEL_Q99_BOUND,
              f"{name}: log-mel q99 error {rec['q99_abs_err']}")
        if timed:
            rec["ms"] = timed_ms(lambda: stft_conv.fused_logmel(
                x, w, fb, hop, eps, prepared=layout))
            rec["plain_ms"] = timed_ms(
                lambda: stft_conv.fused_logmel_reference(x, w, fb, hop, eps))
        emit(rec)
        results[name] = rec
    return results


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        return 1
    from birda_tpu_torch.api import analyze
    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.contracts import ModelFamily, contract_for
    from birda_tpu_torch.models.zoo import onnx_model, synthetic_labels
    from birda_tpu_torch.onnx import fullscale
    from birda_tpu_torch.onnx.lowering import lower
    from birda_tpu_torch.ops import _build, stft_conv

    dev = torch.device("cuda", 0)

    # -- 1. card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": time.perf_counter() - t0})

    with tempfile.TemporaryDirectory(prefix="birda-smoke-") as tmp:
        tmp = Path(tmp)
        os.environ["XDG_CACHE_HOME"] = str(tmp / "cache")
        os.environ["XDG_CONFIG_HOME"] = str(tmp / "config")
        t0 = time.perf_counter()
        graph = fullscale.cached_build(fullscale.BIRDNET_V24_SPEC, seed=SEED)
        onnx_path = tmp / "birdnet-v24-fullscale.onnx"
        onnx_path.write_bytes(graph.model_bytes)
        labels = synthetic_labels(graph.spec.num_classes)
        labels_path = tmp / "labels.txt"
        labels_path.write_text("\n".join(labels) + "\n")
        wavs = []
        for i, rate in enumerate((48_000, 44_100)):
            p = tmp / f"field_{rate}.wav"
            write_wav(p, recording(rate, 120.0, SEED + i), rate)
            wavs.append(p)
        emit({"phase": "fixtures", "graph": graph.spec.name,
              "params": graph.param_count, "macs_per_segment": graph.macs,
              "wavs": [p.name for p in wavs],
              "seconds": time.perf_counter() - t0})

        # -- 2. kernels against their plain versions ----------------------
        fn = lower(graph.model_bytes, compute_dtype=torch.bfloat16)
        node = next(n for n in fn.graph.nodes
                    if n.op_type == "BirdaFusedMelFrontend")
        w24 = torch.tensor(fn.params[node.inputs[1]][:, 0, :]).to(
            dev, torch.bfloat16)
        fb24 = torch.tensor(fn.params[node.inputs[2]]).to(
            dev, torch.bfloat16)
        kernels = kernel_phase(w24, fb24, node.attr("hop"),
                               node.attr("eps"), dev)
        del fn

        # -- 3. the main path ----------------------------------------------
        stft_conv.LAUNCHES.clear()
        t0 = time.perf_counter()
        result = analyze(wavs, model_path=onnx_path, labels_path=labels_path,
                         model_type="birdnet-v24", device="gpu",
                         precision="bf16", batch_size=BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(stft_conv.LAUNCHES)
        summary = result.summary or {}
        rec = {"phase": "main_path", "backend": result.backend,
               "exit_code": result.exit_code, "launches": launches,
               "files": [{"file": f.path.name, "detections":
                          len(f.detections), "error": f.error}
                         for f in result.files],
               "segments": summary.get("total_segments"),
               "pipeline_ms": summary.get("duration_ms"),
               "wall_s_with_load": wall}
        if summary.get("duration_ms"):
            rec["segments_per_s"] = (summary["total_segments"]
                                     / (summary["duration_ms"] / 1000))
            rec["realtime_factor"] = summary["realtime_factor"]
        emit(rec)
        check(result.exit_code == 0, "analyze exit code")
        check((result.backend or {}).get("actual") == "cuda",
              f"backend {result.backend}")
        check(launches.get("fused_logmel", 0) > 0,
              "the main path never launched fused_logmel")
        check(len(result.files) == 2 and all(
            f.ok and f.detections for f in result.files),
              "detections for both files")
        check(all(0.0 <= d.confidence <= 1.0 and np.isfinite(d.confidence)
                  for d in result.detections), "confidences in [0, 1]")

        # -- 4. bf16 (kernel) against fp32 (plain route, TF32 off) ---------
        contract = contract_for(ModelFamily.BIRDNET_V24)
        n = contract.num_classes
        seg = contract.sample_count
        with wave.open(str(wavs[0])) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        chunk = pcm[:(BATCH - 1) * seg + seg].astype(np.float32) / 32767.0
        scores = {}
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
            del clf, model
        drift = float(np.abs(scores["bf16"] - scores["fp32"]).max())
        same_top1 = float(np.mean(scores["bf16"].argmax(1)
                                  == scores["fp32"].argmax(1)))
        emit({"phase": "bf16_vs_fp32", "rows": BATCH, "classes": n,
              "max_score_drift": drift, "bound": SCORE_DRIFT_BOUND,
              "top1_agreement": same_top1})
        check(np.isfinite(drift) and drift <= SCORE_DRIFT_BOUND,
              f"bf16 score drift {drift}")

    main_case = kernels["v24_b32"]
    emit({"kernels": [{
        "name": "fused_logmel", "route": "cuda",
        "source": "birda_tpu_torch/csrc/fused_logmel.cu",
        "replaces": "birda_tpu/ops/stft_conv.py:241",
        "launches": launches.get("fused_logmel", 0),
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
