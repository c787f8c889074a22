#!/usr/bin/env python3
"""Time the port's spectrogram kernels in several checkouts, in turns, on one
CUDA card: an A/B of two versions of ``birda_tpu_torch/csrc``.

    python3 scripts/torch_kernel_ab.py OLD NEW NEW OLD [--json FILE]

Each argument is an arm: the root of a checkout, whose ``birda_tpu_torch``
is imported from there, in a process of its own. Every arm times the same
cases with the same inputs, made from one seed:

- ``fused_logmel`` at BirdNET v2.4 (K 2048, hop 278, 192 mels) at batch 32
  and 64;
- ``conv1d_stft`` at Perch v2's framer (K 640, hop 320, C 640) at batch 32,
  random weight.

A time is device time per call: a sleep kernel first lets the host queue
``REPS`` calls, which then run back to back between two CUDA events (so the
wrapper's host overhead is not counted); the median of ``ROUNDS`` such
windows. Prints one JSON line per arm and case, and the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPS = 20
ROUNDS = 7
SEED = 1

CHILD = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
from birda_tpu_torch.ops import _build, stft_conv
REPS, ROUNDS, SEED = {reps}, {rounds}, {seed}
dev = torch.device("cuda", 0)


def device_ms(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        torch.cuda._sleep(50_000_000)  # the host queues the calls meanwhile
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    times.sort()
    return times[len(times) // 2]


def dft_weight(n_fft):
    bins = n_fft // 2 + 1
    n = np.arange(n_fft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft)
    ang = 2 * np.pi * np.arange(bins)[:, None] * n[None, :] / n_fft
    return np.concatenate([np.cos(ang) * win, -np.sin(ang) * win]) \
        .astype(np.float32)


rng = np.random.default_rng(SEED)
w24 = torch.from_numpy(dft_weight(2048)).to(dev, torch.bfloat16)
fb24 = torch.from_numpy(rng.uniform(0, 0.05, (1025, 192)).astype(np.float32)
                        ).to(dev, torch.bfloat16)
lay24 = stft_conv.prepare_logmel_weights(w24, fb24)
for b in (32, 64):
    x = torch.from_numpy(rng.normal(0, 0.1, (b, 144_000)).astype(np.float32)
                         ).to(dev)
    got = stft_conv.fused_logmel(x, w24, fb24, 278, 1e-6, prepared=lay24)
    want = stft_conv.fused_logmel_reference(x, w24, fb24, 278, 1e-6)
    err = (got.float() - want.float()).abs().flatten()
    print(json.dumps({{"case": f"fused_logmel_v24_b{{b}}",
                      "ms": device_ms(lambda: stft_conv.fused_logmel(
                          x, w24, fb24, 278, 1e-6, prepared=lay24)),
                      "q99_abs_err": float(torch.quantile(err, 0.99)),
                      "max_abs_err": float(err.max())}}), flush=True)
x = torch.from_numpy(rng.normal(0, 0.1, (32, 160_000)).astype(np.float32)
                     ).to(dev)
w = torch.from_numpy(rng.normal(0, 0.02, (640, 640)).astype(np.float32)
                     ).to(dev)
layc = stft_conv.prepare_conv1d_weights(w)
got = stft_conv.conv1d_stft(x, w, 320, prepared=layc)
want = stft_conv.conv1d_stft_reference(x, w, 320)
err = float((got.float() - want.float()).abs().max())
print(json.dumps({{"case": "conv1d_stft_perch_b32",
                  "ms": device_ms(lambda: stft_conv.conv1d_stft(
                      x, w, 320, prepared=layc)),
                  "max_abs_err": err,
                  "rel_err": err / float(want.float().abs().max())}}),
      flush=True)
for name in _build.SOURCES:
    report = getattr(_build, "report_path", None)
    report = report(name) if report else None
    if report is not None and report.exists():
        lines = [ln.strip() for ln in report.read_text().splitlines()
                 if any(w in ln for w in ("Used", "spill", "Performance"))]
        print(json.dumps({{"ptxas": name, "lines": lines}}), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arms", nargs="+", help="root of a checkout")
    ap.add_argument("--json", help="also append every record to this file")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    code = CHILD.format(reps=REPS, rounds=ROUNDS, seed=SEED)
    failed = 0
    for turn, arm in enumerate(args.arms):
        r = subprocess.run([sys.executable, "-c", code],
                           cwd=os.path.abspath(arm), capture_output=True,
                           text=True, timeout=args.timeout)
        for line in r.stdout.splitlines():
            rec = {"turn": turn, "arm": arm, "card": smi, **json.loads(line)}
            print(json.dumps(rec), flush=True)
            if args.json:
                with open(args.json, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        if r.returncode != 0:
            failed += 1
            print(json.dumps({"turn": turn, "arm": arm, "error":
                              r.stderr[-2000:]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
