#!/usr/bin/env python3
"""The int8 (or mixed) batch optimum per model family on the CUDA card: the
counterpart of ``scripts/sweep_int8_batch.py``, through the port's
measuring functions (``scripts/torch_bench.py``).

    BATCHES=32,64,128 STORAGE_ONLY=1 timeout 1500 \\
        python3 scripts/torch_sweep_int8_batch.py [family ...] \\
        [--iters 6] [--repeats 5] [--budget S] [--device auto|cpu]

Families default to ``perch-v2 birdnet-v30``. ``BATCHES`` overrides the
grid, by default ``32,64,128,256,512`` on the card (the JAX script's grid
is a TPU's) and ``8,16`` on the CPU. ``STORAGE_ONLY=1`` sweeps
``--precision mixed`` (bf16 compute and calibrated int8 storage of the
large boundary streams) instead of int8. Each family is built, lowered and
calibrated once; each batch is measured and checked as ``torch_bench.py``
measures and checks it. One line per family and batch (``x_realtime`` of
the median window, beside the spread, busy and idle share, launches, drift
and peak memory), then a line with the argmax per family. Running out of
device memory at a batch is that point's result (``"oom": true``); any
other error fails the run, under ``torch_bench.py``'s device and failure
contract. Every line names the card and its power limit.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_bench as tb  # noqa: E402  (the port's measuring functions)

CARD_GRID = "32,64,128,256,512"
CPU_GRID = "8,16"
POINT_KEYS = ("x_realtime_min", "x_realtime_max", "step_ms",
              "device_busy_ms_per_step", "device_idle_share",
              "kernels_per_step", "launches", "drift", "top1_agree",
              "peak_device_memory_bytes")


def main(argv=None) -> int:
    import torch

    ap = tb.common_parser(__doc__.splitlines()[0], batch=False)
    ap.add_argument("families", nargs="*", default=["perch-v2",
                                                    "birdnet-v30"])
    args = ap.parse_args(argv)
    budget = tb.budget_default() if args.budget is None else args.budget
    mode = "mixed" if os.environ.get("STORAGE_ONLY") else "int8"
    best = {}
    with tb.Run(budget) as run_:
        dev = tb.resolve_device(args.device)
        card = tb.card_of(dev)
        grid = [int(b) for b in os.environ.get(
            "BATCHES", CARD_GRID if dev.type == "cuda" else CPU_GRID
        ).split(",")]
        tb.build_kernels(dev)
        for fam in args.families:
            run_.check_deadline()
            prep = tb.prepare(fam, mode, dev)
            for batch in grid:
                run_.check_deadline()
                line = {"family": fam, "batch": batch, "mode": mode,
                        "card": card}
                try:
                    rec = tb.measure(prep, batch, args.iters, args.repeats,
                                     args.seed, dev)
                except torch.cuda.OutOfMemoryError as e:
                    line.update(oom=True, error=str(e).splitlines()[0])
                    torch.cuda.empty_cache()
                else:
                    line.update(x_realtime=rec["x_realtime"],
                                **{k: rec[k] for k in POINT_KEYS})
                    if rec["x_realtime"] > best.get(fam, (0, 0.0))[1]:
                        best[fam] = (batch, rec["x_realtime"])
                run_.record(f"{fam}@{batch}", line)
                print(json.dumps(line), flush=True)
            del prep
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        summary = {"best": {f: {"batch": b, "x_realtime": rt}
                            for f, (b, rt) in best.items()},
                   "mode": mode, "card": card}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
