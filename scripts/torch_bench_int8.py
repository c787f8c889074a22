#!/usr/bin/env python3
"""The int8 execution mode against bf16 on the CUDA card: the counterpart of
``scripts/bench_int8.py``, through the port's measuring functions
(``scripts/torch_bench.py``).

    timeout 1500 python3 scripts/torch_bench_int8.py [family ...] \\
        [--batch N] [--iters 6] [--repeats 5] [--budget S] [--device auto|cpu]

Families default to ``birdnet-v24``. Each family's full-scale graph runs
once in bf16 and once in calibrated int8 (its ops outside the quantized
set in bf16, as ``--precision int8`` runs them on the card), at the port's
CUDA default batch unless ``--batch`` is given, each measured and checked
as ``torch_bench.py`` measures and checks it (timed windows, launches,
drift against the card's fp32 run). The record of each family carries
``bench_int8.py``'s keys: both realtime factors and their ratio, the
number of quantized nodes, the largest score difference between the two
modes and their top-1 agreement on the built-in calibration signals
(``calibration_signals(..., seed=123)``, 8 rows) and the bytes of each
mode's parameters on the card; beside them the card's name and power
limit and both measurements' records. One line per family, then one line
of all of them. The device and failure contract is ``torch_bench.py``'s.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_bench as tb  # noqa: E402  (the port's measuring functions)

PROBE_SEED = 123
PROBE_ROWS = 8


def family_record(family: str, args, dev, card: str, run_) -> dict:
    """One family's record. As in the JAX script, the two modes' drift on
    the probe rows comes first; it is kept in ``run_`` before the timed
    measurements, whose checks may end the run."""
    import torch

    from birda_tpu_torch.onnx.quantize import calibration_signals

    preps = {p: tb.prepare(family, p, dev) for p in ("bf16", "int8")}
    probe = next(calibration_signals(preps["int8"].spec.sample_count,
                                     batch=PROBE_ROWS, n_batches=1,
                                     seed=PROBE_SEED))
    with torch.inference_mode():
        x = torch.from_numpy(probe).to(dev)
        sq = preps["int8"].scores(x).cpu().numpy()
        sf = preps["bf16"].scores(x).cpu().numpy()
    drift = {"quantized_nodes": preps["int8"].quantized_nodes,
             "max_score_drift_vs_bf16": float(np.max(np.abs(sq - sf))),
             "top1_agree": float(np.mean(sq.argmax(-1) == sf.argmax(-1)))}
    run_.record(family, drift)
    recs = {p: tb.measure(prep, args.batch or tb.default_batch(family, dev),
                          args.iters, args.repeats, args.seed, dev)
            for p, prep in preps.items()}
    rt_q, rt_f = recs["int8"]["x_realtime"], recs["bf16"]["x_realtime"]
    return {
        "bf16_x_realtime": rt_f,
        "int8_x_realtime": rt_q,
        "speedup": rt_q / rt_f,
        **drift,
        "param_bytes_int8": preps["int8"].param_bytes,
        "param_bytes_bf16": preps["bf16"].param_bytes,
        "card": card,
        "measurements": recs,
    }


def main(argv=None) -> int:
    ap = tb.common_parser(__doc__.splitlines()[0])
    ap.add_argument("families", nargs="*", default=["birdnet-v24"])
    args = ap.parse_args(argv)
    budget = tb.budget_default() if args.budget is None else args.budget
    out = {}
    with tb.Run(budget) as run_:
        dev = tb.resolve_device(args.device)
        card = tb.card_of(dev)
        run_.record("card", card)
        tb.build_kernels(dev)
        for fam in args.families:
            run_.check_deadline()
            out[fam] = family_record(fam, args, dev, card, run_)
            run_.record(fam, out[fam])
            print(json.dumps({fam: out[fam]}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
