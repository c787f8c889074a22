#!/usr/bin/env python3
"""One-command acceptance rehearsal for a real model asset on the
PyTorch/CUDA port: the counterpart of ``scripts/accept_asset.py``.

    python3 scripts/torch_accept_asset.py MODEL.onnx LABELS.txt \\
        [--reference scores.npz] [--sample-rate 48000] [--cpu] \\
        [--skip-int8] [--skip-bench] [--json report.json]

Run it from the root of a checkout. It runs on the CUDA card unless
``--cpu`` is given (give the command a time limit of its own on the card:
the kernels' ring barriers spin without a timeout). Each gate prints
PASS/WARN/FAIL/SKIP; the exit code is 1 iff any gate FAILs:

1. **load** — wire-format parse (external-data sidecars resolve).
2. **preflight** — every unsupported op/attr/dtype reported at once
   (``birda_tpu_torch/onnx/preflight.py``).
3. **labels** — label count == the graph's class width (one row through
   the fp32 lowering).
4. **fusion** — does the mel-front-end fusion engage on these bytes?
   WARN-only: a chain that does not fuse still runs node by node.
5. **parity** — fp32 scores vs the recorded reference (``inputs`` and
   ``scores`` of an npz, ``scripts/record_parity_reference.py``), budget
   1e-3. On divergence with ``node:<tensor>`` recordings it names the
   first diverging node (``birda_tpu_torch/onnx/parity.py``). SKIP when no
   reference is given.
6. **int8** — the recall acceptance protocol
   (``birda_tpu_torch/onnx/int8_accuracy.py::evaluate_model``): drift,
   top-1/top-5 agreement and threshold crossings against the documented
   criteria, on 64 eval rows.
7. **bench** — segments/s of the bf16 lowering (the front-end kernels
   on the card, where the JAX script benches fp32 on its backend) at the
   parity batch, with the card's name and power limit.

One deliberate difference from ``scripts/accept_asset.py``: the int8
gate calibrates on rows drawn apart from its eval rows (the same signal
family under another seed), where the JAX script self-calibrates on the
first 16 eval rows, which makes the eval rows their own calibration set
and flatters the drift. It imports no jax and nothing of ``birda_tpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PARITY_TOLERANCE = 1e-3
#: Seeds of the int8 gate's eval rows (as in scripts/accept_asset.py) and
#: of its calibration rows, drawn apart from them.
EVAL_SEED = 7
CALIBRATION_SEED = 8
CALIBRATION_ROWS = 16


class Gate:
    def __init__(self):
        self.results: list[dict] = []

    def add(self, name: str, status: str, detail: str = "") -> None:
        self.results.append(
            {"gate": name, "status": status, "detail": detail})
        line = f"[{status:<4}] {name}"
        if detail:
            line += f": {detail}"
        print(line, flush=True)

    @property
    def failed(self) -> bool:
        return any(r["status"] == "FAIL" for r in self.results)


def _input_spec(model):
    """(name, shape with symbolic batch -> 8) of the first graph input
    without initializer bytes."""
    inp = next(i for i in model.graph.inputs
               if i.name not in model.graph.initializers)
    shape = []
    for i, d in enumerate(inp.shape):
        if isinstance(d, int) and d > 0:
            shape.append(d)
        else:
            shape.append(8 if i == 0 else 1)
    return inp.name, tuple(shape)


def int8_rows(in_shape) -> tuple[np.ndarray, list[np.ndarray]]:
    """The int8 gate's 64 eval rows and its calibration rows, apart from
    them: the calibration-signal family (pink noise and chirps) for a
    ``[B, samples]`` input, random normal otherwise, each under its own
    seed."""
    if len(in_shape) == 2:
        from birda_tpu_torch.onnx.quantize import calibration_signals

        eval_in = np.concatenate(list(calibration_signals(
            in_shape[-1], batch=16, n_batches=4, seed=EVAL_SEED)))
        calib = list(calibration_signals(
            in_shape[-1], batch=CALIBRATION_ROWS, n_batches=1,
            seed=CALIBRATION_SEED))
    else:
        eval_in = np.random.default_rng(EVAL_SEED).normal(
            0, 0.1, (64,) + in_shape[1:]).astype(np.float32)
        calib = [np.random.default_rng(CALIBRATION_SEED).normal(
            0, 0.1, (CALIBRATION_ROWS,) + in_shape[1:]).astype(np.float32)]
    return eval_in, calib


def _scores_of(out):
    return out[0] if isinstance(out, tuple) else out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", help="classifier ONNX file")
    ap.add_argument("labels", help="labels file (one per line)")
    ap.add_argument("--reference", default=None,
                    help="recorded reference scores .npz (inputs, scores, "
                         "optionally node:<tensor> activations)")
    ap.add_argument("--sample-rate", type=int, default=48_000,
                    help="model sample rate (for the x-realtime number)")
    ap.add_argument("--cpu", action="store_true",
                    help="run every gate on the CPU")
    ap.add_argument("--skip-int8", action="store_true")
    ap.add_argument("--skip-bench", action="store_true")
    ap.add_argument("--bench-iters", type=int, default=4)
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the gate results as JSON")
    args = ap.parse_args(argv)

    import torch

    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        print("torch_accept_asset: no CUDA device (pass --cpu to run on "
              "the CPU)", file=sys.stderr)
        return 2
    gate = Gate()

    # 1. load -----------------------------------------------------------
    from birda_tpu_torch.onnx.proto import load_model

    try:
        model_bytes = Path(args.model).read_bytes()
        model = load_model(args.model)  # path form resolves external data
        n_params = sum(
            t.array.size for t in model.graph.initializers.values())
        gate.add("load", "PASS",
                 f"{len(model.graph.nodes)} nodes, opset "
                 f"{model.opset}, {n_params:,} params")
    except Exception as e:  # noqa: BLE001 — report, don't crash
        gate.add("load", "FAIL", f"{type(e).__name__}: {e}")
        return _finish(gate, args)

    # 2. preflight --------------------------------------------------------
    from birda_tpu_torch.onnx.preflight import preflight

    findings = preflight(model)
    if findings:
        gate.add("preflight", "FAIL",
                 f"{len(findings)} unsupported construct(s): "
                 + "; ".join(f.render() for f in findings[:5])
                 + ("; ..." if len(findings) > 5 else ""))
        return _finish(gate, args)
    gate.add("preflight", "PASS", "every op/attr/dtype supported")

    # 3. labels + lowering -------------------------------------------------
    from birda_tpu_torch.models.zoo import params_from_numpy
    from birda_tpu_torch.onnx.lowering import lower

    labels = [
        ln for ln in Path(args.labels).read_text().splitlines() if ln.strip()
    ]
    try:
        fn = lower(model_bytes)
        params = params_from_numpy(fn.params, dev)
        _, in_shape = _input_spec(model)
        with torch.inference_mode():
            row = _scores_of(fn(torch.zeros((1,) + in_shape[1:],
                                            device=dev), params=params))
        num_classes = int(row.shape[-1])
    except Exception as e:  # noqa: BLE001
        gate.add("labels", "FAIL", f"lowering failed: "
                                   f"{type(e).__name__}: {e}")
        return _finish(gate, args)
    if len(labels) != num_classes:
        gate.add("labels", "FAIL",
                 f"{len(labels)} labels != {num_classes} classes")
        return _finish(gate, args)
    gate.add("labels", "PASS", f"{num_classes} classes")

    # 4. fusion engagement --------------------------------------------------
    from birda_tpu_torch.onnx.fuse import fuse_mel_frontend

    fused = fuse_mel_frontend(load_model(model_bytes).graph)
    if fused:
        gate.add("fusion", "PASS",
                 f"mel front-end fusion engaged ({fused} chain(s))")
    else:
        gate.add("fusion", "WARN",
                 "front-end fusion did not engage (node-by-node execution "
                 "is correct but slower)")

    # 5. fp32 parity ---------------------------------------------------------
    if args.reference:
        ref = np.load(args.reference)
        inputs = np.asarray(ref["inputs"], np.float32)
        want = np.asarray(ref["scores"], np.float32)
        with torch.inference_mode():
            got = _scores_of(fn(torch.from_numpy(inputs).to(dev),
                                params=params)).float().cpu().numpy()
        max_err = float(np.max(np.abs(got - want)))
        if max_err < PARITY_TOLERANCE:
            gate.add("parity", "PASS",
                     f"max |Δ| = {max_err:.2e} (budget {PARITY_TOLERANCE})")
        else:
            from birda_tpu_torch.onnx.parity import (
                find_first_divergence,
                node_records,
            )

            detail = f"max |Δ| = {max_err:.2e} over {PARITY_TOLERANCE}"
            recorded = node_records(ref)
            if recorded:
                rows = (int(ref["node_input_rows"])
                        if "node_input_rows" in ref.files else 1)
                div = find_first_divergence(
                    fn, inputs[:rows], recorded, tol=PARITY_TOLERANCE,
                    params=params, device=dev.type)
                if div is not None:
                    detail += f"; {div.render()}"
            else:
                detail += ("; re-record with --record-nodes to bisect to "
                           "the first diverging op")
            gate.add("parity", "FAIL", detail)
    else:
        inputs = np.random.default_rng(20260816).normal(
            0, 0.1, in_shape).astype(np.float32)
        gate.add("parity", "SKIP",
                 "no --reference given; record one with "
                 "scripts/record_parity_reference.py on an "
                 "onnxruntime-equipped machine")

    # 6. int8 recall acceptance ----------------------------------------------
    if args.skip_int8:
        gate.add("int8", "SKIP", "--skip-int8")
    else:
        try:
            from birda_tpu_torch.onnx.int8_accuracy import (
                Criteria,
                evaluate_model,
            )

            eval_in, calib = int8_rows(in_shape)
            report = evaluate_model(
                model_bytes, torch.from_numpy(eval_in).to(dev),
                calibration_batches=[torch.from_numpy(c).to(dev)
                                     for c in calib])
            fails = report.failures(Criteria())
            detail = (f"max |Δ| {report.max_abs_delta:.4f}, top-1 "
                      f"agreement {report.top1_agreement:.3f} "
                      f"({len(eval_in)} samples, calibrated on "
                      f"{sum(len(c) for c in calib)} other rows)")
            if fails:
                gate.add("int8", "FAIL", "; ".join(fails) + f" ({detail})")
            else:
                gate.add("int8", "PASS", detail)
        except Exception as e:  # noqa: BLE001
            gate.add("int8", "FAIL", f"{type(e).__name__}: {e}")

    # 7. bench point ---------------------------------------------------------
    if args.skip_bench:
        gate.add("bench", "SKIP", "--skip-bench")
    else:
        try:
            gate.add("bench", "PASS", _bench(args, model_bytes, inputs, dev))
        except Exception as e:  # noqa: BLE001
            gate.add("bench", "FAIL", f"{type(e).__name__}: {e}")

    return _finish(gate, args)


def _bench(args, model_bytes: bytes, inputs: np.ndarray, dev) -> str:
    """Segments/s at the parity batch: fresh inputs per step, every step's
    scores summed on the device and read once at the end."""
    import torch

    from birda_tpu_torch.models.zoo import params_from_numpy
    from birda_tpu_torch.onnx.lowering import lower
    from birda_tpu_torch.ops import stft_conv

    fn = lower(model_bytes, compute_dtype=torch.bfloat16)
    params = params_from_numpy(fn.params, dev, torch.bfloat16)
    fn.prepare(params)
    xs = torch.from_numpy(np.random.default_rng(11).normal(
        0, 0.1, (args.bench_iters + 1,) + inputs.shape).astype(
            np.float32)).to(dev)

    def step(x):
        return _scores_of(fn(x, params=params)).float().sum()

    launches = dict(stft_conv.LAUNCHES)
    with torch.inference_mode():
        step(xs[0]).item()  # warm: kernel builds, weight layouts
        t0 = time.perf_counter()
        total = sum(step(x) for x in xs[1:])
        total.item()
        dt = time.perf_counter() - t0
    fired = {k: v - launches.get(k, 0) for k, v in stft_conv.LAUNCHES.items()
             if v != launches.get(k, 0)}
    seg_per_sec = inputs.shape[0] * args.bench_iters / dt
    seconds_per_segment = inputs.shape[-1] / args.sample_rate
    if dev.type == "cuda":
        from birda_tpu_torch.inference.backend import card_line

        where = card_line()
    else:
        where = "cpu"
    return (f"{seg_per_sec:,.1f} segments/s = "
            f"{seg_per_sec * seconds_per_segment:,.1f}x realtime "
            f"(batch {inputs.shape[0]}, bf16, {where}, "
            f"kernel launches {fired})")


def _finish(gate: Gate, args) -> int:
    summary = {
        "asset": args.model,
        "accepted": not gate.failed,
        "gates": gate.results,
    }
    print(json.dumps({
        "accepted": summary["accepted"],
        "gates": {r["gate"]: r["status"] for r in gate.results},
    }))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(summary, indent=1))
    return 1 if gate.failed else 0


if __name__ == "__main__":
    sys.exit(main())
