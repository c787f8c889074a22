#!/usr/bin/env python3
"""How far the bf16 route moves the spectrogram transformer's scores from
fp32, in the JAX package and in the PyTorch port, on the same rows, on the
CPU.

The graph is ``tests/torch_seq_graphs.py``'s ``FULL`` (AST-base width:
hidden 768, 12 heads, MLP 3072, 588 tokens, 11,560 classes; random weights
from ``--seed``) at each depth of ``--layers``. The rows are the first
``--rows`` segments of ``chip_smoke.py``'s ``seq_chunk`` recording (the
same generator, seed and int16 round trip). For each depth it prints one
JSON line: the largest absolute score difference of each package's bf16
against its own fp32 (``jax_drift``, ``port_drift``), of the port against
the JAX package in fp32 and in bf16, top-1 agreement of each bf16 run with
its fp32, and the largest fp32 score. The JAX front end runs its Pallas
kernel in interpret mode on the bf16 route, the port's the kernel's plain
version.

    JAX_PLATFORMS=cpu python tests/torch_seq_drift.py --layers 1 2 4 --rows 4
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
os.environ.setdefault("BIRDA_STFT_KERNEL", "pallas")


def rows_of_seq_chunk(n: int):
    """The first ``n`` segments of ``seq_chunk``'s 160 s recording."""
    import chip_smoke as cs

    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "seq.wav"
        cs.write_wav(wav, cs.recording(32_000, 160.0, cs.SEED + 71), 32_000)
        x = cs.read_wav(wav)
    seg = 160_000
    return x[:n * seg].reshape(n, seg)


def drift(got, want) -> dict:
    import numpy as np

    return {"max_abs": float(np.abs(got - want).max()),
            "top1": float(np.mean(got.argmax(-1) == want.argmax(-1)))}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    import numpy as np
    import torch
    import torch_seq_graphs as sg

    from birda_tpu.onnx import lowering as jl

    from birda_tpu_torch.models import zoo
    from birda_tpu_torch.onnx import lowering as tl

    x = rows_of_seq_chunk(args.rows)
    for layers in args.layers:
        t0 = time.perf_counter()
        spec = dataclasses.replace(sg.FULL, layers=layers)
        mb = sg.build(spec, seed=args.seed).model_bytes
        out = {}
        for bf16 in (False, True):
            jfn = jl.lower(mb, compute_dtype=jnp.bfloat16 if bf16 else None)
            jp = jfn.params if not bf16 else {
                k: np.asarray(v, jnp.bfloat16) for k, v in jfn.params.items()}
            out["jax", bf16] = np.asarray(jfn(x, params=jp)[0], np.float32)
            del jfn, jp
            tfn = tl.lower(mb, compute_dtype=torch.bfloat16 if bf16 else None)
            tp = zoo.params_from_numpy(
                tfn.params, "cpu", torch.bfloat16 if bf16 else None)
            with torch.inference_mode():
                out["port", bf16] = tfn(torch.from_numpy(x), params=tp)[0] \
                    .float().numpy()
            del tfn, tp
        print(json.dumps({
            "layers": layers, "rows": args.rows, "hidden": spec.hidden,
            "jax_drift": drift(out["jax", True], out["jax", False]),
            "port_drift": drift(out["port", True], out["port", False]),
            "port_vs_jax_fp32": drift(out["port", False], out["jax", False]),
            "port_vs_jax_bf16": drift(out["port", True], out["jax", True]),
            "max_fp32_score": float(out["jax", False].max()),
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
