#!/usr/bin/env python3
"""How far the PyTorch port and the JAX package stand apart on Perch v2's
QDQ form (``chip_smoke.qdq_graph`` on the tiny spec), end to end, on the CPU.

For each seeded input: the largest score difference over the top score
between the two packages in fp32 and in bf16 (the JAX package's
Conv1d-STFT Pallas kernel in interpret mode), the JAX package's own bf16
against its fp32, and how many QuantizeLinear outputs differ between the two
packages in fp32 (a value within rounding of a quantization boundary, one
step apart, propagates). Prints one JSON line per seed.

    JAX_PLATFORMS=cpu python scripts/torch_qdq_parity.py [SEEDS...]
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
os.environ.setdefault("BIRDA_STFT_KERNEL", "pallas")


def main(argv):
    import numpy as np

    from birda_tpu_torch.onnx.proto import load_model
    from torch_jax_parity import (row_rel_err, run_jax, run_port, signal,
                                  tiny_qdq_perch)

    g, qdq = tiny_qdq_perch()
    quantized = [n.outputs[0] for n in load_model(qdq).graph.nodes
                 if n.op_type == "QuantizeLinear"]
    for seed in [int(a) for a in argv] or [1, 2, 3, 4]:
        x = signal(g, seed)
        (jf, _), jd = run_jax(qdq, [x], keep_values=True)
        (tf, _), td = run_port(qdq, [x], keep_values=True)
        (jb, _), _ = run_jax(qdq, [x], bf16=True)
        (tb, _), _ = run_port(qdq, [x], bf16=True)
        flips = sum(int(np.sum(td[n][2] != jd[n][2])) for n in quantized)
        print(json.dumps({
            "seed": seed,
            "fp32_port_vs_jax": row_rel_err(tf, jf),
            "bf16_port_vs_jax": row_rel_err(tb, jb),
            "jax_bf16_vs_jax_fp32": row_rel_err(jb, jf),
            "fp32_quantize_flips": flips,
            "bf16_same_argmax": bool(np.array_equal(
                np.asarray(tb.float()).argmax(-1),
                np.asarray(jb, np.float32).argmax(-1)))}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
