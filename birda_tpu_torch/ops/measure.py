"""Device timing and the card's least time for a piece of work: what the
port's tools (``scripts/verify_kernels_cuda.py``,
``scripts/torch_accept_asset.py``) and ``chip_smoke.py`` report beside
each kernel's time.
"""

from __future__ import annotations

#: Calls of one timing window, and windows whose median is reported.
TIMING_REPS = 20
TIMING_ROUNDS = 7

#: One NVIDIA H100 SXM, from its published specification: HBM bytes per
#: second and dense bf16 tensor-core operations per second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


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
