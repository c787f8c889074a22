"""Device timing, the device's busy time over a window of steps, and the
card's least time for a piece of work: what the port's tools
(``scripts/verify_kernels_cuda.py``, ``scripts/torch_accept_asset.py``,
``scripts/torch_bench.py``) and ``chip_smoke.py`` report beside each
kernel's or step's time.
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


def profile_steps(step, steps: int, top: int = 8) -> dict:
    """Run ``step()`` ``steps`` times under ``torch.profiler`` on a warm
    card: the device's busy time per step (the union of the kernels'
    spans, so overlapping kernels count once), the kernels launched per
    step and the ``top`` kernels that take the most device time, by name
    (cut to 80 characters), in ms per step. On the CPU no kernel is
    traced: busy time and launches are 0."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        if torch.cuda.is_available():
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
    return {"device_busy_ms_per_step": busy_us / steps / 1e3,
            "kernels_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [
                [name, us / steps / 1e3]
                for name, us in by_name.most_common(top)]}


def idle_share(busy_ms: float, step_ms: float):
    """The share of a step's host-clock time in which the device ran no
    kernel; None where no kernel was traced."""
    return (1 - busy_ms / step_ms) if busy_ms else None
