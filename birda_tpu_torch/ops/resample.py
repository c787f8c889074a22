"""Device resampler: the PyTorch port of ``birda_tpu/ops/resample.py``.

Same plan, same filter, same two forms as the JAX module, whose jax-free
design code (:func:`get_plan`, :func:`_design_lowpass`, :func:`_design_len`)
is imported as it is:

- :func:`_device_fn`: upsample-filter-decimate as one strided convolution
  over the L-dilated signal, for small ratios (48 kHz <-> 32 kHz);
- :func:`_device_fn_blocked`: any ratio as strided windows times one dense
  ``[W, L]`` matrix per L outputs (44.1 kHz -> 48 kHz).

Both accumulate in fp32 with TF32 off, so they match
:func:`birda_tpu.ops.resample.resample_numpy` to fp32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from birda_tpu.ops.resample import (
    MAX_DEVICE_RATIO,
    _design_len,
    _design_lowpass,
    get_plan,
)


class _Constant:
    """A numpy constant with one tensor copy per device."""

    def __init__(self, array: np.ndarray):
        self._array = np.ascontiguousarray(array, np.float32)
        self._by_device: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._by_device.get(device)
        if t is None:
            t = self._by_device[device] = torch.from_numpy(
                self._array).to(device)
        return t


@functools.lru_cache(maxsize=64)
def _device_fn(from_rate: int, to_rate: int, in_len: int):
    """``[batch, in_len] -> [batch, out_len]`` as one strided convolution of
    the L-dilated input with the reversed filter (``y[n] = sum_j h[j] *
    u[n*M + c - j]``), the JAX form's ``lhs_dilation=L, stride=M``."""
    plan = get_plan(from_rate, to_rate)
    if plan.identity:
        return lambda x: x
    h = _design_lowpass(plan.L, plan.M)
    k = len(h)
    c = (k - 1) // 2
    n_out = plan.out_len(in_len)
    kernel = _Constant(h[::-1][None, None, :])
    pad_lo = k - 1 - c
    dilated_len = (in_len - 1) * plan.L + 1
    need = (n_out - 1) * plan.M + k
    pad_hi = max(0, need - dilated_len - pad_lo)

    def fn(x: torch.Tensor) -> torch.Tensor:
        u = x.new_zeros((x.shape[0], 1, pad_lo + dilated_len + pad_hi),
                        dtype=torch.float32)
        u[:, 0, pad_lo:pad_lo + dilated_len:plan.L] = x
        with torch.backends.cudnn.flags(allow_tf32=False):
            out = F.conv1d(u, kernel.on(x.device), stride=plan.M)
        return out[:, 0, :n_out]

    return fn


@functools.lru_cache(maxsize=64)
def _device_fn_blocked(from_rate: int, to_rate: int, in_len: int):
    """Any-ratio resampler as strided windows and one matmul:
    ``frames[j, w] = x[j*M + o_min + w]``, ``y[j*L + r] = sum_w
    frames[j, w] * G[w, r]`` — the JAX form's gather becomes an
    ``unfold`` view."""
    plan = get_plan(from_rate, to_rate)
    if plan.identity:
        return lambda x: x
    L, M, T = plan.L, plan.M, plan.T
    k = _design_len(L, M)
    c = (k - 1) // 2
    n_out = plan.out_len(in_len)
    n_blocks = -(-n_out // L)

    r = np.arange(L, dtype=np.int64)
    beta = (r * M + c) // L
    phase = (r * M + c) % L
    o_min = int(beta.min()) - (T - 1)
    W = int(beta.max()) - o_min + 1
    g = np.zeros((W, L), np.float32)
    t = np.arange(T, dtype=np.int64)
    for rr in range(L):
        g[beta[rr] - t - o_min, rr] = plan.H[phase[rr], :]
    G = _Constant(g)

    pad_lo = max(0, -o_min)
    last = (n_blocks - 1) * M + o_min + W - 1
    pad_hi = max(0, last - (in_len - 1))
    shift = o_min + pad_lo

    def fn(x: torch.Tensor) -> torch.Tensor:
        xp = F.pad(x.float(), (pad_lo, pad_hi))
        frames = xp[:, shift:].unfold(-1, W, M)[:, :n_blocks]  # [B, nb, W]
        y = torch.matmul(frames, G.on(x.device))
        return y.reshape(x.shape[0], n_blocks * L)[:, :n_out]

    return fn


def resample_device(x: torch.Tensor, from_rate: int, to_rate: int
                    ) -> torch.Tensor:
    """Resample ``[batch, N]`` float32 on ``x``'s device."""
    plan = get_plan(int(from_rate), int(to_rate))
    if max(plan.L, plan.M) <= MAX_DEVICE_RATIO:
        return _device_fn(int(from_rate), int(to_rate), int(x.shape[-1]))(x)
    return _device_fn_blocked(int(from_rate), int(to_rate),
                              int(x.shape[-1]))(x)
