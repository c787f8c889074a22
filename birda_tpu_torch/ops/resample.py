"""Polyphase rational resampling: the PyTorch port of
``birda_tpu/ops/resample.py``.

The plan and filter design (:class:`ResamplePlan`, :func:`get_plan`) and the
host path (:func:`resample_numpy`, used by the decoders through
:mod:`birda_tpu_torch.audio.resample`) are the JAX module's numpy code,
copied as it is. The device resampler has the JAX module's two forms:

- :func:`_device_fn`: upsample-filter-decimate as one strided convolution
  over the L-dilated signal, for small ratios (48 kHz <-> 32 kHz);
- :func:`_device_fn_blocked`: any ratio as strided windows times one dense
  ``[W, L]`` matrix per L outputs (44.1 kHz -> 48 kHz).

Both accumulate in fp32 with TF32 off, so they match
:func:`resample_numpy` to fp32 rounding.

Math: for target/source ratio reduced to L/M, upsample-by-L -> lowpass ->
downsample-by-M collapses to

    y[n] = sum_t H[p_n, t] * x[b_n - t],   q = n*M + (K-1)/2,
    p_n = q mod L,  b_n = q div L,         H[p, t] = h[p + t*L]

with h a Kaiser-windowed sinc (cutoff ``1/max(L,M)`` of the upsampled
Nyquist, gain L).
"""

from __future__ import annotations

import functools
from math import ceil, gcd

import numpy as np
import torch
import torch.nn.functional as F

#: Filter half-length in units of max(L, M) — larger = sharper transition.
HALF_LEN_MULT = 12
#: Kaiser window beta — ~100 dB stopband at this length.
KAISER_BETA = 10.0


class ResamplePlan:
    """Precomputed polyphase plan for one (from_rate, to_rate) pair."""

    __slots__ = ("from_rate", "to_rate", "L", "M", "H", "T", "identity")

    def __init__(self, from_rate: int, to_rate: int):
        self.from_rate = int(from_rate)
        self.to_rate = int(to_rate)
        self.identity = from_rate == to_rate
        if self.identity:
            self.L = self.M = 1
            self.T = 0
            self.H = np.zeros((1, 1), np.float32)
            return
        g = gcd(self.from_rate, self.to_rate)
        self.L = self.to_rate // g
        self.M = self.from_rate // g
        h = _design_lowpass(self.L, self.M)
        K = len(h)
        self.T = ceil(K / self.L)
        hp = np.zeros(self.T * self.L, np.float64)
        hp[:K] = h
        # H[p, t] = h[p + t*L]
        self.H = hp.reshape(self.T, self.L).T.astype(np.float32).copy()

    def out_len(self, in_len: int) -> int:
        if self.identity:
            return in_len
        return ceil(in_len * self.L / self.M)

    def indices(self, in_len: int) -> tuple[np.ndarray, np.ndarray]:
        """(phase, base) index vectors for an input of ``in_len`` samples."""
        n = np.arange(self.out_len(in_len), dtype=np.int64)
        # Offset by the true filter centre (not the zero-padded length) so the
        # output is zero-phase.
        K = _design_len(self.L, self.M)
        q = n * self.M + (K - 1) // 2
        return (q % self.L).astype(np.int32), (q // self.L).astype(np.int32)


def _design_len(L: int, M: int) -> int:
    return 2 * HALF_LEN_MULT * max(L, M) + 1


@functools.lru_cache(maxsize=64)
def _design_lowpass(L: int, M: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass with gain L (float64 design precision)."""
    max_rate = max(L, M)
    half_len = HALF_LEN_MULT * max_rate
    K = 2 * half_len + 1
    n = np.arange(K, dtype=np.float64) - half_len
    cutoff = 1.0 / max_rate
    h = np.sinc(n * cutoff) * cutoff * np.kaiser(K, KAISER_BETA)
    return h * (L / h.sum())


@functools.lru_cache(maxsize=64)
def get_plan(from_rate: int, to_rate: int) -> ResamplePlan:
    return ResamplePlan(from_rate, to_rate)


# ---------------------------------------------------------------------------
# Host (numpy) execution
# ---------------------------------------------------------------------------

def resample_numpy(x: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Resample a 1-D float32 signal on the host."""
    plan = get_plan(from_rate, to_rate)
    if plan.identity:
        return np.asarray(x, np.float32)
    x = np.asarray(x, np.float32)
    p, b = plan.indices(len(x))
    pad = plan.T
    xp = np.concatenate(
        [np.zeros(pad, np.float32), x, np.zeros(pad + plan.T, np.float32)]
    )
    idx = b[:, None] - np.arange(plan.T, dtype=np.int64)[None, :] + pad
    return np.einsum("nt,nt->n", xp[idx], plan.H[p]).astype(np.float32)


#: Above this upsample factor the dilated-conv form wastes too many MACs on
#: implicit zeros; the blocked-matmul form takes over.
MAX_DEVICE_RATIO = 8


# ---------------------------------------------------------------------------
# Device (torch) execution
# ---------------------------------------------------------------------------

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
