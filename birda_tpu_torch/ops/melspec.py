"""Mel filterbank design on the host (numpy).

The windowing and filterbank helpers of ``birda_tpu/ops/melspec.py`` that
the full-scale fixtures (:mod:`birda_tpu_torch.onnx.fullscale`) build their
front-ends from. The JAX module's spectrogram front-end is not part of the
port: the ONNX graphs carry their own.
"""

from __future__ import annotations

import numpy as np


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def mel_filterbank(
    n_mels: int, n_fft: int, sample_rate: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-style triangular mel filterbank, shape [n_fft//2+1, n_mels]."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    # Slaney normalization: equal area per filter.
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    fb *= enorm[None, :]
    return fb
