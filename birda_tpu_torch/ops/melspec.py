"""Mel-spectrogram front-end of the native model family: the port of
``birda_tpu/ops/melspec.py``.

The DFT runs as two products against a precomputed Hann-windowed basis (real
and imaginary), then the power, the mel product and the log. The JAX module
leaves these products to XLA, outside any Pallas kernel; here they are
``torch.matmul`` (cuBLAS on the card), in float32 on every device; the
hop-grid front-end takes the JAX function's ``compute_dtype``.
:func:`hann` and :func:`mel_filterbank` also build the full-scale fixtures'
front-ends (:mod:`birda_tpu_torch.onnx.fullscale`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class MelSpecConfig:
    """Spectrogram front-end parameters."""

    sample_rate: int = 48_000
    n_fft: int = 1024
    hop: int = 512
    n_mels: int = 128
    fmin: float = 50.0
    fmax: float = 15_000.0
    log_offset: float = 1e-6
    #: magnitude ("linear"), power ("power"), or log-power ("log")
    scale: str = "log"

    def frames(self, n_samples: int) -> int:
        """Number of STFT frames (center=False semantics)."""
        return 1 + (n_samples - self.n_fft) // self.hop


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


@functools.lru_cache(maxsize=16)
def _bases(cfg: MelSpecConfig):
    """The windowed DFT bases ``cos_b``/``sin_b`` [n_fft, n_bins] and the mel
    filterbank [n_bins, n_mels], float32 numpy (the power needs both DFT
    parts before the mel product, so the bases cannot be fused with it)."""
    n_bins = cfg.n_fft // 2 + 1
    k = np.arange(n_bins)[None, :]
    n = np.arange(cfg.n_fft)[:, None]
    w = hann(cfg.n_fft)[:, None]
    angle = 2 * np.pi * n * k / cfg.n_fft
    cos_b = (np.cos(angle) * w).astype(np.float32)
    sin_b = (-np.sin(angle) * w).astype(np.float32)
    fb = mel_filterbank(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.fmin, cfg.fmax
    ).astype(np.float32)
    return cos_b, sin_b, fb


@functools.lru_cache(maxsize=16)
def _device_bases(cfg: MelSpecConfig, device: torch.device):
    """:func:`_bases` on ``device``, copied there once."""
    return tuple(torch.from_numpy(b).to(device) for b in _bases(cfg))


def _scaled(mel: torch.Tensor, cfg: MelSpecConfig) -> torch.Tensor:
    if cfg.scale == "log":
        return torch.log(mel + cfg.log_offset)
    if cfg.scale == "power":
        return mel
    return torch.sqrt(mel)


def melspec(x: torch.Tensor, cfg: MelSpecConfig) -> torch.Tensor:
    """Mel spectrograms of ``x`` [batch, n_samples] float32:
    [batch, frames, n_mels] float32."""
    cos_b, sin_b, fb = _device_bases(cfg, x.device)
    framed = x.unfold(-1, cfg.n_fft, cfg.hop)  # [batch, frames, n_fft]
    re = torch.matmul(framed, cos_b)
    im = torch.matmul(framed, sin_b)
    return _scaled(torch.matmul(re * re + im * im, fb), cfg)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 sums, as jnp's ``preferred_element_type=
    float32``: operands of a narrower dtype are widened exactly (a product
    of two bf16 values is exact in float32); float32 operands multiply as
    they are."""
    return torch.matmul(a.float(), b.float())


def melspec_from_chunk(chunk: torch.Tensor, cfg: MelSpecConfig, batch: int,
                       step_samples: int, n_samples: int,
                       compute_dtype: torch.dtype | None = None
                       ) -> torch.Tensor:
    """Mel spectrograms of ``batch`` overlapped windows of a contiguous 1-D
    float32 chunk, windows ``step_samples`` apart, ``n_samples`` long:
    [batch, frames, n_mels] float32.

    Frames are computed once on the chunk's global hop grid, without a
    framed ``[N, n_fft]`` tensor: a frame is ``ceil(n_fft/hop)`` consecutive
    hop blocks, so the chunk is viewed as ``[N_global, hop]`` rows at each
    part offset and each part multiplies its own slice of the DFT basis.
    Window ``b`` then reads global frames ``[b·step/hop, +frames)``.
    Requires ``step_samples % hop == 0`` (callers frame per window
    otherwise).

    With ``compute_dtype=torch.bfloat16`` the chunk, the DFT bases, the
    power and the filterbank are rounded to bf16 before their products,
    whose sums stay float32, as in the JAX function; None computes in
    float32.
    """
    if step_samples % cfg.hop != 0:
        raise ValueError(
            f"step {step_samples} not a multiple of hop {cfg.hop}"
        )
    cos_b, sin_b, fb = _device_bases(cfg, chunk.device)
    hop = cfg.hop
    frames = cfg.frames(n_samples)
    frames_per_step = step_samples // hop
    last_start = (batch - 1) * step_samples + (frames - 1) * hop
    n_global = last_start // hop + 1
    n_parts = -(-cfg.n_fft // hop)
    # Later part offsets overrun the chunk tail by up to n_parts*hop - n_fft
    # samples (whole rows whose trailing columns are never read).
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    x = torch.nn.functional.pad(chunk.to(dtype), (0, n_parts * hop))
    re = im = None
    for part in range(n_parts):
        off = part * hop
        width = min(hop, cfg.n_fft - off)
        part_x = x[off:off + n_global * hop].reshape(n_global, hop)[:, :width]
        r = _matmul_f32(part_x, cos_b[off:off + width].to(dtype))
        i = _matmul_f32(part_x, sin_b[off:off + width].to(dtype))
        re = r if re is None else re + r
        im = i if im is None else im + i
    power = re * re + im * im  # [N_global, bins] float32
    mel = _matmul_f32(power.to(dtype), fb.to(dtype))  # [N_global, mels]
    rows = (torch.arange(batch, device=chunk.device)[:, None] * frames_per_step
            + torch.arange(frames, device=chunk.device)[None, :])
    return _scaled(mel[rows], cfg)


def melspec_reference(x: np.ndarray, cfg: MelSpecConfig) -> np.ndarray:
    """Numpy reference implementation (FFT-based) for parity tests."""
    x = np.asarray(x, np.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    frames = cfg.frames(x.shape[-1])
    w = hann(cfg.n_fft)
    out = []
    _, _, fb = _bases(cfg)
    for row in x:
        f = np.stack(
            [row[i * cfg.hop : i * cfg.hop + cfg.n_fft] * w for i in range(frames)]
        )
        spec = np.fft.rfft(f, axis=-1)
        power = np.abs(spec) ** 2
        mel = power @ fb
        out.append(mel)
    mel = np.stack(out)
    if cfg.scale == "log":
        mel = np.log(mel + cfg.log_offset)
    elif cfg.scale == "linear":
        mel = np.sqrt(mel)
    return mel[0] if squeeze else mel
