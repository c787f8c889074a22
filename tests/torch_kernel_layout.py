"""What the spectrogram kernels of birda_tpu_torch/csrc read, rebuilt in
numpy for the CPU tests of their layouts: the weight images through the
wgmma descriptor's 128-B swizzle, and the frames through the padded signal
span of csrc/strided_window_gemm.cuh."""

import numpy as np

from birda_tpu_torch.ops import stft_conv

TILE_T = 128  # csrc/strided_window_gemm.cuh: frames per block


def unswizzle(a: np.ndarray) -> np.ndarray:
    """Images of rows of 64 bf16 read back through the 128-B swizzle the
    kernel's wgmma descriptor assumes: logical byte b of an image lies at
    b ^ (((b >> 7) & 7) << 4)."""
    rows = a.shape[-2]
    logical = np.arange(rows)[:, None] * 128 + np.arange(64)[None, :] * 2
    phys = logical ^ (((logical >> 7) & 7) << 4)
    return a.reshape(*a.shape[:-2], rows * 64)[..., phys // 2]


def span_frames(x: np.ndarray, hop: int, k: int, k_pad: int, t: int,
                tile_t: int = TILE_T) -> np.ndarray:
    """Frames ``[B, T, k_pad]`` as the kernel's consumers read them: each
    frame tile's span stored in rows of ``hop`` samples padded by
    ``span_pad(hop)``, zeros at and past S, window positions past K
    masked. ``x`` is the bf16-rounded signal in float64."""
    b, s = x.shape
    pad = stft_conv.span_pad(hop)
    rows = tile_t - 1 + -(-k_pad // hop)
    p = np.arange((tile_t - 1) * hop + k_pad)
    where = (p // hop) * (hop + pad) + p % hop
    out = np.zeros((b, t, k_pad))
    kk = np.arange(k_pad)
    for t0 in range(0, t, tile_t):
        span = np.full((b, rows * (hop + pad)), np.nan)
        g = t0 * hop + p
        span[:, where] = np.where(g < s, x[:, np.minimum(g, s - 1)], 0.0)
        for r in range(min(tile_t, t - t0)):
            q = r * hop + kk
            frame = span[:, (q // hop) * (hop + pad) + q % hop]
            out[:, t0 + r] = np.where(kk < k, frame, 0.0)
    return out
