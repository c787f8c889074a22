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
    block's span of ``tile_t`` frames stored in rows of ``span_row(hop,
    k_pad)`` samples, one per hop, padded by ``span_pad(row)``, zeros at
    and past S, window positions past K masked; a sample no frame reads is
    not stored (NaN here, so that reading one shows). ``x`` is the
    bf16-rounded signal in float64."""
    b, s = x.shape
    row = stft_conv.span_row(hop, k_pad)
    pad = stft_conv.span_pad(row)
    rows = tile_t - 1 + -(-k_pad // hop)
    p = np.arange((tile_t - 1) * hop + k_pad)
    p = p[p % hop < row]
    where = (p // hop) * (row + pad) + p % hop
    out = np.zeros((b, t, k_pad))
    kk = np.arange(k_pad)
    for t0 in range(0, t, tile_t):
        span = np.full((b, rows * (row + pad)), np.nan)
        g = t0 * hop + p
        span[:, where] = np.where(g < s, x[:, np.minimum(g, s - 1)], 0.0)
        for r in range(min(tile_t, t - t0)):
            q = r * hop + kk
            frame = span[:, (q // hop) * (row + pad) + q % hop]
            out[:, t0 + r] = np.where(kk < k, frame, 0.0)
    assert not np.isnan(out).any()
    return out
