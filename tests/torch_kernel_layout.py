"""What the spectrogram kernels of birda_tpu_torch/csrc read, rebuilt in
numpy for the CPU tests of their layouts: the weight images through the
wgmma descriptor's 128-B swizzle, and the frames through the padded signal
span of csrc/strided_window_gemm.cuh, loaded whole or streamed in pieces
along the window."""

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


def piece_frames(x: np.ndarray, hop: int, k: int, k_pad: int, t: int,
                 piece: int, tile_t: int = TILE_T) -> np.ndarray:
    """Frames ``[B, T, k_pad]`` as the kernel's consumers read them where
    the span is streamed in pieces of ``piece`` window samples
    (``load_piece``, ``mma_window_streamed``): for each block of ``tile_t``
    frames and each piece at window position ``k0``, rows of
    ``span_row(hop, piece)`` samples at ``(t0 + j) * hop + k0`` for the
    block's real frames only, padded by ``span_pad(row)``, zeros at and
    past S, window positions past K masked; nothing else is loaded (NaN
    here, so that reading it shows)."""
    b, s = x.shape
    row = stft_conv.span_row(hop, piece)
    pad = stft_conv.span_pad(row)
    out = np.zeros((b, t, k_pad))
    kk = np.arange(piece)
    for t0 in range(0, t, tile_t):
        n = min(tile_t, t - t0)
        rows = n - 1 + -(-piece // hop)
        e = np.arange(rows * row)
        j, r = e // row, e % row
        where = j * (row + pad) + r
        for k0 in range(0, k_pad, piece):
            span = np.full((b, rows * (row + pad)), np.nan)
            g = (t0 + j) * hop + k0 + r
            span[:, where] = np.where(g < s, x[:, np.minimum(g, s - 1)], 0.0)
            width = min(piece, k_pad - k0)  # chunks past k_pad are not read
            for f in range(n):
                q = f * hop + kk[:width]
                frame = span[:, (q // hop) * (row + pad) + q % hop]
                out[:, t0 + f, k0:k0 + width] = np.where(
                    k0 + kk[:width] < k, frame, 0.0)
    assert not np.isnan(out).any()
    return out


def layout_frames(x: np.ndarray, hop: int, k: int, k_pad: int, t: int,
                  layout: tuple[int, int]) -> np.ndarray:
    """Frames as the kernel reads them in ``layout``, (frames per block,
    window samples the span holds) from ``stft_conv.conv1d_layout``: the
    whole window's span, or pieces of it."""
    frames, piece = layout
    if piece >= k_pad:
        return span_frames(x, hop, k, k_pad, t, frames)
    return piece_frames(x, hop, k, k_pad, t, piece, frames)
