"""Spectrogram front-end kernels: the Hopper port of
``birda_tpu/ops/stft_conv.py``.

Two wrappers, one for each of the JAX module's Pallas kernels. Each launches
its hand-written CUDA kernel for a CUDA tensor (or raises) and takes its
plain PyTorch version for a CPU tensor:

- :func:`fused_logmel` computes what ``_fused_logmel`` does on the TPU —
  windowed-DFT matmul with fp32 accumulation, power from the fp32
  accumulator rounded to bf16, mel projection with fp32 accumulation,
  ``log(mel + eps)`` out as bf16 — through ``csrc/fused_logmel.cu``; plain
  version :func:`fused_logmel_reference`.
- :func:`conv1d_stft` computes what ``_conv1d_stft`` does — the strided
  single-channel Conv1d ``[B, S] x [C, K] -> [B, C, T]`` with bf16 operands,
  fp32 accumulation and bf16 out — through ``csrc/conv1d_stft.cu``; plain
  version :func:`conv1d_stft_reference`.

Both kernels run the strided-window GEMM mainloop of
``csrc/strided_window_gemm.cuh`` and read the signal as it comes (float32 or
bf16, no padded copy). They take their constants as padded chunks, each one
128-B swizzled image that the wgmma descriptor reads as it lies
(:func:`prepare_logmel_weights`, :func:`prepare_conv1d_weights`): the
graph's weights are fixed, so the lowering prepares each layout once per
weight, not per call.
"""

from __future__ import annotations

import ctypes
import os
import threading
from collections import Counter
from dataclasses import dataclass

import torch

#: Kernel launches by kernel name, counted by each wrapper where it launches
#: its kernel and nowhere else.
LAUNCHES: Counter = Counter()
_launches_lock = threading.Lock()  # --jobs workers launch concurrently


#: The route each front-end node took, by ``"<kernel>:kernel"`` or
#: ``"<kernel>:composed"``, counted by the evaluator once per node call on
#: every device: decided from static shapes alone
#: (:func:`conv1d_kernel_fits`, :func:`logmel_kernel_fits`) and
#: :data:`KERNEL_ENV`, so a CPU run reports the route the card would take.
ROUTES: Counter = Counter()


#: The JAX package's switch of its front-end kernels
#: (``birda_tpu/ops/stft_conv.py::kernel_enabled``): ``gather`` asks for the
#: composed route; ``auto`` (the default) and ``pallas`` take the kernel
#: wherever it holds the geometry (on the CPU, its plain version).
KERNEL_ENV = "BIRDA_STFT_KERNEL"


def kernel_requested() -> bool:
    """False where ``BIRDA_STFT_KERNEL=gather`` asks for the composed
    route of every front-end node, on every device. Read per node call, as
    the JAX package reads it."""
    return os.environ.get(KERNEL_ENV, "auto") != "gather"


def _count_launch(name: str) -> None:
    with _launches_lock:
        LAUNCHES[name] += 1


def count_route(name: str, route: str) -> None:
    with _launches_lock:
        ROUTES[f"{name}:{route}"] += 1

#: Widest mel output (sum of the banks) one pass of the kernel's register
#: tiling holds; a wider front end takes several passes
#: (:func:`mel_passes`).
MAX_PASS_MELS = 256


#: ctypes signatures of each kernel library's launch function.
_SIGNATURES = {
    "fused_logmel": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 13
                     + [ctypes.c_float, ctypes.c_void_p]),
    "conv1d_stft": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 12 + [ctypes.c_void_p]),
}

#: csrc/strided_window_gemm.cuh: ring stages of one 16 KB weight chunk
#: each, and the shared memory a block may use on sm_90.
RING_STAGES = 4
STAGE_BYTES = 16 * 1024
SMEM_LIMIT = 232_448
#: conv1d_stft.cu's transposed output staging of one consumer warpgroup:
#: 128 channels x 72 bf16.
CONV_STAGING_BYTES = 128 * 72 * 2
#: strided_window_gemm.cuh's window depth per ring stage: the kernels pad
#: K to whole chunks of it.
TILE_K = 64
#: Frames per block the mainloop takes, widest first: 128 (two consumer
#: warpgroups of 64), or fewer (one warpgroup, whose rows past them repeat
#: the last frame) where the span of more frames does not fit shared
#: memory.
FRAME_BLOCKS = (128, 64, 32, 16, 8, 4, 2, 1)
#: Frames per block of the Conv1d-STFT kernel where it streams the span in
#: pieces along the window (:func:`conv1d_layout`).
STREAM_FRAMES = 128
#: The JAX package's Pallas kernel's frames per program and VMEM budget
#: (``birda_tpu/ops/stft_conv.py::enabled``), which :func:`pallas_budget`
#: copies.
PALLAS_TILE_T = 128
PALLAS_VMEM_BUDGET = 13 * 2**20


def _lib(name: str):
    """The loaded kernel library ``csrc/<name>.cu`` (built on first use),
    with every exported function's signature declared."""
    from ._build import load

    lib = load(name)
    launch = getattr(lib, f"birda_{name}")
    if launch.argtypes is None:
        for tile in ("t", "bins", "c", "k"):
            fn = getattr(lib, f"birda_{name}_tile_{tile}", None)
            if fn is not None:
                fn.argtypes, fn.restype = [], ctypes.c_int
        launch.restype = ctypes.c_int
        launch.argtypes = _SIGNATURES[name]
    return lib


def _tiles() -> tuple[int, int, int]:
    """(frames, bins, K) tile sizes compiled into the fused kernel."""
    lib = _lib("fused_logmel")
    return (lib.birda_fused_logmel_tile_t(),
            lib.birda_fused_logmel_tile_bins(),
            lib.birda_fused_logmel_tile_k())


def _conv_tiles() -> tuple[int, int, int]:
    """(frames, channels, K) tile sizes compiled into the Conv1d-STFT
    kernel."""
    lib = _lib("conv1d_stft")
    return (lib.birda_conv1d_stft_tile_t(),
            lib.birda_conv1d_stft_tile_c(),
            lib.birda_conv1d_stft_tile_k())


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """The 128-B swizzle of rows of 64 bf16 (128 B) that a K-major wgmma
    descriptor of mode 1 reads: in row ``r``, the 16-B unit ``u`` holds the
    row's logical unit ``u ^ (r % 8)``. ``t``: ``[..., rows, 64]``, rows a
    multiple of 8, each image starting on a 1024-B boundary. Its own
    inverse."""
    rows = t.shape[-2]
    r = torch.arange(rows, device=t.device)[:, None]
    u = torch.arange(8, device=t.device)[None, :]
    v = t.reshape(*t.shape[:-1], 8, 8)
    return v[..., r, u ^ (r % 8), :].reshape(t.shape)


def span_pad(row: int) -> int:
    """Samples of padding after each ``row``-sample row of the signal span
    in shared memory, so that the eight frames one warp reads at one window
    position fall on distinct banks: the row stride ``(row + pad) / 2``
    words is 4 mod 8. 0 for an odd row (2-byte loads) or a row below 16."""
    if row % 2 or row < 16:
        return 0
    return 2 * ((4 - row // 2) % 8)


def span_row(hop: int, k_pad: int) -> int:
    """Samples of each hop the span stores: all of it, or only the first
    ``k_pad`` where the hop is longer than the window (the rest no frame
    reads)."""
    return min(hop, k_pad)


def span_smem_bytes(hop: int, k_pad: int, extra: int = 0,
                    frames: int = 128) -> int:
    """Dynamic shared memory of one block (strided_window_gemm.cuh::
    smem_bytes): alignment slack, the weight ring, its barriers, the padded
    span of ``frames`` frames and ``extra`` epilogue bytes."""
    rows = frames - 1 + -(-k_pad // hop)
    row = span_row(hop, k_pad)
    span = -(-rows * (row + span_pad(row)) * 2 // 16) * 16
    return 1024 + RING_STAGES * STAGE_BYTES + 2 * RING_STAGES * 8 + span \
        + extra


def _frames(hop: int, k: int, staging: int) -> int | None:
    """The most frames per block (:data:`FRAME_BLOCKS`) whose span, and
    ``staging`` bytes per consumer warpgroup, fit a block's shared memory;
    None where not even the fewest do."""
    k_pad = -(-k // TILE_K) * TILE_K
    for frames in FRAME_BLOCKS:
        extra = staging * (2 if frames > 64 else 1)
        if span_smem_bytes(hop, k_pad, extra, frames) <= SMEM_LIMIT:
            return frames
    return None


def conv1d_frames(hop: int, k: int) -> int | None:
    """Frames per block of :func:`conv1d_stft`'s kernel at ``hop`` and a
    ``k``-sample window (None: it cannot hold the span)."""
    return _frames(hop, k, CONV_STAGING_BYTES)


def logmel_frames(hop: int, k: int) -> int | None:
    """Frames per block of :func:`fused_logmel`'s kernel at ``hop`` and a
    ``k``-sample window (None: it cannot hold the span)."""
    return _frames(hop, k, 0)


def pallas_budget(s: int, k: int, hop: int, c: int) -> bool:
    """Whether the JAX package's Conv1d-STFT Pallas kernel holds ``[B, s]
    x [c, k]`` at ``hop`` in its VMEM budget (the arithmetic of
    ``birda_tpu/ops/stft_conv.py::enabled``): the resident weight slabs,
    two signal rows and two accumulator tiles under 13 MiB."""
    nblk = -(-k // hop)
    w_bytes = nblk * hop * c * 2
    row_bytes = (s + (nblk + PALLAS_TILE_T) * hop) * 2
    acc_bytes = PALLAS_TILE_T * c * 4 + PALLAS_TILE_T * c * 2
    return w_bytes + 2 * row_bytes + 2 * acc_bytes < PALLAS_VMEM_BUDGET


def conv1d_piece(hop: int, k: int) -> int:
    """Window samples per piece where :func:`conv1d_stft`'s kernel streams
    the span: the most whole chunks of :data:`TILE_K` (fewer than the padded
    window) whose span of :data:`STREAM_FRAMES` frames, with both consumer
    warpgroups' output staging, fits a block's shared memory."""
    lo, hi = 1, -(-k // TILE_K) - 1  # chunks; the answer lies in [lo, hi]
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if span_smem_bytes(hop, mid * TILE_K, 2 * CONV_STAGING_BYTES,
                           STREAM_FRAMES) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo * TILE_K


def conv1d_layout(s: int, k: int, hop: int, c: int
                  ) -> tuple[int, int] | None:
    """(frames per block, window samples the span holds) of
    :func:`conv1d_stft`'s kernel at ``[B, s] x [c, k]`` and ``hop``: the
    whole padded window's span of :func:`conv1d_frames` frames where it
    fits; else, where the JAX package's Pallas kernel holds the geometry
    (:func:`pallas_budget`), a span of :data:`STREAM_FRAMES` frames
    streamed in pieces of :func:`conv1d_piece` samples; else None (the
    JAX package's composed route)."""
    frames = conv1d_frames(hop, k)
    if frames is not None:
        return frames, -(-k // TILE_K) * TILE_K
    if pallas_budget(s, k, hop, c):
        return STREAM_FRAMES, conv1d_piece(hop, k)
    return None


def mel_passes(m: int) -> tuple[int, int]:
    """(passes, padded mel width of one pass) of :func:`fused_logmel`'s
    kernel for ``m`` mel outputs: equal column ranges of at most
    :data:`MAX_PASS_MELS`, each padded to a multiple of 32."""
    passes = -(-m // MAX_PASS_MELS)
    width = -(-m // passes)
    return passes, -(-width // 32) * 32


def conv1d_kernel_fits(s: int, k: int, hop: int, c: int) -> bool:
    """Whether :func:`conv1d_stft`'s kernel takes ``[B, s] x [c, k]`` at
    ``hop``: a window no longer than the signal, and either the span of at
    least one frame with its output staging within a block's shared memory
    (a window of up to about 73,000 samples) or the JAX package's Pallas
    budget holding, where the kernel streams the span in pieces
    (:func:`conv1d_layout`, the check the wrapper raises on); any ``c``,
    which the kernel tiles. Static: the same answer on every device."""
    return s >= k and conv1d_layout(s, k, hop, c) is not None


def logmel_kernel_fits(s: int, k: int, hop: int, c: int, m: int) -> bool:
    """Whether :func:`fused_logmel`'s kernel holds ``[B, s] x [c, k] x
    [c // 2, m]`` at ``hop``: a window no longer than the signal and the
    span of at least one frame within a block's shared memory (a window of
    up to about 82,000 samples); any ``c`` and ``m``, which the kernel
    tiles (``m`` in passes of at most 256). Static: the same answer on
    every device."""
    return s >= k and logmel_frames(hop, k) is not None


def _span_args(name: str, hop: int, k: int, frames: int | None,
               piece: int | None = None) -> tuple[int, int, int]:
    """(row, pad, frames) of a launch whose span holds ``piece`` window
    samples (the whole padded window by default), or the refusal of a span
    no block holds."""
    if frames is None:
        raise ValueError(
            f"{name}: the signal span of one frame at hop {hop} and a "
            f"{k}-sample window needs more than the "
            f"{SMEM_LIMIT} bytes of shared memory a block may use")
    if piece is None:
        piece = -(-k // TILE_K) * TILE_K
    row = span_row(hop, piece)
    return row, span_pad(row), frames


def _signal(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: ``[B, S]``, contiguous, float32 or
    bf16 (no padded copy: the kernel masks the tail itself)."""
    if x.ndim != 2:
        raise ValueError(f"{name}: signal must be [B, S], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return x.contiguous()


@dataclass(frozen=True)
class LogmelWeights:
    """The kernel's layout of one front-end's DFT weight and filterbank.

    ``w``: ``[n_bin_tiles, n_k_chunks, 2 * tile_bins, tile_k]`` bf16 — for
    each bin tile and K chunk, the chunk's cos rows then its -sin rows,
    ``[bin, k]``, zero-padded past ``bins`` and ``k``, each chunk one
    :func:`swizzle128` image. ``fb``: ``[n_bin_tiles, mp, tile_bins]`` bf16
    — for each bin tile, the filterbank transposed to ``[mel, bin]``,
    zero-padded to whole bin tiles and to ``mp``, the mel width rounded up
    to a multiple of 32, swizzled the same way. Past 256 mels ``mp`` is
    ``passes`` equal ranges of ``pass_mp`` columns (:func:`mel_passes`),
    one per pass of the kernel.
    """

    w: torch.Tensor
    fb: torch.Tensor
    bins: int
    k: int
    m: int
    passes: int
    pass_mp: int


def prepare_logmel_weights(w: torch.Tensor, fb: torch.Tensor
                           ) -> LogmelWeights:
    """Lay out ``w [2*bins, K]`` and ``fb [bins, M]`` for the CUDA kernel."""
    c, k = w.shape
    bins, m = fb.shape
    if c != 2 * bins:
        raise ValueError(f"DFT weight has {c} rows for {bins} bins")
    if m < 1:
        raise ValueError("fused_logmel needs at least one mel output")
    _, tb, tk = _tiles()
    nbt, nkc = -(-bins // tb), -(-k // tk)
    passes, pass_mp = mel_passes(m)
    mp = passes * pass_mp
    dev = w.device
    banks = torch.zeros((2, nbt * tb, nkc * tk), dtype=torch.bfloat16,
                        device=dev)
    banks[0, :bins, :k] = w[:bins]
    banks[1, :bins, :k] = w[bins:]
    # [2, nbt, tb, nkc, tk] -> [nbt, nkc, 2, tb, tk]: cos then sin rows.
    wp = (banks.view(2, nbt, tb, nkc, tk).permute(1, 3, 0, 2, 4)
          .reshape(nbt, nkc, 2 * tb, tk))
    fbp = torch.zeros((nbt * tb, mp), dtype=torch.bfloat16, device=dev)
    fbp[:bins, :m] = fb
    fbp = fbp.view(nbt, tb, mp).transpose(1, 2)  # [nbt, mp, tb]
    return LogmelWeights(w=swizzle128(wp).contiguous(),
                         fb=swizzle128(fbp).contiguous(),
                         bins=bins, k=k, m=m, passes=passes,
                         pass_mp=pass_mp)


def fused_logmel_reference(x: torch.Tensor, w: torch.Tensor,
                           fb: torch.Tensor, hop: int, eps: float
                           ) -> torch.Tensor:
    """Plain PyTorch version: ``[B,S] x [2*bins,K] x [bins,M] -> [B,T,M]``.

    The same bf16 operands as the kernel, products summed in fp32:
    frames unfolded from the bf16 signal, the DFT as an fp32 matmul, power
    rounded to bf16, the mel matmul in fp32, then ``log(mel + eps)`` as bf16.
    """
    bins = fb.shape[0]
    k = w.shape[1]
    frames = x.to(torch.bfloat16).float().unfold(-1, k, hop)  # [B, T, K]
    spec = torch.matmul(frames, w.to(torch.bfloat16).float().T)
    re, im = spec[..., :bins], spec[..., bins:2 * bins]
    power = (re * re + im * im).to(torch.bfloat16).float()
    mel = torch.matmul(power, fb.to(torch.bfloat16).float())
    return torch.log(mel + eps).to(torch.bfloat16)


def fused_logmel(x: torch.Tensor, w: torch.Tensor, fb: torch.Tensor,
                 hop: int, eps: float,
                 prepared: LogmelWeights | None = None) -> torch.Tensor:
    """``[B,S] x [2*bins,K] x [bins,M] -> [B,T,M]`` bf16 log-mel image,
    ``T = (S - K) // hop + 1``; ``w`` rows are ``[cos ; -sin]``, ``fb`` the
    mel banks concatenated column-wise.

    A CUDA tensor launches the kernel (``prepared`` is the layout of ``w``
    and ``fb`` from :func:`prepare_logmel_weights`, made here when absent)
    or raises; a CPU tensor takes :func:`fused_logmel_reference`, and a meta
    tensor its output shape alone.
    """
    if x.device.type in ("cpu", "meta"):
        return fused_logmel_reference(x, w, fb, hop, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_logmel: unsupported device {x.device}")
    x = _signal("fused_logmel", x)
    if prepared is None:
        prepared = prepare_logmel_weights(w, fb)
    for name, t in (("w", prepared.w), ("fb", prepared.fb)):
        if t.device != x.device:
            raise ValueError(f"fused_logmel: {name} on {t.device}, signal "
                             f"on {x.device}")
    b, s = x.shape
    k, m = prepared.k, prepared.m
    if s < k:
        raise ValueError(f"fused_logmel: signal of {s} samples is shorter "
                         f"than the {k}-sample window")
    n_bin_tiles, n_kc = prepared.w.shape[0], prepared.w.shape[1]
    row, pad, frames = _span_args("fused_logmel", hop, k,
                                  logmel_frames(hop, k))
    t = (s - k) // hop + 1
    with torch.cuda.device(x.device):
        out = torch.empty((b, t, m), dtype=torch.bfloat16, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib("fused_logmel").birda_fused_logmel(
            x.data_ptr(), int(x.dtype == torch.float32),
            prepared.w.data_ptr(), prepared.fb.data_ptr(), out.data_ptr(),
            b, s, hop, row, pad, frames, k, t, m, prepared.pass_mp,
            prepared.passes, n_bin_tiles, n_kc, float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"fused_logmel kernel launch failed: CUDA error "
                           f"{rc}")
    _count_launch("fused_logmel")
    return out


# ---------------------------------------------------------------------------
# Conv1d-STFT: the strided single-channel Conv1d the fusion pass did not take
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Conv1dWeights:
    """The Conv1d-STFT kernel's layout of one conv weight ``[C, K]``.

    ``w``: ``[n_c_tiles, n_k_chunks, tile_c, tile_k]`` bf16 — for each
    channel tile and K chunk, the chunk ``[c, k]``, zero-padded past ``c``
    and ``k``, one :func:`swizzle128` image.
    """

    w: torch.Tensor
    c: int
    k: int


def prepare_conv1d_weights(w: torch.Tensor) -> Conv1dWeights:
    """Lay out ``w [C, K]`` for the CUDA kernel."""
    if w.ndim != 2:
        raise ValueError(f"conv weight must be [C, K], got {tuple(w.shape)}")
    c, k = w.shape
    _, tc, tk = _conv_tiles()
    nct, nkc = -(-c // tc), -(-k // tk)
    padded = torch.zeros((nct * tc, nkc * tk), dtype=torch.bfloat16,
                         device=w.device)
    padded[:c, :k] = w
    # [nct, tc, nkc, tk] -> [nct, nkc, tc, tk]
    wp = padded.view(nct, tc, nkc, tk).permute(0, 2, 1, 3)
    return Conv1dWeights(w=swizzle128(wp).contiguous(), c=c, k=k)


def conv1d_stft_reference(x: torch.Tensor, w: torch.Tensor, hop: int
                          ) -> torch.Tensor:
    """Plain PyTorch version: ``[B, S] x [C, K] -> [B, C, T]`` bf16.

    The same bf16 operands as the kernel, products summed in fp32: frames
    unfolded from the bf16 signal, an fp32 matmul with the bf16-rounded
    weight, the result rounded to bf16.
    """
    k = w.shape[1]
    frames = x.to(torch.bfloat16).float().unfold(-1, k, hop)  # [B, T, K]
    out = torch.matmul(frames, w.to(torch.bfloat16).float().T)
    return out.transpose(1, 2).to(torch.bfloat16)


def conv1d_stft(x: torch.Tensor, w: torch.Tensor, hop: int,
                prepared: Conv1dWeights | None = None) -> torch.Tensor:
    """``[B, S] x [C, K] -> [B, C, T]`` bf16 strided windowed matmul,
    ``T = (S - K) // hop + 1``: ``out[b, c, t] = sum_k x[b, t*hop + k] *
    w[c, k]``.

    A CUDA tensor launches the kernel (``prepared`` is the layout of ``w``
    from :func:`prepare_conv1d_weights`, made here when absent) or raises;
    a CPU tensor takes :func:`conv1d_stft_reference`, and a meta tensor its
    output shape alone.
    """
    if x.device.type in ("cpu", "meta"):
        return conv1d_stft_reference(x, w, hop)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_stft: unsupported device {x.device}")
    x = _signal("conv1d_stft", x)
    if prepared is None:
        prepared = prepare_conv1d_weights(w)
    if prepared.w.device != x.device:
        raise ValueError(f"conv1d_stft: w on {prepared.w.device}, signal "
                         f"on {x.device}")
    b, s = x.shape
    c, k = prepared.c, prepared.k
    if s < k:
        raise ValueError(f"conv1d_stft: signal of {s} samples is shorter "
                         f"than the {k}-sample window")
    n_c_tiles, n_kc = prepared.w.shape[0], prepared.w.shape[1]
    frames, piece = conv1d_layout(s, k, hop, c) or (None, None)
    row, pad, frames = _span_args("conv1d_stft", hop, k, frames, piece)
    t = (s - k) // hop + 1
    with torch.cuda.device(x.device):
        out = torch.empty((b, c, t), dtype=torch.bfloat16, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib("conv1d_stft").birda_conv1d_stft(
            x.data_ptr(), int(x.dtype == torch.float32),
            prepared.w.data_ptr(), out.data_ptr(), b, s, hop, row, pad,
            frames, k, t, c, n_c_tiles, n_kc, piece, stream)
    if rc != 0:
        raise RuntimeError(f"conv1d_stft kernel launch failed: CUDA error "
                           f"{rc}")
    _count_launch("conv1d_stft")
    return out
