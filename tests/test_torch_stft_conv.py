"""Fused log-mel front-end of the PyTorch port (birda_tpu_torch/ops/stft_conv.py)
against the JAX package's Pallas kernel (birda_tpu/ops/stft_conv.py).

On the CPU the port's wrapper takes its plain PyTorch version; the JAX
kernel runs in interpret mode. Both use the same bf16 operands and fp32
sums, so they differ only in the order of the fp32 additions: the bound is
the JAX package's on-chip log-mel bound (q99 < 5e-2), with max < 0.25.
The CUDA kernel itself is held against the plain version on a card only.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from birda_tpu.ops.melspec import hann, mel_filterbank

from birda_tpu_torch.ops import stft_conv
from torch_kernel_layout import span_frames, unswizzle

REPO = Path(__file__).resolve().parent.parent

Q99_BOUND = 5e-2
MAX_BOUND = 0.25


def _frontend(n_fft, banks, sample_rate):
    """The full-scale graphs' windowed-DFT weight [2*bins, K] and the
    concatenated mel filterbank [bins, M] (onnx/fullscale.py::_frontend)."""
    bins = n_fft // 2 + 1
    win = hann(n_fft).astype(np.float64)
    ang = 2 * np.pi * np.arange(bins)[:, None] * np.arange(n_fft)[None] / n_fft
    w = np.concatenate([np.cos(ang) * win, -np.sin(ang) * win]) \
        .astype(np.float32)
    fb = np.concatenate([
        mel_filterbank(m, n_fft, sample_rate, lo, hi).astype(np.float32)
        for m, lo, hi in banks], axis=1)
    return w, fb


V24 = dict(n_fft=2048, hop=278, sample_rate=48_000,
           banks=((96, 0.0, 3000.0), (96, 500.0, 15_000.0)))
V30 = dict(n_fft=1024, hop=320, sample_rate=32_000,
           banks=((128, 50.0, 16_000.0),))

# Front ends whose span of 128 frames a block cannot hold (hop 640 at K
# 1280, hop 1024 at K 1024: 64 frames per block) and one wider than the
# 256 mel columns of one pass of the register tiling (two 160-mel banks).
HOP640 = dict(n_fft=1280, hop=640, sample_rate=32_000,
              banks=((128, 50.0, 16_000.0),))
HOP1024 = dict(n_fft=1024, hop=1024, sample_rate=32_000,
               banks=((64, 50.0, 16_000.0),))
MELS320 = dict(n_fft=1024, hop=320, sample_rate=32_000,
               banks=((160, 0.0, 8000.0), (160, 500.0, 16_000.0)))

# The release geometries with the real K, hop, bins and M; S shrunk.
GEOMETRIES = [
    pytest.param(V24, 20_000, id="v24-shape"),
    pytest.param(V30, 20_000, id="v30-shape"),
    pytest.param(V24, 6_000, id="v24-t-below-one-tile"),
    pytest.param(HOP640, 50_000, id="hop640-64-frames"),
    pytest.param(HOP1024, 80_000, id="hop1024-64-frames"),
    pytest.param(MELS320, 20_000, id="320-mels-two-passes"),
]


def _case(geo, s, seed=0):
    w, fb = _frontend(geo["n_fft"], geo["banks"], geo["sample_rate"])
    x = np.random.default_rng(seed).normal(0, 0.1, (2, s)).astype(np.float32)
    return x, w, fb


@pytest.mark.parametrize("geo,s", GEOMETRIES)
def test_plain_version_matches_jax_kernel(geo, s):
    from birda_tpu.ops.stft_conv import fused_logmel as jax_fused_logmel

    x, w, fb = _case(geo, s)
    want = np.asarray(jax_fused_logmel(x, w, fb, hop=geo["hop"], eps=1e-6,
                                       interpret=True), np.float32)
    got = stft_conv.fused_logmel(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(fb), geo["hop"], 1e-6)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape
    assert want.shape[1] == (s - geo["n_fft"]) // geo["hop"] + 1
    err = np.abs(got.float().numpy() - want)
    assert np.quantile(err, 0.99) < Q99_BOUND
    assert err.max() < MAX_BOUND


def test_cpu_tensor_takes_plain_version_without_launch():
    x, w, fb = _case(V30, 4_000)
    before = stft_conv.LAUNCHES["fused_logmel"]
    got = stft_conv.fused_logmel(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(fb), V30["hop"], 1e-6)
    want = stft_conv.fused_logmel_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(fb),
        V30["hop"], 1e-6)
    assert torch.equal(got, want)
    assert stft_conv.LAUNCHES["fused_logmel"] == before


def test_other_devices_raise():
    """A meta tensor gets the output's shape alone (the int8 cost report
    runs the graph on meta tensors); any device but the CPU, the card and
    meta is refused."""
    meta = torch.device("meta")
    w = torch.empty((2 * 257, 512), device=meta)
    fb = torch.empty((257, 16), device=meta)
    out = stft_conv.fused_logmel(torch.empty((3, 4096), device=meta), w, fb,
                                 160, 1e-6)
    assert out.device == meta and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (3, (4096 - 512) // 160 + 1, 16)
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        stft_conv.fused_logmel(other, w, fb, 160, 1e-6)


def test_module_imports_without_nvcc():
    """The kernel builds at first launch, never at import: a machine
    without the CUDA toolkit imports the module and is told why the build
    fails only when a kernel is asked for."""
    code = (
        "import birda_tpu_torch.ops.stft_conv\n"
        "from birda_tpu_torch.ops import _build\n"
        "try:\n"
        "    _build.nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n"
    )
    env = dict(os.environ, PATH="", CUDA_HOME="/nonexistent-cuda")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "refused: nvcc not found" in r.stdout


def test_library_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """Both kernels include csrc/strided_window_gemm.cuh: editing it must
    rebuild both libraries, editing one kernel's source only its own. The
    ptxas report lies beside the library."""
    from birda_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC_DIR.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    assert (csrc / "strided_window_gemm.cuh").exists()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before == {n: _build.library_path(n) for n in _build.SOURCES}

    header = csrc / "strided_window_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)

    src = csrc / "fused_logmel.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("fused_logmel") != after["fused_logmel"]
    assert _build.library_path("conv1d_stft") == after["conv1d_stft"]

    report = _build.report_path("conv1d_stft")
    assert report.parent == after["conv1d_stft"].parent
    assert report.name == after["conv1d_stft"].stem + ".ptxas.txt"


PTXAS_REPORT = """\
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for the \
function '_ZN48_GLOBAL__N__daebd5df_15_fused_logmel_cu_c92a37c319fused_\
logmel_kernelILi8ELb1EEEvPKviPK13__nv_bfloat16S5_PS3_iiiiiiiif'
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__daebd5df_15_fused_\
logmel_cu_c92a37c319fused_logmel_kernelILi8ELb0EEEvPKviPK13__nv_bfloat16S5_\
PS3_iiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__daebd5df_15_fused_\
logmel_cu_c92a37c319fused_logmel_kernelILi8ELb0EEEvPKviPK13__nv_bfloat16S5_\
PS3_iiiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
ptxas info    : Compile time = 1981.817 ms
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__daebd5df_15_fused_\
logmel_cu_c92a37c319fused_logmel_kernelILi8ELb1EEEvPKviPK13__nv_bfloat16S5_\
PS3_iiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__daebd5df_15_fused_\
logmel_cu_c92a37c319fused_logmel_kernelILi8ELb1EEEvPKviPK13__nv_bfloat16S5_\
PS3_iiiiiiiif
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 8 bytes cumulative stack \
size
"""


def test_ptxas_summary_reads_registers_spills_and_warnings():
    """The ptxas -v report that chip_smoke.py prints, one record per kernel
    instantiation, a warning printed before its function's entry included."""
    from birda_tpu_torch.ops import _build

    got = _build.ptxas_summary("fused_logmel", PTXAS_REPORT)
    assert got == [
        {"function": "fused_logmel_kernel<8, false>", "registers": 168,
         "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
         "warnings": []},
        {"function": "fused_logmel_kernel<8, true>", "registers": 168,
         "stack_bytes": 8, "spill_store_bytes": 4, "spill_load_bytes": 4,
         "warnings": ["C7512"]},
    ]


TILES = (128, 64, 64)  # csrc/fused_logmel.cu: TILE_T, TILE_BINS, TILE_K


@pytest.mark.parametrize("geo,s", GEOMETRIES)
def test_kernel_layout_reproduces_plain_version(monkeypatch, geo, s):
    """The swizzled weight images the CUDA kernel reads, read back through
    the descriptor's swizzle and evaluated with the kernel's loop order
    (frames from the padded span, bin tiles, K chunks, bf16 power, mel
    accumulated across tiles) in float64, give the plain version's
    log-mel: the padding, tiling and swizzle lose nothing."""
    monkeypatch.setattr(stft_conv, "_tiles", lambda: TILES)
    _, tile_bins, tile_k = TILES
    x, w, fb = _case(geo, s)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    fbt = torch.from_numpy(fb).to(torch.bfloat16)
    layout = stft_conv.prepare_logmel_weights(wt, fbt)
    n_tiles, n_kc = layout.w.shape[:2]
    passes, pass_mp = stft_conv.mel_passes(fb.shape[1])
    mp = passes * pass_mp
    assert (layout.passes, layout.pass_mp) == (passes, pass_mp)
    assert layout.w.shape == (n_tiles, n_kc, 2 * tile_bins, tile_k)
    assert layout.fb.shape == (n_tiles, mp, tile_bins)

    hop, k = geo["hop"], w.shape[1]
    t = (s - k) // hop + 1
    frames = span_frames(torch.from_numpy(x).to(torch.bfloat16).double()
                         .numpy(), hop, k, n_kc * tile_k, t,
                         stft_conv.logmel_frames(hop, k))
    wimg = unswizzle(layout.w.double().numpy())    # [tiles, kc, 128, 64]
    fbimg = unswizzle(layout.fb.double().numpy())  # [tiles, mp, 64]
    mel = np.zeros((2, t, mp))
    for j in range(n_tiles):
        acc = sum(frames[..., c * tile_k:(c + 1) * tile_k] @ wimg[j, c].T
                  for c in range(n_kc))
        re, im = acc[..., :tile_bins], acc[..., tile_bins:]
        power = torch.from_numpy(re * re + im * im).float() \
            .to(torch.bfloat16).double().numpy()
        # Pass z projects onto columns z * pass_mp.. of the same image.
        for z in range(passes):
            cols = slice(z * pass_mp, (z + 1) * pass_mp)
            mel[..., cols] += power @ fbimg[j, cols].T
    got = np.log(mel[..., :fb.shape[1]] + 1e-6)
    want = stft_conv.fused_logmel_reference(
        torch.from_numpy(x), wt, fbt, hop, 1e-6).float().numpy()
    err = np.abs(got - want)
    assert np.quantile(err, 0.99) < Q99_BOUND
    assert err.max() < MAX_BOUND


@pytest.mark.parametrize("m", list(range(32, 257, 32)) + [1, 100, 320, 600])
@pytest.mark.parametrize("geo", [pytest.param(V24, id="v24"),
                                 pytest.param(V30, id="v30")])
def test_swizzled_images_unswizzle_to_the_weights(monkeypatch, geo, m):
    """Read back through the descriptor's swizzle formula, the images give
    ``w`` and ``fb`` exactly, zero-padded: chunk (j, c) row n < 64 is cos
    row 64 j + n, row 64 + n its -sin row, column k window position
    64 c + k; filterbank image j row n is mel column n of bins 64 j..."""
    monkeypatch.setattr(stft_conv, "_tiles", lambda: TILES)
    _, tb, tk = TILES
    w, _ = _frontend(geo["n_fft"], geo["banks"], geo["sample_rate"])
    bins, k = w.shape[0] // 2, w.shape[1]
    fb = np.random.default_rng(m).uniform(0, 1, (bins, m)).astype(np.float32)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    fbt = torch.from_numpy(fb).to(torch.bfloat16)
    layout = stft_conv.prepare_logmel_weights(wt, fbt)
    n_tiles, n_kc = layout.w.shape[:2]
    wimg = unswizzle(layout.w.double().numpy())
    fbimg = unswizzle(layout.fb.double().numpy())

    cos = np.zeros((n_tiles * tb, n_kc * tk))
    sin = np.zeros_like(cos)
    cos[:bins, :k] = wt[:bins].double().numpy()
    sin[:bins, :k] = wt[bins:].double().numpy()
    for j in range(n_tiles):
        for c in range(n_kc):
            rows, cols = slice(j * tb, (j + 1) * tb), slice(c * tk,
                                                            (c + 1) * tk)
            assert np.array_equal(wimg[j, c, :tb], cos[rows, cols])
            assert np.array_equal(wimg[j, c, tb:], sin[rows, cols])
    fbp = np.zeros((n_tiles * tb, fbimg.shape[1]))
    fbp[:bins, :m] = fbt.double().numpy()
    passes, pass_mp = stft_conv.mel_passes(m)
    assert fbimg.shape[1] == passes * pass_mp >= m
    assert pass_mp % 32 == 0 and pass_mp <= stft_conv.MAX_PASS_MELS
    assert (passes - 1) * pass_mp < m
    assert np.array_equal(fbimg.transpose(0, 2, 1).reshape(fbp.shape), fbp)


@pytest.mark.parametrize("hop", [278, 320, 279, 161, 16, 17, 1024, 2048,
                                 2224, 2561])
def test_frame_cursor_reads_every_frame_sample(hop):
    """The consumers' address arithmetic (strided_window_gemm.cuh::
    FrameCursor: rewind, then step16 per 16-deep step) finds window
    position k of frame r at r (row + pad) + k + pad (k / hop) of the
    padded span, for both registers' window positions k and k + 8 of every
    lane, where row is the hop or, for a hop past the window, the window
    alone; an even row keeps each register's pair 4-byte aligned."""
    k_pad = 2048
    row = stft_conv.span_row(hop, k_pad)
    pad = stft_conv.span_pad(row)
    assert row == min(hop, k_pad)
    assert pad % 2 == 0 and (row % 2 or row < 16 or (row + pad) // 2 % 8 == 4)
    for tq in range(4):
        ka, kb = 2 * tq, 2 * tq + 8
        ga = ka + (pad if ka >= hop else 0)
        ba = 2 * hop if ka >= hop else hop
        gb = kb + (pad if kb >= hop else 0)
        bb = 2 * hop if kb >= hop else hop
        while ka < k_pad:
            for k, g in ((ka, ga), (kb, gb)):
                for r in (0, 8, 127):
                    q = r * hop + k
                    assert q % hop < row  # a stored sample
                    want = (q // hop) * (row + pad) + q % hop
                    got = r * (row + pad) + g
                    if pad:  # the cursor assumes hop >= 16 when padding
                        assert got == want, (hop, tq, k, r)
                        assert got % 2 == 0
            ka, ga = ka + 16, ga + 16
            if ka >= ba:
                ga, ba = ga + pad, ba + hop
            kb, gb = kb + 16, gb + 16
            if kb >= bb:
                gb, bb = gb + pad, bb + hop


def test_span_budget_refuses_what_shared_memory_cannot_hold():
    """The block's shared memory at the main paths' geometries (128 frames
    per block), fewer frames where 128 do not fit (hop 1024 at K 2048: 64),
    and the typed refusal of a span that does not fit even one frame."""
    assert stft_conv.span_smem_bytes(278, 2048) < stft_conv.SMEM_LIMIT
    assert stft_conv.span_smem_bytes(
        320, 640, 2 * stft_conv.CONV_STAGING_BYTES) < stft_conv.SMEM_LIMIT
    assert stft_conv._span_args("fused_logmel", 278, 2048,
                                stft_conv.logmel_frames(278, 2048)) \
        == (278, stft_conv.span_pad(278), 128)
    assert stft_conv.span_smem_bytes(1024, 2048) > stft_conv.SMEM_LIMIT
    assert stft_conv.logmel_frames(1024, 2048) == 64
    assert stft_conv.span_smem_bytes(1024, 2048, 0, 64) \
        <= stft_conv.SMEM_LIMIT
    assert stft_conv.logmel_frames(90_000, 90_000) is None
    with pytest.raises(ValueError, match="shared memory"):
        stft_conv._span_args("fused_logmel", 90_000, 90_000, None)


def test_wrapper_reads_float32_and_bf16_signals_alike():
    """The wrapper makes no padded copy: the kernel reads the signal in
    its own dtype. A float32 signal and its bf16 rounding give the same
    result, and a signal shorter than one frame tile is taken."""
    x, w, fb = _case(V24, 6_000)
    xt, wt, fbt = (torch.from_numpy(a) for a in (x, w, fb))
    got32 = stft_conv.fused_logmel(xt, wt, fbt, V24["hop"], 1e-6)
    got16 = stft_conv.fused_logmel(xt.to(torch.bfloat16), wt, fbt,
                                   V24["hop"], 1e-6)
    assert got32.shape[1] == (6_000 - 2048) // V24["hop"] + 1 < TILES[0]
    assert torch.equal(got32, got16)


def test_layout_refuses_mismatched_or_too_wide_banks(monkeypatch):
    """A DFT weight whose rows are not twice the filterbank's bins, or a
    filterbank of no mel column, is refused; a bank wider than one pass of
    the register tiling is laid out in equal passes instead."""
    monkeypatch.setattr(stft_conv, "_tiles", lambda: TILES)
    with pytest.raises(ValueError, match="rows for"):
        stft_conv.prepare_logmel_weights(torch.zeros(10, 512),
                                         torch.zeros(6, 16))
    with pytest.raises(ValueError, match="at least one mel"):
        stft_conv.prepare_logmel_weights(torch.zeros(2 * 257, 512),
                                         torch.zeros(257, 0))
    wide = stft_conv.prepare_logmel_weights(
        torch.zeros(2 * 257, 512),
        torch.zeros(257, stft_conv.MAX_PASS_MELS + 1))
    assert (wide.passes, wide.pass_mp) == (2, 160)


@pytest.mark.slow
@pytest.mark.parametrize("geo", [pytest.param(V24, id="v24"),
                                 pytest.param(V30, id="v30")])
def test_card_kernel_matches_plain_version(geo):
    """On a CUDA card: the hand-written kernel against its plain version
    at full signal length (run on the card with ``BIRDA_TEST_TPU=1 python
    -m pytest tests/test_torch_stft_conv.py -k card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    dev = torch.device("cuda", 0)
    x, w, fb = _case(geo, 144_000 if geo is V24 else 160_000)
    x, w, fb = (torch.from_numpy(a).to(dev) for a in (x, w, fb))
    before = stft_conv.LAUNCHES["fused_logmel"]
    got = stft_conv.fused_logmel(x, w, fb, geo["hop"], 1e-6)
    torch.cuda.synchronize()
    assert stft_conv.LAUNCHES["fused_logmel"] == before + 1
    want = stft_conv.fused_logmel_reference(x, w, fb, geo["hop"], 1e-6)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().flatten()
    assert float(torch.quantile(err, 0.99)) < Q99_BOUND
    assert float(err.max()) < MAX_BOUND


@pytest.mark.slow
@pytest.mark.parametrize("m", list(range(32, 257, 32)))
@pytest.mark.parametrize("hop", [pytest.param(320, id="even-hop"),
                                 pytest.param(279, id="odd-hop")])
def test_card_kernel_every_mel_width_and_odd_hop(hop, m):
    """On a CUDA card: every mel width the register tiling holds, at an
    even and an odd hop, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    dev = torch.device("cuda", 0)
    w, _ = _frontend(1024, ((m, 50.0, 16_000.0),), 32_000)
    x = np.random.default_rng(m).normal(0, 0.1, (3, 40_000)) \
        .astype(np.float32)
    fb = np.random.default_rng(hop).uniform(0, 0.05, (513, m)) \
        .astype(np.float32)
    x, w, fb = (torch.from_numpy(a).to(dev) for a in (x, w, fb))
    got = stft_conv.fused_logmel(x, w, fb, hop, 1e-6)
    torch.cuda.synchronize()
    want = stft_conv.fused_logmel_reference(x, w, fb, hop, 1e-6)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().flatten()
    assert float(torch.quantile(err, 0.99)) < Q99_BOUND
    assert float(err.max()) < MAX_BOUND
