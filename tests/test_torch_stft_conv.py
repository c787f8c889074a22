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
from pathlib import Path

import numpy as np
import pytest
import torch

from birda_tpu.ops.melspec import hann, mel_filterbank

from birda_tpu_torch.ops import stft_conv

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

# The release geometries with the real K, hop, bins and M; S shrunk.
GEOMETRIES = [
    pytest.param(V24, 20_000, id="v24-shape"),
    pytest.param(V30, 20_000, id="v30-shape"),
    pytest.param(V24, 6_000, id="v24-t-below-one-tile"),
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
    x = torch.empty((1, 4096), device="meta")
    w = torch.empty((2 * 257, 512))
    fb = torch.empty((257, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        stft_conv.fused_logmel(x, w, fb, 160, 1e-6)


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


@pytest.mark.parametrize("geo,s", GEOMETRIES)
def test_kernel_layout_reproduces_plain_version(monkeypatch, geo, s):
    """The padded, tiled weight layout the CUDA kernel reads, evaluated
    with the kernel's loop order (bin tiles, K chunks, bf16 power, mel
    accumulated across tiles) in float64, gives the plain version's
    log-mel: the padding and tiling lose nothing."""
    tile_t, tile_bins, tile_k = 64, 64, 64  # csrc/fused_logmel.cu
    monkeypatch.setattr(stft_conv, "_tiles",
                        lambda: (tile_t, tile_bins, tile_k))
    x, w, fb = _case(geo, s)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    fbt = torch.from_numpy(fb).to(torch.bfloat16)
    layout = stft_conv.prepare_logmel_weights(wt, fbt)
    n_tiles, n_kc = layout.w.shape[:2]
    assert layout.fb.shape == (n_tiles * tile_bins,
                               -(-fb.shape[1] // 32) * 32)

    hop, k = geo["hop"], w.shape[1]
    t = (s - k) // hop + 1
    sig = np.zeros((2, max(s, (t - 1) * hop + n_kc * tile_k)), np.float64)
    sig[:, :s] = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    frames = np.stack([sig[:, i * hop:i * hop + n_kc * tile_k]
                       for i in range(t)], axis=1)  # [B, T, Kp]
    wp = layout.w.double().numpy()
    fbp = layout.fb.double().numpy()
    mel = np.zeros((2, t, fbp.shape[1]))
    for j in range(n_tiles):
        acc = sum(frames[..., c * tile_k:(c + 1) * tile_k] @ wp[j, c]
                  for c in range(n_kc))
        re, im = acc[..., :tile_bins], acc[..., tile_bins:]
        power = torch.from_numpy(re * re + im * im).float() \
            .to(torch.bfloat16).double().numpy()
        mel += power @ fbp[j * tile_bins:(j + 1) * tile_bins]
    got = np.log(mel[..., :fb.shape[1]] + 1e-6)
    want = stft_conv.fused_logmel_reference(
        torch.from_numpy(x), wt, fbt, hop, 1e-6).float().numpy()
    err = np.abs(got - want)
    assert np.quantile(err, 0.99) < Q99_BOUND
    assert err.max() < MAX_BOUND


def test_layout_refuses_mismatched_or_too_wide_banks(monkeypatch):
    monkeypatch.setattr(stft_conv, "_tiles", lambda: (64, 64, 64))
    with pytest.raises(ValueError, match="rows for"):
        stft_conv.prepare_logmel_weights(torch.zeros(10, 512),
                                         torch.zeros(6, 16))
    with pytest.raises(ValueError, match="at most"):
        stft_conv.prepare_logmel_weights(
            torch.zeros(2 * 257, 512),
            torch.zeros(257, stft_conv.MAX_MELS + 1))


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
