"""Conv1d-STFT of the PyTorch port (birda_tpu_torch/ops/stft_conv.py::
conv1d_stft) against the JAX package's Pallas kernel
(birda_tpu/ops/stft_conv.py::conv1d_stft).

On the CPU the port's wrapper takes its plain PyTorch version; the JAX
kernel runs in interpret mode. Both use the same bf16 operands and fp32
sums, so they differ only in the order of the fp32 additions: the bound is
the JAX package's own, max error over max |want| < 2e-2
(tests/test_stft_kernel.py). With Perch v2's identity framing weight every
output is one bf16 sample times 1, so both must give the bf16 frames
exactly. The CUDA kernel itself is held against the plain version on a
card only.
"""

import types

import numpy as np
import pytest
import torch

from birda_tpu_torch.ops import stft_conv
from torch_kernel_layout import span_frames, unswizzle

REL_BOUND = 2e-2

# (B, S, K, hop, C): the JAX kernel tests' v2.4 / v3.0 / Perch geometries
# (S and C shrunk; the tiling depends on K and hop), T below one tile, and
# hops whose span of 128 frames a block cannot hold, which the kernel takes
# in fewer frames per block (64 at hop 512 and 1024, 64 with rows of the
# window alone where the hop is longer than it, 8 at an 8192 window).
GEOMETRIES = [
    pytest.param(3, 20_000, 2048, 278, 66, id="v24-shape"),
    pytest.param(3, 20_000, 1024, 320, 34, id="v30-shape"),
    pytest.param(3, 20_000, 640, 320, 640, id="perch-frame-shape"),
    pytest.param(2, 6_000, 2048, 278, 40, id="short-t"),
    pytest.param(2, 40_000, 2048, 512, 66, id="hop512-64-frames"),
    pytest.param(2, 80_000, 1024, 1024, 34, id="hop1024-64-frames"),
    pytest.param(2, 200_000, 640, 2560, 40, id="hop-past-window"),
    pytest.param(1, 90_000, 8192, 8192, 8, id="window8192-8-frames"),
]


def test_frames_per_block_at_the_wide_geometries():
    """The frames per block these cases take: what the layout test below
    walks, and what the card runs."""
    assert [stft_conv.conv1d_frames(h, k) for k, h in (
        (2048, 278), (640, 320), (2048, 512), (1024, 1024), (640, 2560),
        (8192, 8192))] == [128, 128, 64, 64, 64, 8]


def _case(b, s, k, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s)).astype(np.float32)
    w = rng.normal(0, 0.02, (c, k)).astype(np.float32)
    return x, w


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("b,s,k,hop,c", GEOMETRIES)
def test_plain_version_matches_jax_kernel(b, s, k, hop, c):
    from birda_tpu.ops.stft_conv import conv1d_stft as jax_conv1d_stft

    x, w = _case(b, s, k, c)
    want = np.asarray(jax_conv1d_stft(x, w, hop=hop, interpret=True),
                      np.float32)
    got = stft_conv.conv1d_stft(torch.from_numpy(x), torch.from_numpy(w), hop)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == (b, c, (s - k) // hop + 1)
    err = np.abs(got.float().numpy() - want).max()
    assert err / np.abs(want).max() < REL_BOUND


def test_identity_weight_gives_the_bf16_frames_exactly():
    """Perch v2's framer: both packages return the bf16 frames, bit for
    bit."""
    from birda_tpu.ops.stft_conv import conv1d_stft as jax_conv1d_stft

    k, hop = 640, 320
    x, _ = _case(2, 20_000, k, 1)
    eye = np.eye(k, dtype=np.float32)
    t = (x.shape[1] - k) // hop + 1
    frames = np.stack([_bf16(x)[:, i * hop:i * hop + k] for i in range(t)],
                      axis=2)  # [B, K, T]
    got = stft_conv.conv1d_stft(torch.from_numpy(x), torch.from_numpy(eye),
                                hop)
    want = np.asarray(jax_conv1d_stft(x, eye, hop=hop, interpret=True),
                      np.float32)
    assert np.array_equal(want, frames)
    assert np.array_equal(got.float().numpy(), frames)


def test_cpu_tensor_takes_plain_version_without_launch():
    x, w = _case(2, 8_000, 512, 16)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    before = stft_conv.LAUNCHES["conv1d_stft"]
    got = stft_conv.conv1d_stft(x, w, 160)
    assert torch.equal(got, stft_conv.conv1d_stft_reference(x, w, 160))
    assert stft_conv.LAUNCHES["conv1d_stft"] == before


def test_other_devices_raise():
    """A meta tensor gets the output's shape alone (the int8 cost report
    runs the graph on meta tensors); any device but the CPU, the card and
    meta is refused."""
    meta = torch.device("meta")
    w = torch.empty((8, 512), device=meta)
    out = stft_conv.conv1d_stft(torch.empty((3, 4096), device=meta), w, 160)
    assert out.device == meta and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (3, 8, (4096 - 512) // 160 + 1)
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        stft_conv.conv1d_stft(other, w, 160)


TILES = (128, 128, 64)  # csrc/conv1d_stft.cu: TILE_T, TILE_C, TILE_K


@pytest.mark.parametrize("b,s,k,hop,c", GEOMETRIES)
def test_kernel_layout_reproduces_plain_version(monkeypatch, b, s, k, hop,
                                                c):
    """The swizzled weight images the CUDA kernel reads, read back through
    the descriptor's swizzle and walked in the kernel's order (frames from
    the padded span with window positions past K zeroed, channel tiles, K
    chunks) in float64, give the plain version: the padding, tiling and
    swizzle lose nothing."""
    monkeypatch.setattr(stft_conv, "_conv_tiles", lambda: TILES)
    _, tile_c, tile_k = TILES
    x, w = _case(b, s, k, c)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    layout = stft_conv.prepare_conv1d_weights(wt)
    n_ct, n_kc = layout.w.shape[:2]
    assert layout.w.shape == (n_ct, n_kc, tile_c, tile_k)
    assert (n_ct * tile_c >= c > (n_ct - 1) * tile_c
            and n_kc * tile_k >= k > (n_kc - 1) * tile_k)

    t = (s - k) // hop + 1
    frames = span_frames(_bf16(x).astype(np.float64), hop, k,
                         n_kc * tile_k, t,
                         stft_conv.conv1d_frames(hop, k))  # [B, T, Kp]
    wimg = unswizzle(layout.w.double().numpy())  # [n_ct, n_kc, Cp, Kp]
    out = np.concatenate([
        sum(frames[..., j * tile_k:(j + 1) * tile_k] @ wimg[ct, j].T
            for j in range(n_kc))
        for ct in range(n_ct)], axis=-1)  # [B, T, Cp]
    got = out[..., :c].transpose(0, 2, 1)
    want = stft_conv.conv1d_stft_reference(
        torch.from_numpy(x), wt, hop).float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < REL_BOUND


@pytest.mark.parametrize("b,s,k,hop,c", GEOMETRIES)
def test_swizzled_images_unswizzle_to_the_weight(monkeypatch, b, s, k, hop,
                                                 c):
    """Read back through the descriptor's swizzle formula, image (ct, j)
    is exactly the bf16 weight's channels 128 ct.. and window positions
    64 j.., zero-padded past C and K."""
    monkeypatch.setattr(stft_conv, "_conv_tiles", lambda: TILES)
    _, tile_c, tile_k = TILES
    _, w = _case(b, s, k, c)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    layout = stft_conv.prepare_conv1d_weights(wt)
    n_ct, n_kc = layout.w.shape[:2]
    padded = np.zeros((n_ct * tile_c, n_kc * tile_k))
    padded[:c, :k] = wt.double().numpy()
    wimg = unswizzle(layout.w.double().numpy())
    for ct in range(n_ct):
        for j in range(n_kc):
            assert np.array_equal(
                wimg[ct, j], padded[ct * tile_c:(ct + 1) * tile_c,
                                    j * tile_k:(j + 1) * tile_k])
    # The images really are swizzled: as stored they are not the tiles.
    assert not np.array_equal(layout.w.double().numpy(), wimg)


def test_wrapper_reads_float32_and_bf16_signals_alike():
    """The wrapper makes no padded copy: the kernel reads the signal in
    its own dtype. A float32 signal and its bf16 rounding give the same
    result, and a signal shorter than one frame tile is taken."""
    x, w = _case(2, 6_000, 2048, 40)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got32 = stft_conv.conv1d_stft(xt, wt, 278)
    got16 = stft_conv.conv1d_stft(xt.to(torch.bfloat16), wt, 278)
    assert got32.shape[2] == (6_000 - 2048) // 278 + 1 < TILES[0]
    assert torch.equal(got32, got16)


def test_layout_refuses_a_weight_that_is_not_two_dimensional(monkeypatch):
    monkeypatch.setattr(stft_conv, "_conv_tiles", lambda: TILES)
    with pytest.raises(ValueError, match=r"\[C, K\]"):
        stft_conv.prepare_conv1d_weights(torch.zeros(8, 1, 512))


@pytest.mark.slow
@pytest.mark.parametrize("b,s,k,hop,c", [
    pytest.param(32, 160_000, 640, 320, 640, id="perch"),
    pytest.param(4, 144_000, 2048, 278, 2050, id="v24"),
    pytest.param(2, 6_000, 2048, 278, 40, id="short-t"),
    pytest.param(2, 20_000, 1000, 161, 200, id="odd-hop"),
])
def test_card_kernel_matches_plain_version(b, s, k, hop, c):
    """On a CUDA card: the hand-written kernel against its plain version
    (run on the card with ``BIRDA_TEST_TPU=1 python -m pytest
    tests/test_torch_conv1d_stft.py -k card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    dev = torch.device("cuda", 0)
    x, w = (torch.from_numpy(a).to(dev) for a in _case(b, s, k, c))
    before = stft_conv.LAUNCHES["conv1d_stft"]
    got = stft_conv.conv1d_stft(x, w, hop)
    torch.cuda.synchronize()
    assert stft_conv.LAUNCHES["conv1d_stft"] == before + 1
    want = stft_conv.conv1d_stft_reference(x, w, hop)
    assert got.shape == want.shape
    err = (got.float() - want.float()).abs().max()
    assert float(err / want.float().abs().max()) < REL_BOUND
    eye = torch.eye(k, device=dev)
    assert torch.equal(stft_conv.conv1d_stft(x, eye, hop),
                       stft_conv.conv1d_stft_reference(x, eye, hop))
