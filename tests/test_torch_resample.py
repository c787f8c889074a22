"""Device resampler of the PyTorch port (birda_tpu_torch/ops/resample.py)
against the JAX package's host reference ``resample_numpy``.

Both forms — the strided convolution over the L-dilated signal for small
ratios and the blocked-matmul form for any ratio — use the same filter as
the reference and accumulate in fp32: the bound is fp32 rounding, 1e-5.
"""

import numpy as np
import pytest
import torch

from birda_tpu.ops.resample import resample_numpy

from birda_tpu_torch.ops import resample


@pytest.mark.parametrize("from_rate,to_rate,form", [
    pytest.param(44_100, 48_000, "_device_fn_blocked", id="44k1-to-48k"),
    pytest.param(32_000, 48_000, "_device_fn", id="32k-to-48k"),
    pytest.param(48_000, 32_000, "_device_fn", id="48k-to-32k"),
])
def test_matches_numpy_reference(monkeypatch, from_rate, to_rate, form):
    calls = []
    real = getattr(resample, form)
    monkeypatch.setattr(resample, form,
                        lambda *a: calls.append(a) or real(*a))
    rng = np.random.default_rng(0)
    t = np.arange(from_rate) / from_rate  # one second
    x = np.stack([
        0.5 * np.sin(2 * np.pi * 3000 * t) + rng.normal(0, 0.05, t.shape),
        rng.normal(0, 0.3, t.shape),
    ]).astype(np.float32)
    got = resample.resample_device(torch.from_numpy(x), from_rate, to_rate)
    want = np.stack([resample_numpy(row, from_rate, to_rate) for row in x])
    assert calls, f"{form} was not the form taken"
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_identity_rate_is_a_no_op():
    x = torch.randn(2, 1000)
    assert resample.resample_device(x, 48_000, 48_000) is x
