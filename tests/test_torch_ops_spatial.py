"""The ported ONNX op families, reductions/selection, spatial and signal,
against the JAX evaluator on the CPU: each case of
``tests/torch_op_cases.py`` through both, at its family's bound (stated
there), with the same dtype kind for every value; the bf16 cases also with
the same dtype at every node; and a second call of each case makes no host
value for the device (on the card, a copy and a sync per step)."""

import pytest
import torch

import torch_op_cases as oc
from torch_jax_parity import (assert_case_matches_jax,
                              assert_second_call_copies_no_host_value,
                              second_call_params)

CASES = oc.reduction_cases() + oc.spatial_cases() + oc.signal_cases()
BF16 = [c for c in CASES if c.bf16]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("c", CASES, ids=[c.id for c in CASES])
def test_matches_jax(c):
    assert_case_matches_jax(c)


@pytest.mark.parametrize("c", BF16, ids=[c.id for c in BF16])
def test_bf16_matches_jax(c):
    assert_case_matches_jax(c, bf16=True)


@pytest.mark.parametrize("c,bf16", second_call_params(CASES))
def test_second_call_copies_no_host_value(c, bf16):
    assert_second_call_copies_no_host_value(c, bf16)


def test_grouped_conv_transpose_fails_as_in_jax():
    """The JAX evaluator's transposed conv reads an ONNX ``[C_in,
    C_out/group, ...]`` weight as lax's "IO" layout, which has no grouped
    form: ``group > 1`` fails there with a ValueError, and the port refuses
    it with one too (a reference quirk, ROADMAP C)."""
    import numpy as np

    import jax.numpy as jnp

    from birda_tpu.onnx import lowering as jl

    from birda_tpu_torch.onnx import lowering as tl

    mb, feeds = oc.graph(
        "ConvTranspose", ["x", "w"],
        {"x": np.ones((1, 4, 5, 5), np.float32)},
        {"w": np.ones((4, 2, 3, 3), np.float32)},
        attrs=[oc.A("group", 2)])
    with pytest.raises(ValueError):
        jl.lower(mb)(jnp.asarray(feeds[0]))
    with pytest.raises(ValueError, match="group=2"):
        tl.lower(mb)(torch.from_numpy(feeds[0]))
