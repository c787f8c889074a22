"""The op families of the JAX evaluator's last 39 handlers (index and
scatter, normalization, spatial extras, bitwise; the transformer family;
If/Loop/Scan; the recurrent layers and the Lp normalizations) against the
JAX evaluator on the CPU: each case of ``tests/torch_op_cases.py``'s
``late_cases`` through both, at its family's bound (stated there), with the
same dtype kind for every value; the bf16 cases also with the same dtype at
every node; each typed refusal refused by both, with the same message;
and a second call of each case makes no host value for the device."""

import pytest
import torch

import torch_op_cases as oc
from torch_jax_parity import (assert_case_matches_jax,
                              assert_refused_as_in_jax,
                              assert_second_call_copies_no_host_value,
                              second_call_params)

LATE = oc.late_cases()
CASES = [c for c in LATE if not c.refused]
BF16 = [c for c in CASES if c.bf16]
REFUSED = [c for c in LATE if c.refused]


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


@pytest.mark.parametrize("c", REFUSED, ids=[c.id for c in REFUSED])
def test_refused_as_in_jax(c):
    assert_refused_as_in_jax(c)



@pytest.mark.parametrize("c,bf16", second_call_params(CASES))
def test_second_call_copies_no_host_value(c, bf16):
    assert_second_call_copies_no_host_value(c, bf16)
