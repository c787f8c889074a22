"""``--precision int8`` and ``mixed`` on Perch v2's QDQ form
(``chip_smoke.qdq_graph`` on the tiny spec) do what the JAX package does:
``lower_int8``'s selection report (no Conv, MatMul or Gemm has an
initializer weight, so each is skipped as structural) and its scores, both
packages on the CPU at fp32 compute."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_jax_parity import row_rel_err, signal, tiny_qdq_perch
from birda_tpu.onnx import quantize as jq

from birda_tpu_torch.onnx import quantize as tq


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def perch():
    return tiny_qdq_perch()


@pytest.mark.parametrize("policy", ["all", "storage"])
def test_lower_int8_on_the_qdq_graph_matches_jax(perch, policy):
    """--precision int8 (policy all) and mixed (storage) on an
    already-quantized graph: no Conv, MatMul or Gemm has an initializer
    weight, so each is skipped as structural in both packages, with the same
    boundary tensors and scores."""
    g, qdq = perch
    batches = list(jq.calibration_signals(g.spec.sample_count, batch=2,
                                          n_batches=1))
    jcal = jq.calibrate(qdq, batches, min_weight_bytes=1)
    jfn = jq.lower_int8(qdq, jcal, compute_dtype=jnp.float32,
                        min_weight_bytes=1, boundary_store=policy)
    tfn = tq.lower_int8(qdq, tq.CalibrationResult.from_json(jcal.to_json()),
                        min_weight_bytes=1, boundary_store=policy)
    assert tfn.quantized_nodes == jfn.quantized_nodes == []
    assert tfn.skipped_nodes == jfn.skipped_nodes
    assert set(tfn.skipped_nodes.values()) == {"structural"}
    assert tfn.int8_boundary_tensors == jfn.int8_boundary_tensors
    assert tfn.smoothed_tensors == jfn.smoothed_tensors
    x = signal(g)
    want = jfn(x, params=jfn.params)[0]
    got = tfn(torch.from_numpy(x))[0]
    if policy == "all":
        # Nothing quantizes or is stored int8: the fp32 graph itself.
        assert not tfn.int8_boundary_tensors
        assert row_rel_err(got, want) <= 1e-4
    else:
        # The int8 storage of boundary tensors rounds more values onto a
        # grid, and one landing within fp32 rounding of a step is one step
        # apart in the two packages: the bf16 bound, the same argmax.
        assert tfn.int8_boundary_tensors
        assert row_rel_err(got, want) <= 2e-2
        assert np.array_equal(got.numpy().argmax(-1),
                              np.asarray(want).argmax(-1))
