"""Perch v2 in the QDQ form of its registry ``int8-arm`` variant
(``chip_smoke.qdq_graph``: uint8 Quantize/DequantizeLinear pairs on every
Conv, MatMul and Gemm input, int8 per-channel weights and int32 biases
behind DequantizeLinear) on the tiny spec, through both packages on the CPU
in fp32 (the bf16 route and ``analyze``: ``test_torch_qdq_bf16.py``;
``lower_int8``: ``test_torch_qdq_int8.py``):

- every node of the port on the JAX values of its inputs gives the JAX
  node's outputs (integers exactly, floats within 1e-4);
- end to end within 1e-4 of the top score, the same top 5;
- a second run folds nothing again and copies nothing to the device again
  (the design that keeps the card's step free of host syncs).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from torch_jax_parity import (node_by_node, row_rel_err, run_jax, run_port,
                              signal, tiny_qdq_perch)

from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.onnx.proto import load_model


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


def test_graph_is_the_qdq_form(perch):
    g, qdq = perch
    graph = load_model(qdq).graph
    arrays = {n: t.array for n, t in graph.initializers.items()}
    producers = {o: n for n in graph.nodes for o in n.outputs}
    products = [n for n in graph.nodes if n.op_type in chip_smoke.QDQ_OPS]
    assert len(products) == sum(
        n.op_type in chip_smoke.QDQ_OPS
        for n in load_model(g.model_bytes).graph.nodes)
    for node in products:
        x, w = (producers[i] for i in node.inputs[:2])
        assert x.op_type == "DequantizeLinear"
        assert producers[x.inputs[0]].op_type == "QuantizeLinear"
        assert arrays[x.inputs[2]].dtype == np.uint8
        assert w.op_type == "DequantizeLinear"
        wq, ws = arrays[w.inputs[0]], arrays[w.inputs[1]]
        assert wq.dtype == np.int8 and wq.min() >= -127
        assert ws.size == wq.shape[w.attr("axis")] > 1
        if len(node.inputs) > 2:
            assert arrays[producers[node.inputs[2]].inputs[0]].dtype == \
                np.int32
    assert all(n.endswith("_scale") for n, a in arrays.items()
               if a.dtype == np.float32 and a.size > 1000)


def test_fp32_matches_jax(perch):
    """Node by node; then end to end within 1e-4 of the top score, on an
    input where no activation lands within fp32 rounding of a quantization
    boundary (asserted: every QuantizeLinear output is equal in both
    packages). Where one does, the two round it one step apart and the step
    propagates: the evaluators' fp32 rounding (1e-7), not their
    semantics, which the node-by-node check holds."""
    g, qdq = perch
    x = signal(g)
    node_by_node(qdq, [x])
    (js, je), jd = run_jax(qdq, [x], keep_values=True)
    (ts, te), td = run_port(qdq, [x], keep_values=True)
    quantized = [n.outputs[0] for n in load_model(qdq).graph.nodes
                 if n.op_type == "QuantizeLinear"]
    assert len(quantized) == 31
    for name in quantized:
        assert np.array_equal(td[name][2], jd[name][2]), name
    assert tuple(ts.shape) == (2, g.spec.num_classes)
    assert row_rel_err(ts, js) <= 1e-4
    assert np.abs(te.numpy() - np.asarray(je)).max() <= \
        1e-4 * np.abs(np.asarray(je)).max()
    assert np.array_equal(np.argsort(-ts.numpy(), 1)[:, :5],
                          np.argsort(-np.asarray(js), 1)[:, :5])


def test_second_run_folds_and_copies_nothing_again(perch):
    """Every DequantizeLinear of a host weight or bias folds once and its
    value is kept: the second call recomputes no fold and makes no new
    device copy (on the card, each would be a host sync per step)."""
    g, qdq = perch
    fn = tl.lower(qdq, compute_dtype=torch.bfloat16)
    ev = fn._eval
    params = {k: torch.from_numpy(np.array(v)) for k, v in fn.params.items()}
    x = torch.from_numpy(signal(g))
    fn(x, params=params)
    folds = {k: v[1] for k, v in ev._memos.items()}
    copies = dict(ev._device_copies)
    assert len(folds) >= 30
    fn(x, params=params)
    assert {k: v[1] for k, v in ev._memos.items()}.keys() == folds.keys()
    assert all(ev._memos[k][1] is v for k, v in folds.items())
    assert ev._device_copies.keys() == copies.keys()
