"""The ported ONNX op families, structure/shape and elementwise/logic,
against the JAX evaluator on the CPU: each case of
``tests/torch_op_cases.py`` through both, at its family's bound (stated
there), with the same dtype kind for every value; the bf16 cases also with
the same dtype at every node; and a second call of each case makes no host
value for the device (on the card, a copy and a sync per step)."""

import numpy as np
import pytest
import torch

import torch_op_cases as oc
from torch_jax_parity import (assert_case_matches_jax,
                              assert_second_call_copies_no_host_value,
                              second_call_params)

CASES = oc.structure_cases() + oc.elementwise_cases()
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


#: The port's handlers for the full-scale graphs' own op set.
EARLIER = {"Add", "Sub", "Mul", "Div", "Sqrt", "Log", "Sigmoid", "Softmax",
           "Flatten", "Transpose", "Squeeze", "Unsqueeze", "Concat", "Slice",
           "ReduceMean", "GlobalAveragePool", "MatMul", "Gemm", "Conv",
           "BirdaFusedMelFrontend", "DFT", "BatchNormalization"}


def test_every_ported_handler_has_a_case():
    """The port's handlers are the JAX evaluator's, all 178; the 156 beyond
    the full-scale graphs' own op set are each exercised by a case of the
    table that runs."""
    from birda_tpu.onnx import lowering as jl

    from birda_tpu_torch.onnx import lowering as tl
    from birda_tpu_torch.onnx.proto import load_model

    port = {n[3:] for n in dir(tl._Evaluator) if n.startswith("op_")}
    assert port == {n[3:] for n in dir(jl._Evaluator) if n.startswith("op_")}
    assert len(port) == 178 and EARLIER <= port
    covered = {n.op_type for c in oc.all_cases() if not c.refused
               for n in load_model(c.model).graph.nodes}
    new = port - EARLIER
    assert len(new) == 156
    assert new <= covered, sorted(new - covered)


REFUSED = [  # op, node inputs, the device input's value, other initializers
    ("Reshape", ["x", "p"], np.array([4, 6], np.int64), {}),
    ("Expand", ["x", "p"], np.array([2, 4, 6], np.int64), {}),
    ("Tile", ["x", "p"], np.array([1, 2], np.int64), {}),
    ("Split", ["x", "p"], np.array([1, 3], np.int64), {}),
    ("Trilu", ["x", "p"], np.array(1, np.int64), {}),
    ("Pad", ["x", "p"], np.array([0, 1, 0, 1], np.int64), {}),
    ("CumSum", ["x", "p"], np.array(0, np.int64), {}),
    ("TopK", ["x", "p"], np.array([2], np.int64), {}),
    ("ReduceSum", ["x", "p"], np.array([1], np.int64), {}),
    ("Resize", ["x", "", "p"], np.array([1.0, 2.0], np.float32), {}),
    ("ConstantOfShape", ["p"], np.array([2, 3], np.int64), {}),
]


@pytest.mark.parametrize("op,ins,value,inits", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_device_shape_parameter_is_refused_unread(op, ins, value, inits):
    """A shape or static parameter that is a device value (here a graph
    input) is refused with UnsupportedOnnxOp and never read: a read would
    sync the card every step, and the JAX evaluator's jit trace refuses
    it too."""
    import torch as _torch

    from birda_tpu_torch.onnx import lowering as tl

    feeds = {"x": np.arange(24, dtype=np.float32).reshape(4, 6),
             "p": value}
    feeds = {k: v for k, v in feeds.items() if k in ins}
    outs = 2 if op in ("Split", "TopK") else 1
    mb, fv = oc.graph(op, ins, feeds, inits, outs=outs, opset=18)
    fn = tl.lower(mb)
    with pytest.raises(tl.UnsupportedOnnxOp, match="device value"):
        fn(*(_torch.from_numpy(v) for v in fv))


FAILS_IN_BOTH = [  # op, node inputs, feeds, initializers, attrs, outputs
    ("Pad", ["x", "p"], {"x": np.ones((3, 4), np.float32)},
     {"p": np.array([1, -1, 0, 2], np.int64)}, [], 1),
    ("Split", ["x"], {"x": np.ones((5, 2), np.float32)}, {}, [], 2),
]


@pytest.mark.parametrize("op,ins,feeds,inits,attrs,outs", FAILS_IN_BOTH,
                         ids=["pad-negative", "split-uneven"])
def test_fails_with_a_value_error_as_in_jax(op, ins, feeds, inits, attrs,
                                            outs):
    """jnp.pad refuses a negative pad and jnp.split an uneven split into
    equal parts, with a ValueError; the port does the same, on the device
    path and on the host fold."""
    import jax.numpy as jnp

    from birda_tpu.onnx import lowering as jl

    from birda_tpu_torch.onnx import lowering as tl

    mb, fv = oc.graph(op, ins, feeds, inits, attrs, outs=outs, opset=18)
    with pytest.raises(ValueError):
        jl.lower(mb)(*(jnp.asarray(v) for v in fv))
    with pytest.raises(ValueError):
        tl.lower(mb)(*(torch.from_numpy(v) for v in fv))
    host, _ = oc.graph(op, ins, {}, {**feeds, **inits}, attrs, outs=outs,
                       opset=18)
    with pytest.raises(ValueError):
        jl.lower(host)()
    with pytest.raises(ValueError):
        tl.lower(host)()
