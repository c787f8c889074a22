"""Runs one case of ``torch_op_cases`` through the JAX evaluator and the
port's on the CPU and holds them together: the same output count, shapes,
dtype kinds (bf16 is kind ``V`` in both) and values within the case
family's bound; on the bf16 route, also the same dtype at every node."""

from __future__ import annotations

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_op_cases as oc
from birda_tpu.onnx import lowering as jl
from birda_tpu.onnx import proto as jax_proto

from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.onnx.proto import load_model


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype) if not hasattr(v, "dtype") \
        else str(v.dtype)


def _kind(v) -> str:
    if isinstance(v, torch.Tensor):
        return tl._dtype_kind(v)
    return np.dtype(getattr(v, "dtype", np.asarray(v).dtype)).kind


class _Recorder:
    """Records (dtype name, dtype kind[, value]) of every stored value."""

    def __init__(self, *a, keep_values: bool = False, **k):
        super().__init__(*a, **k)
        self.keep_values = keep_values
        self.dtypes = {}

    def _store(self, name, val):
        rec = (_dtype_name(val), _kind(val))
        if self.keep_values:
            rec += (oc.to_numpy(val),)
        self.dtypes[name] = rec
        return val


class _JaxRecorder(_Recorder, jl._Evaluator):
    pass


class _TorchRecorder(_Recorder, tl._Evaluator):
    pass


def _outs(v):
    return v if isinstance(v, tuple) else (v,)


def run_jax(model: bytes, feeds, bf16: bool = False,
            keep_values: bool = False):
    m = jax_proto.load_model(model)
    ev = _JaxRecorder(m.graph, compute_dtype=jnp.bfloat16 if bf16 else None,
                      opset=m.opset, keep_values=keep_values)
    fn = jl.OnnxFunction(m, evaluator=ev)
    out = fn(*(jnp.asarray(f) for f in feeds), params=fn.params)
    return _outs(out), ev.dtypes


def run_port(model: bytes, feeds, bf16: bool = False, device="cpu",
             keep_values: bool = False):
    out, ev = oc.run_port(model, feeds, bf16, device, functools.partial(
        _TorchRecorder, keep_values=keep_values))
    return out, ev.dtypes


def assert_case_matches_jax(c: oc.Case, bf16: bool = False) -> None:
    model, feeds = oc.bf16_model(c) if bf16 else (c.model, c.feeds)
    want, jd = run_jax(model, feeds, bf16)
    got, td = run_port(model, feeds, bf16)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _kind(g) == _kind(w), f"output {i}: kind {_kind(g)} " \
            f"against {_kind(w)}"
        why = oc.mismatch(g, w, c.family, bf16=bf16)
        assert why is None, f"output {i}: {why}"
    if bf16:
        # The same dtype at every node (the port holds no 64-bit type on
        # the device, as jax with x64 off).
        assert {k: v[0] for k, v in td.items()} == \
            {k: v[0] for k, v in jd.items()}
    else:
        assert {k: v[1] for k, v in td.items()} == \
            {k: v[1] for k, v in jd.items()}


def assert_refused_as_in_jax(c: oc.Case) -> None:
    """A refusal case: both evaluators refuse it the same way, with the
    same message: ``lower`` raises the aggregate ``OnnxGraphUnsupported``
    (``c.refused == "preflight"``) or the call raises
    ``UnsupportedOnnxOp`` (``"run"``)."""
    import pytest

    from birda_tpu import errors as jax_errors

    from birda_tpu_torch import errors

    if c.refused == "preflight":
        with pytest.raises(jax_errors.OnnxGraphUnsupported) as want:
            jl.lower(c.model)
        with pytest.raises(errors.OnnxGraphUnsupported) as got:
            tl.lower(c.model)
    else:
        assert c.refused == "run", c.refused
        jfn, tfn = jl.lower(c.model), tl.lower(c.model)
        with pytest.raises(jl.UnsupportedOnnxOp) as want:
            jfn(*(jnp.asarray(f) for f in c.feeds), params=jfn.params)
        with pytest.raises(tl.UnsupportedOnnxOp) as got:
            tfn(*(torch.from_numpy(np.array(f)) for f in c.feeds))
    assert str(got.value) == str(want.value)


def second_call_params(cases) -> list:
    """pytest parameters ``(case, bf16)``: each case that runs, and its
    bf16 variant where it has one."""
    import pytest

    return [pytest.param(c, bf16, id=c.id + ("-bf16" if bf16 else ""))
            for c in cases if not c.refused
            for bf16 in ((False, True) if c.bf16 else (False,))]


def assert_second_call_copies_no_host_value(c: oc.Case,
                                            bf16: bool = False) -> None:
    """A step makes no host value for the device: on the card each host
    array turned into a tensor is a copy that syncs the step. A second call
    through one function with tensor inputs turns no host array into a
    tensor, and each host value it returns is the first call's object (a
    host value made afresh would be copied by every consumer)."""
    model, feeds = oc.bf16_model(c) if bf16 else (c.model, c.feeds)
    fn = tl.OnnxFunction(load_model(model),
                         compute_dtype=torch.bfloat16 if bf16 else None)
    params = {k: torch.from_numpy(np.array(v)) for k, v in fn.params.items()}
    args = [torch.from_numpy(np.array(f)) for f in feeds]
    first = _outs(fn(*args, params=params))
    made = []
    real = torch.from_numpy
    torch.from_numpy = lambda a: made.append(a.shape) or real(a)
    try:
        second = _outs(fn(*args, params=params))
    finally:
        torch.from_numpy = real
    assert not made, f"host arrays made tensors on the second call: {made}"
    for i, (a, b) in enumerate(zip(first, second)):
        if isinstance(b, np.ndarray):
            assert b is a, f"output {i}: a new host array on each call"


def _as_port_value(v):
    """A JAX evaluator value as the port holds it: jax arrays become CPU
    tensors (bf16 through float32, which holds it exactly), numpy stays."""
    if isinstance(v, (np.ndarray, np.generic, int, float, bool)) or v is None:
        return v
    a = np.asarray(v)
    if a.dtype.kind == "V":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def node_by_node(model: bytes, feeds, bf16: bool = False) -> dict:
    """Teacher forcing: the JAX evaluator runs the graph; then each node of
    the port runs on the JAX values of its inputs, and its outputs are held
    against the JAX outputs of that node (integer outputs exactly, floats
    within 1e-4, or ``BF16_BOUND`` of the largest magnitude on the bf16
    route). Returns the JAX environment. Parity at every node, free of the
    cascade by which one rounding difference upstream of a QuantizeLinear
    moves everything after it."""
    jm = jax_proto.load_model(model)
    jev = jl._Evaluator(jm.graph, compute_dtype=jnp.bfloat16 if bf16
                        else None, opset=jm.opset)
    jfn = jl.OnnxFunction(jm, evaluator=jev)
    env = dict(jfn.params)
    env.update({n: jnp.asarray(f) for n, f in zip(jfn.input_names, feeds)})
    env = jev.run(env)
    tm = load_model(model)
    tev = tl._Evaluator(tm.graph, compute_dtype=torch.bfloat16 if bf16
                        else None, opset=tm.opset)
    tev._persistent.update(id(v) for v in env.values()
                           if isinstance(v, np.ndarray))
    with tl._full_precision():
        for node in tm.graph.nodes:
            if node.op_type == "Constant":
                continue
            args = [_as_port_value(env[i]) if i else None
                    for i in node.inputs]
            got = tev._call(node, getattr(tev, f"op_{node.op_type}"), args)
            got = got if isinstance(got, tuple) else (got,)
            for name, g in zip(node.outputs, got):
                if not name:
                    continue
                w = env[name]
                assert _kind(g) == _kind(w), (node.op_type, name)
                why = oc.mismatch(g, w, "spatial", bf16=bf16)
                assert why is None, f"{node.op_type} {name}: {why}"
    return env


def tiny_qdq_perch():
    """The tiny Perch v2 graph (seed 1) and its QDQ form, the activation
    scales from one fp32 pass over two seeded 5 s signals."""
    import chip_smoke
    from birda_tpu.onnx import fullscale as fs

    g = fs.cached_build(fs.tiny_spec(fs.PERCH_V2_SPEC), seed=1)
    calib = np.random.default_rng(0).normal(
        0, 0.1, (2, g.spec.sample_count)).astype(np.float32)
    scales = chip_smoke.qdq_activation_scales(g.model_bytes, calib)
    return g, chip_smoke.qdq_graph(g.model_bytes, scales)


def signal(g, seed=1):
    return np.random.default_rng(seed).normal(
        0, 0.1, (2, g.spec.sample_count)).astype(np.float32)


def row_rel_err(got, want) -> float:
    """Largest error of each row over that row's top score."""
    got, want = oc.to_numpy(got), oc.to_numpy(want)
    return float((np.abs(got - want).max(-1) / want.max(-1)).max())
