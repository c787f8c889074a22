"""The spectrogram transformer of ``tests/torch_seq_graphs.py`` (BirdNET
v3.0's contract: its front end, a patch embedding, the encoder as one
scan-over-layers Loop of ORT-optimizer layers, the head behind an If) at
its tiny size, through the port against the JAX package on the CPU:

- ``lower()`` of both on the same seeded input, with the JAX params dict
  carried into the port: fp32 within 1e-4 per score; bf16 (the JAX
  front-end through its Pallas kernel in interpret mode) within 2e-2 of
  the largest score;
- ``api.analyze`` of both on one short recording: the same detections,
  confidences within 1e-4 (fp32);
- the two repairs of the control-flow port: a Loop body's folds are made
  once per iteration (host arithmetic on the iteration number gives that
  iteration's value, and a second call adds no fold, persistent array or
  device copy), and threads that share one function (``--jobs``) get the
  sequential result;
- int8: the body runs on the stock float evaluator (only top-level nodes
  quantize), with the JAX package's selection and scores.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fixtures_onnx as fo
import torch_seq_graphs as sg
from fixtures_audio import write_wav

from birda_tpu.onnx import lowering as jl

from birda_tpu_torch.models import zoo
from birda_tpu_torch.models.zoo import synthetic_labels
from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.onnx.fuse import FUSED_OP

CONF_BOUND = 1e-4


@pytest.fixture(scope="module")
def tiny():
    return sg.build(sg.TINY, seed=1)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signal(rows=2, seed=0):
    return np.random.default_rng(seed).normal(
        0, 0.1, (rows, sg.TINY.frontend.sample_count)).astype(np.float32)


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v, np.float32)


def test_graph_has_the_contract_and_the_forms(tiny):
    from birda_tpu_torch.onnx.proto import load_model

    g = load_model(tiny.model_bytes).graph
    ops = [n.op_type for n in g.nodes]
    assert ops.count("Loop") == 1 and ops.count("If") == 1
    assert [vi.name for vi in g.inputs] == ["waveform"]
    assert [vi.name for vi in g.outputs] == ["predictions", "embeddings"]
    body = next(n for n in g.nodes if n.op_type == "Loop").attrs["body"].g
    assert {"MultiHeadAttention", "FusedMatMul", "SkipLayerNormalization",
            "BiasGelu", "Gather"} <= {n.op_type for n in body.nodes}
    assert tiny.tokens == 10
    assert sg._token_grid(sg.FULL)[1:] == (49, 12)


def test_fp32_matches_jax_with_params_carried(tiny):
    """The body's large head weight lifts under the JAX lowering's name,
    so the JAX params dict carries across unchanged."""
    x = _signal()
    jfn = jl.lower(tiny.model_bytes)
    want_p, want_e = (_np(v) for v in jfn(x, params=jfn.params))
    tfn = tl.lower(tiny.model_bytes)
    assert set(tfn.params) == set(jfn.params)
    assert "head_w" in tfn.params and tfn._eval.lifted_params == {"head_w"}
    got_p, got_e = (_np(v) for v in tfn(
        torch.from_numpy(x), params=zoo.params_from_numpy(jfn.params, "cpu")))
    assert got_p.shape == (2, 11_560) and got_e.shape == (2, sg.TINY.hidden)
    assert np.abs(got_p - want_p).max() <= 1e-4
    assert np.abs(got_e - want_e).max() <= 1e-4
    assert np.array_equal(np.argsort(-got_p, 1)[:, :5],
                          np.argsort(-want_p, 1)[:, :5])


def test_bf16_matches_jax(tiny, monkeypatch):
    """bf16: the JAX front-end through its Pallas kernel in interpret
    mode, the port's through the kernel's plain version."""
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    x = _signal()
    jfn = jl.lower(tiny.model_bytes, compute_dtype=jnp.bfloat16)
    assert any(n.op_type == FUSED_OP for n in jfn.graph.nodes)
    want = _np(jfn(x, params={k: np.asarray(v, jnp.bfloat16)
                              for k, v in jfn.params.items()})[0])
    tfn = tl.lower(tiny.model_bytes, compute_dtype=torch.bfloat16)
    assert any(n.op_type == FUSED_OP for n in tfn.graph.nodes)
    got = _np(tfn(torch.from_numpy(x), params=zoo.params_from_numpy(
        tfn.params, "cpu", torch.bfloat16))[0])
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_analyze_matches_jax(tiny, tmp_path, monkeypatch):
    import birda_tpu.api as jax_api

    import birda_tpu_torch.api as torch_api

    for var in ("XDG_CONFIG_HOME", "XDG_CACHE_HOME", "XDG_DATA_HOME"):
        monkeypatch.setenv(var, str(tmp_path / var.lower()))
    model = tmp_path / "seq-transformer-tiny.onnx"
    model.write_bytes(tiny.model_bytes)
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(synthetic_labels(11_560)) + "\n")
    rate = 32_000
    t = np.arange(rate * 10) / rate
    x = 0.3 * np.sin(2 * np.pi * (1800 + 400 * t) * t) \
        + np.random.default_rng(2).normal(0, 0.05, t.shape)
    wav = tmp_path / "rec_32k.wav"
    write_wav(wav, x.astype(np.float32), rate)
    kw = dict(model_path=model, labels_path=labels, model_type="birdnet-v30",
              min_confidence=0.2, device="cpu")
    want = jax_api.analyze([wav], **kw)
    got = torch_api.analyze([wav], **kw)
    assert got.exit_code == want.exit_code == 0
    assert got.summary["total_segments"] == 2
    rows = [[(d.start_time, d.end_time, d.scientific_name, d.confidence)
             for d in r.files[0].detections] for r in (got, want)]
    assert rows[1], "no detections"
    assert [r[:3] for r in rows[0]] == [r[:3] for r in rows[1]]
    assert max(abs(a[3] - b[3]) for a, b in zip(*rows)) <= CONF_BOUND


def _slicing_loop():
    """A Loop whose body gathers and slices an outer host table by the
    iteration number (host folds) and multiplies the device carry by the
    row: v_i = v_{i-1} * table[i], trace_i = table[i:i+1] + v_i."""
    body = fo.graph(
        [fo.node("Identity", ["cond_in"], ["cond_out"]),
         fo.node("Gather", ["table", "it"], ["row"]),
         fo.node("Add", ["it", "one"], ["it1"]),
         fo.node("Slice", ["table", "it", "it1"], ["rows"]),
         fo.node("Mul", ["v", "row"], ["v_out"]),
         fo.node("Add", ["rows", "v_out"], ["trace"])],
        inputs=[fo.value_info("it", [], elem_type=7),
                fo.value_info("cond_in", [], elem_type=9),
                fo.value_info("v", [3])],
        outputs=[fo.value_info("cond_out", [], elem_type=9),
                 fo.value_info("v_out", [3]),
                 fo.value_info("trace", [1, 3])])
    table = np.random.default_rng(5).uniform(0.5, 2.0, (4, 3)) \
        .astype(np.float32)
    mb = fo.model(
        [fo.node("Loop", ["m", "", "v0"], ["v_final", "traces"],
                 attrs=[fo.attr_graph("body", body)])],
        inputs=[fo.value_info("v0", [3])],
        outputs=[fo.value_info("v_final", [3]),
                 fo.value_info("traces", [4, 1, 3])],
        initializers=[fo.tensor("m", np.array(4, np.int64)),
                      fo.tensor("table", table),
                      fo.tensor("one", np.array(1, np.int64))])
    return mb, table


def test_loop_body_folds_once_per_iteration():
    """The body's folds on the iteration number give each iteration its
    own value (memoized per iteration, not per node), and a later call
    finds them all: no fold, persistent array or device copy is added."""
    mb, table = _slicing_loop()
    fn = tl.lower(mb)
    ev = fn._eval

    def expect(v0):
        v, traces = v0.copy(), []
        for i in range(4):
            v = v * table[i]
            traces.append(table[i:i + 1] + v)
        return v, np.stack(traces)

    sizes = []
    for seed in range(3):
        v0 = np.random.default_rng(seed).normal(size=3).astype(np.float32)
        v, traces = fn(torch.from_numpy(v0))
        want_v, want_t = expect(v0)
        assert isinstance(v, torch.Tensor)
        np.testing.assert_array_equal(v.numpy(), want_v)
        np.testing.assert_array_equal(traces.numpy(), want_t)
        sizes.append((len(ev._memos), len(ev._persistent),
                      len(ev._device_copies)))
    assert sizes[1] == sizes[2] == sizes[0]
    # Four iterations, each with its own condition, Gather, Add and Slice
    # fold.
    assert sum(1 for k in ev._memos if k[1]) == 16


def test_threads_stress_one_loop_function():
    """More threads than cores on one Loop function, with a short switch
    interval: every call gets its own iterations' values."""
    import os
    import sys

    fn = tl.lower(_slicing_loop()[0])
    n_threads = (os.cpu_count() or 1) + 4
    v0s = [torch.from_numpy(np.random.default_rng(s).normal(size=3)
                            .astype(np.float32)) for s in range(n_threads)]
    want = [fn(v0) for v0 in v0s]
    wrong, errors = [], []

    def work(i):
        try:
            torch.set_num_threads(1)
            for _ in range(5):
                if not all(torch.equal(a, b)
                           for a, b in zip(fn(v0s[i]), want[i])):
                    wrong.append(i)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not wrong, (errors, wrong)


def test_threads_sharing_one_function_get_the_sequential_result(tiny):
    fn = tl.lower(tiny.model_bytes)
    xs = [torch.from_numpy(_signal(1, seed)) for seed in (7, 8)]
    want = [fn(x) for x in xs]
    got = [[], []]
    start = threading.Barrier(2)
    errors = []

    def work(i):
        try:
            # One intra-op thread in this thread too (the OpenMP thread
            # count is per thread): the same reduction order as the
            # sequential run.
            torch.set_num_threads(1)
            start.wait()
            for _ in range(3):
                got[i].append(fn(xs[i]))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i in (0, 1):
        for out in got[i]:
            assert all(torch.equal(a, b) for a, b in zip(out, want[i]))
    assert len(fn._eval._sub_evs) == 2  # the Loop body, the then-branch


def test_int8_keeps_the_bodies_float(tiny):
    """int8 quantizes top-level nodes only; the Loop body and the If
    branches run on the stock float evaluator (as in the JAX package), and
    the scores match the JAX package's int8 at fp32 compute."""
    from birda_tpu.onnx import quantize as jq

    from birda_tpu_torch.onnx import quantize as tq

    batches = list(jq.calibration_signals(sg.TINY.frontend.sample_count,
                                          batch=2, n_batches=1))
    jcal = jq.calibrate(tiny.model_bytes, batches, min_weight_bytes=256)
    jfn = jq.lower_int8(tiny.model_bytes, jcal, compute_dtype=jnp.float32,
                        min_weight_bytes=256)
    tfn = tq.lower_int8(tiny.model_bytes,
                        tq.CalibrationResult.from_json(jcal.to_json()),
                        min_weight_bytes=256)
    top = {o for n in tfn.graph.nodes for o in n.outputs}
    assert tfn.quantized_nodes == jfn.quantized_nodes
    assert tfn.quantized_nodes and set(tfn.quantized_nodes) <= top
    x = _signal(2, seed=3)
    want = _np(jfn(x, params=jfn.params)[0])
    got = _np(tfn(torch.from_numpy(x))[0])
    assert np.abs(got - want).max() <= 5e-3
    assert {type(ev) for ev in tfn._eval._sub_evs.values()} == \
        {tl._Evaluator}


def test_same_named_body_weights_are_lifted_once_as_in_jax():
    """A reference quirk the port keeps (ROADMAP C): two branches that each
    hold a large initializer of one name lift it once, under that name, so
    the else-branch runs with the then-branch's weight in both packages
    (params dicts carry between them by name)."""
    rng = np.random.default_rng(0)
    w_then, w_else = (rng.normal(size=(128, 128)).astype(np.float32)
                      for _ in range(2))

    def branch(w, out):
        return fo.graph([fo.node("MatMul", ["x", "W"], [out])], inputs=[],
                        outputs=[fo.value_info(out, [1, 128])],
                        initializers=[fo.tensor("W", w)])

    mb = fo.model(
        [fo.node("If", ["c"], ["y"],
                 attrs=[fo.attr_graph("then_branch", branch(w_then, "t")),
                        fo.attr_graph("else_branch", branch(w_else, "e"))])],
        inputs=[fo.value_info("x", [1, 128])],
        outputs=[fo.value_info("y", [1, 128])],
        initializers=[fo.tensor("c", np.array(False))])
    x = rng.normal(size=(1, 128)).astype(np.float32)
    jfn, tfn = jl.lower(mb), tl.lower(mb)
    assert list(tfn.params) == list(jfn.params) == ["W"]
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, x @ w_then, rtol=1e-4, atol=1e-4)
