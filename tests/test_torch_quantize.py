"""The int8 and mixed precisions of the PyTorch port
(birda_tpu_torch/onnx/quantize.py, int8_accuracy.py, models/zoo.py,
orchestrator, api, CLI) against the JAX package's, on the tiny v2.4 and
Perch v2 graphs (``fullscale.tiny_spec``, seed 1) and on small hand-built
graphs.

Bounds:

- ``calibration_signals``: equal arrays.
- ``calibrate`` on the same batches: the same tensors, ``ndim`` and
  ``aelems``; ``amax`` and ``amean`` within rtol 1e-5, ``pctl`` within rtol
  1e-4, ``chamax`` within rtol 1e-5 of each channel plus 1e-5 of the
  tensor's ``amax`` (the cached format keeps 6 significant digits, and a
  channel far below the tensor's largest carries the fp32 rounding of the
  larger terms it sums).
- Fed the same ``CalibrationResult``: the same selection under every
  boundary policy (nodes, skip reasons, boundary tensors, smoothed tensors,
  activation scales) and byte-equal int8 weights and weight scales.
- Scores: int8 at fp32 compute within 5e-3 (absolute for v2.4, relative to
  the top score for Perch's softmax); int8 and mixed at bf16 compute within
  2e-2, the port's bf16 bound against JAX; the same argmax in each case;
  the same dtype at every node.
- The cost report: equal dicts. The advisory fires and stays quiet on the
  same graphs.
"""

import csv
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fixtures_onnx as fo
import torch_cpu_precision_parity as cpp
from fixtures_audio import write_wav
from birda_tpu.onnx import fullscale as fs
from birda_tpu.onnx import int8_accuracy as jacc
from birda_tpu.onnx import quantize as jq

from birda_tpu_torch.models import zoo
from birda_tpu_torch.models.contracts import ModelFamily, contract_for
from birda_tpu_torch.onnx import int8_accuracy as tacc
from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.onnx import quantize as tq

SPECS = {"v24": fs.BIRDNET_V24_SPEC, "perch": fs.PERCH_V2_SPEC,
         "v30": fs.BIRDNET_V30_SPEC}
POLICIES = ["strict", "tolerant", "frontier", "all", "storage"]
#: The tiny graphs shrink channel counts below the production
#: min_weight_bytes; 256 quantizes the whole backbone (the JAX package's
#: own tiny-graph parity test does the same).
TINY_MIN_WEIGHT_BYTES = 256


@pytest.fixture(scope="module")
def graphs():
    return {k: fs.cached_build(fs.tiny_spec(s), seed=1)
            for k, s in SPECS.items()}


@pytest.fixture(scope="module")
def jax_calib(graphs):
    """JAX calibration of each tiny graph on 2 batches of 4 built-in
    signals, with those batches."""
    out = {}
    for k, g in graphs.items():
        batches = list(jq.calibration_signals(g.spec.sample_count, batch=4,
                                              n_batches=2))
        out[k] = (jq.calibrate(g.model_bytes, batches,
                               min_weight_bytes=TINY_MIN_WEIGHT_BYTES),
                  batches)
    return out


def _port_calib(jcal):
    """The JAX calibration as the port reads it (its JSON format)."""
    return tq.CalibrationResult.from_json(jcal.to_json())


def _test_input(g):
    return next(jq.calibration_signals(g.spec.sample_count, batch=4,
                                       n_batches=1, seed=99))


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v, np.float32)


def _jax_params(fn, bf16):
    """The JAX zoo's params: float at bf16 when compute is bf16."""
    if not bf16:
        return fn.params
    return {k: (np.asarray(v, jnp.bfloat16) if np.asarray(v).dtype.kind == "f"
                else v) for k, v in fn.params.items()}


def _lower_both(g, jcal, compute, policy="all",
                min_weight_bytes=TINY_MIN_WEIGHT_BYTES, **kw):
    bf16 = compute == "bf16"
    jfn = jq.lower_int8(g.model_bytes, jcal,
                        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32,
                        min_weight_bytes=min_weight_bytes,
                        boundary_store=policy, **kw)
    tfn = tq.lower_int8(g.model_bytes, _port_calib(jcal),
                        compute_dtype=torch.bfloat16 if bf16 else None,
                        min_weight_bytes=min_weight_bytes,
                        boundary_store=policy, **kw)
    return jfn, tfn


# -- calibration ----------------------------------------------------------------

@pytest.mark.parametrize("sample_count,batch,n_batches,seed", [
    (999, 3, 2, 17), (160_000, 2, 2, 5)])
def test_calibration_signals_are_equal(sample_count, batch, n_batches, seed):
    want = list(jq.calibration_signals(sample_count, batch, n_batches, seed))
    got = list(tq.calibration_signals(sample_count, batch, n_batches, seed))
    assert len(got) == len(want) == n_batches
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("key", list(SPECS))
def test_calibrate_matches_jax(graphs, jax_calib, key):
    jcal, batches = jax_calib[key]
    tcal = tq.calibrate(graphs[key].model_bytes, batches, device="cpu")
    assert (tcal.method, tcal.percentile, tcal.batches) == \
        (jcal.method, jcal.percentile, jcal.batches) == ("max", 99.9, 2)
    assert tcal.stats.keys() == jcal.stats.keys()
    assert len(tcal.stats) >= 20
    for name, want in jcal.stats.items():
        got = tcal.stats[name]
        assert (got["ndim"], got["aelems"]) == (want["ndim"], want["aelems"])
        for f, rtol in (("amax", 1e-5), ("amean", 1e-5), ("pctl", 1e-4)):
            assert got[f] == pytest.approx(want[f], rel=rtol), (name, f)
        np.testing.assert_allclose(got["chamax"], want["chamax"], rtol=1e-5,
                                   atol=1e-5 * want["amax"], err_msg=name)
    # The cache JSON round-trips in both directions.
    assert jq.CalibrationResult.from_json(tcal.to_json()).stats == \
        json.loads(tcal.to_json())["stats"]


def test_percentile_is_jnp_percentile():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(10_001)
                         .astype(np.float32)).abs()
    for q in (0.0, 37.5, 99.9, 100.0):
        assert float(tq._percentile(x, q)) == pytest.approx(
            float(jnp.percentile(jnp.asarray(x.numpy()), q)), rel=1e-6)


@pytest.mark.parametrize("x_shape,w_shape,group,stride", [
    ((2, 48, 33, 17), (48, 1, 3, 3), 48, (1, 1)),
    ((2, 48, 33, 17), (48, 1, 5, 5), 48, (2, 2)),
    ((2, 64, 20, 9), (64, 4, 3, 3), 16, (1, 1)),
    ((1, 1040, 6, 5), (40, 1040, 1, 1), 1, (1, 1)),
])
def test_exact_grouped_int8_conv_is_xlas_int8_conv(x_shape, w_shape, group,
                                                   stride):
    """The full-depth comparison (``tests/torch_int8_fullscale.py``)
    evaluates the JAX package's grouped int8 convs in float32, exactly: the
    same int32 as XLA's int8 convolution, at the extremes of the int8
    range; a dense conv keeps XLA's route."""
    import torch_int8_fullscale as full
    from jax import lax

    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, x_shape, dtype=np.int8)
    w = rng.integers(-127, 128, w_shape, dtype=np.int8)
    x[0, 0], w[0] = 127, -127
    x, w = jnp.asarray(x), jnp.asarray(w)
    kw = dict(window_strides=stride, padding=((1, 1), (2, 2)),
              feature_group_count=group, preferred_element_type=jnp.int32)
    conv = lax.conv_general_dilated
    want = conv(x, w, **kw)
    with full.exact_grouped_int8_conv():
        got = lax.conv_general_dilated(x, w, **kw)
    assert lax.conv_general_dilated is conv
    assert got.dtype == want.dtype == jnp.int32
    assert np.array_equal(np.asarray(got), np.asarray(want))


# -- selection and weights ------------------------------------------------------

def _weight(fn, name):
    return fn.params.get(name, fn._eval.const.get(name))


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("min_weight_bytes", [TINY_MIN_WEIGHT_BYTES,
                                              jq.DEFAULT_MIN_WEIGHT_BYTES])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("key", list(SPECS))
def test_selection_and_weights_match_jax(graphs, jax_calib, monkeypatch, key,
                                         policy, min_weight_bytes, compute):
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")  # JAX fuses in bf16
    jfn, tfn = _lower_both(graphs[key], jax_calib[key][0], compute, policy,
                           min_weight_bytes)
    assert [n.op_type for n in tfn.graph.nodes] == \
        [n.op_type for n in jfn.graph.nodes]
    assert tfn.quantized_nodes == jfn.quantized_nodes
    assert tfn.skipped_nodes == jfn.skipped_nodes
    assert tfn.int8_boundary_tensors == jfn.int8_boundary_tensors
    assert tfn.smoothed_tensors == jfn.smoothed_tensors
    if policy == "storage":
        assert not tfn.quantized_nodes
    elif min_weight_bytes == TINY_MIN_WEIGHT_BYTES:
        assert len(tfn.quantized_nodes) >= 20
    jev, tev = jfn._eval, tfn._eval
    assert tev._ascale == jev._ascale
    assert tev._wscale.keys() == jev._wscale.keys()
    for wname, s in jev._wscale.items():
        assert tev._wscale[wname].tobytes() == s.tobytes()
        jw, tw = _weight(jfn, wname), _weight(tfn, wname)
        assert tw.dtype == jw.dtype == np.int8
        assert tw.tobytes() == jw.tobytes()
    assert tev._asmooth.keys() == jev._asmooth.keys()
    for name, s in jev._asmooth.items():
        assert tev._asmooth[name].tobytes() == s.tobytes()
    assert set(tfn.params) == set(jfn.params)
    for name, arr in jfn.params.items():
        assert tfn.params[name].dtype == arr.dtype


# -- scores -----------------------------------------------------------------------

def _max_err(got, want, relative):
    if relative:  # Perch: softmax scores, relative to each row's top
        return float((np.abs(got - want).max(-1) / want.max(-1)).max())
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("mode,bound", [("int8-fp32", 5e-3),
                                        ("int8-bf16", 2e-2),
                                        ("mixed-bf16", 2e-2)])
@pytest.mark.parametrize("key", list(SPECS))
def test_scores_match_jax(graphs, jax_calib, monkeypatch, key, mode, bound):
    """The JAX bf16 route through its Pallas front-end kernels in interpret
    mode; the port's through their plain versions."""
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    g = graphs[key]
    precision, compute = mode.split("-")
    policy = "storage" if precision == "mixed" else "all"
    jfn, tfn = _lower_both(g, jax_calib[key][0], compute, policy)
    bf16 = compute == "bf16"
    x = _test_input(g)
    want = _np(jfn(x, params=_jax_params(jfn, bf16))[0])
    params = zoo.params_from_numpy(tfn.params, "cpu",
                                   torch.bfloat16 if bf16 else None)
    got = _np(tfn(torch.from_numpy(x), params=params)[0])
    assert got.shape == want.shape == (4, g.spec.num_classes)
    assert _max_err(got, want, key == "perch") <= bound
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def _record_dtypes(fn):
    """Wrap the evaluator's ``_store`` to record every stored dtype."""
    ev, store, seen = fn._eval, fn._eval._store, {}

    def recording(name, val):
        val = store(name, val)
        if isinstance(val, torch.Tensor):
            seen[name] = str(val.dtype).removeprefix("torch.")
        elif val is not None:
            seen[name] = str(getattr(val, "dtype", None)
                             or np.asarray(val).dtype)
        return val

    ev._store = recording
    return seen


@pytest.mark.parametrize("policy", ["strict", "all", "storage"])
def test_int8_node_dtypes_match_jax(graphs, jax_calib, monkeypatch, policy):
    """bf16 compute: every stored device value has the JAX evaluator's
    dtype — int8 at the boundary tensors, int32 nowhere, bf16 after every
    product, float32 after every BatchNormalization."""
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    g = graphs["v24"]
    jfn, tfn = _lower_both(g, jax_calib["v24"][0], "bf16", policy)
    jseen, tseen = _record_dtypes(jfn), _record_dtypes(tfn)
    x = _test_input(g)[:2]
    jfn(x, params=_jax_params(jfn, True))
    tfn(torch.from_numpy(x),
        params=zoo.params_from_numpy(tfn.params, "cpu", torch.bfloat16))
    assert tseen == jseen
    # As in the JAX package, only the float32 tensors of the selected set
    # are stored int8: its kind test takes bf16 for a non-float type.
    stored = {n for n, d in tseen.items() if d == "int8"}
    assert stored <= set(tfn.int8_boundary_tensors)
    if policy == "strict":
        assert len(stored) >= 10


# -- weights carried across --------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8-fp32", "int8-bf16", "mixed-bf16"])
def test_weights_carried_from_jax_params(graphs, jax_calib, monkeypatch, mode):
    """params_from_numpy carries a JAX lower_int8 function's params into the
    port's lower_int8 function of the same graph and calibration: int8 stays
    int8, float becomes the compute dtype, and the scores are exactly the
    port's own. The output heads quantize too here: on the tiny graph only
    they are large enough to be lifted into the params as int8."""
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    g = graphs["v24"]
    precision, compute = mode.split("-")
    jfn, tfn = _lower_both(g, jax_calib["v24"][0], compute,
                           "storage" if precision == "mixed" else "all",
                           protect_outputs=False)
    dtype = torch.bfloat16 if compute == "bf16" else None
    assert set(tfn.params) == set(jfn.params)
    carried = zoo.params_from_numpy(jfn.params, "cpu", dtype)
    own = zoo.params_from_numpy(tfn.params, "cpu", dtype)
    for name, t in carried.items():
        assert t.dtype == own[name].dtype
    assert any(t.dtype == torch.int8 for t in carried.values()) == \
        (precision == "int8")
    x = torch.from_numpy(_test_input(g)[:2])
    a, b = tfn(x, params=own), tfn(x, params=carried)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- the int8 evaluator on hand-built graphs -------------------------------------------

def _conv_graph(w, x_shape, out_shape):
    return fo.model(
        [fo.node("Conv", ["x", "w"], ["y"], attrs=[
            fo.attr_ints("pads", [0, 0, 0, 0]),
            fo.attr_ints("kernel_shape", list(w.shape[2:])),
        ])],
        inputs=[fo.value_info("x", ["batch", *x_shape[1:]])],
        outputs=[fo.value_info("y", ["batch", *out_shape[1:]])],
        initializers=[fo.tensor("w", w)],
    )


def test_int8_conv_exact_on_power_of_two_grid():
    """Operands on an int8 grid with power-of-two scales: the int8 route
    reproduces the float conv bit for bit (JAX: TestInt8Exactness)."""
    rng = np.random.default_rng(4)
    wq = rng.integers(-127, 128, (8, 4, 3, 3)).astype(np.float32)
    wq[:, 0, 0, 0] = 127.0  # pin per-channel amax
    xq = rng.integers(-127, 128, (2, 4, 8, 8)).astype(np.float32)
    xq[0, 0, 0, 0] = 127.0
    x, w = xq * 0.25, wq * 0.125
    mb = _conv_graph(w, x.shape, (2, 8, 6, 6))
    calib = tq.calibrate(mb, [x], device="cpu")
    qfn = tq.lower_int8(mb, calib, min_weight_bytes=1, protect_outputs=False,
                        smooth_alpha=None)
    assert qfn.quantized_nodes == ["y"]
    got = qfn(torch.from_numpy(x))
    want = tl.lower(mb)(torch.from_numpy(x))
    assert torch.equal(got, want)


def test_lifted_int8_conv_weight_runs():
    """A weight of at least 64 KiB is lifted into params as int8 and runs
    from there; int8 noise only (JAX: ~4% of the output range)."""
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.1, (64, 32, 6, 6)).astype(np.float32)
    x = rng.normal(0, 1.0, (2, 32, 16, 16)).astype(np.float32)
    mb = _conv_graph(w, x.shape, (2, 64, 11, 11))
    calib = tq.calibrate(mb, [x], device="cpu")
    qfn = tq.lower_int8(mb, calib, min_weight_bytes=1, protect_outputs=False)
    assert qfn.params["w"].dtype == np.int8
    got = _np(qfn(torch.from_numpy(x), params=zoo.params_from_numpy(
        qfn.params, "cpu")))
    want = _np(tl.lower(mb)(torch.from_numpy(x)))
    assert np.abs(got - want).max() < 0.04 * np.abs(want).max()


def test_gemm_transb_exact():
    rng = np.random.default_rng(5)
    wq = rng.integers(-127, 128, (16, 32)).astype(np.float32)  # [N, K]
    wq[:, 0] = 127.0
    xq = rng.integers(-127, 128, (4, 32)).astype(np.float32)
    xq[0, 0] = 127.0
    w, x = wq * 0.0625, xq * 0.5
    c = rng.normal(0, 1, 16).astype(np.float32)
    mb = fo.model(
        [fo.node("Gemm", ["x", "w", "c"], ["y"],
                 attrs=[fo.attr_int("transB", 1)])],
        inputs=[fo.value_info("x", ["batch", 32])],
        outputs=[fo.value_info("y", ["batch", 16])],
        initializers=[fo.tensor("w", w), fo.tensor("c", c)],
    )
    calib = tq.calibrate(mb, [x], device="cpu")
    qfn = tq.lower_int8(mb, calib, min_weight_bytes=1, protect_outputs=False,
                        smooth_alpha=None)
    assert qfn.quantized_nodes == ["y"]
    np.testing.assert_allclose(_np(qfn(torch.from_numpy(x))), x @ w.T + c,
                               atol=1e-4)


def test_no_compute_cast_is_thread_local():
    """The suppression of the compute-dtype cast is per thread (threads
    sharing one evaluator keep theirs) and re-entrant."""
    mb = _conv_graph(np.ones((2, 1, 3, 3), np.float32), (1, 1, 5, 5),
                     (1, 2, 3, 3))
    ev = tl._Evaluator(tl.load_model(mb).graph, compute_dtype=torch.bfloat16)
    inside, release, seen = threading.Event(), threading.Event(), {}

    def holder():
        with ev._no_compute_cast():
            seen["holder"] = ev.compute_dtype
            inside.set()
            release.wait(5)
        seen["after"] = ev.compute_dtype

    th = threading.Thread(target=holder)
    th.start()
    assert inside.wait(5)
    assert ev.compute_dtype == torch.bfloat16  # this thread is unaffected
    release.set()
    th.join()
    assert seen == {"holder": None, "after": torch.bfloat16}
    with ev._no_compute_cast():
        assert ev.compute_dtype is None
        with ev._no_compute_cast():
            assert ev.compute_dtype is None
        assert ev.compute_dtype is None
    assert ev.compute_dtype == torch.bfloat16


# -- cost report and advisory ------------------------------------------------------

@pytest.mark.parametrize("policy", ["all", "strict"])
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("key", list(SPECS))
def test_cost_report_matches_jax(graphs, jax_calib, monkeypatch, key, compute,
                                 policy):
    """At batch 4: JAX traces with eval_shape, the port runs on meta
    tensors; every count and byte total is equal."""
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    g = graphs[key]
    jfn, tfn = _lower_both(g, jax_calib[key][0], compute, policy)
    want = jq.int8_cost_report(
        jfn, jax.ShapeDtypeStruct((4, g.spec.sample_count), np.float32))
    got = tq.int8_cost_report(tfn, torch.empty(4, g.spec.sample_count))
    assert got == want
    assert got["macs"] > 0 and got["act_bytes"] > 0
    if policy == "strict":
        assert got["boundary_int8_bytes"] > 0
    assert tfn._eval.cost is None


def _conv_gemm_graph(seed=0, out_ch=8):
    """Conv -> Sigmoid -> Flatten -> Gemm: JAX test_quantize.conv_gemm_graph
    with a Sigmoid in place of its Relu, which is outside the port's op
    set (elementwise either way)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.2, (out_ch, 4, 3, 3)).astype(np.float32)
    b = rng.normal(0, 0.1, out_ch).astype(np.float32)
    g = rng.normal(0, 0.2, (out_ch * 36, 16)).astype(np.float32)
    return fo.model(
        [
            fo.node("Conv", ["x", "w", "b"], ["c"], attrs=[
                fo.attr_ints("pads", [0, 0, 0, 0]),
                fo.attr_ints("kernel_shape", [3, 3]),
            ]),
            fo.node("Sigmoid", ["c"], ["r"]),
            fo.node("Flatten", ["r"], ["f"], attrs=[fo.attr_int("axis", 1)]),
            fo.node("Gemm", ["f", "g"], ["y"]),
        ],
        inputs=[fo.value_info("x", ["batch", 4, 8, 8])],
        outputs=[fo.value_info("y", ["batch", 16])],
        initializers=[fo.tensor("w", w), fo.tensor("b", b),
                      fo.tensor("g", g)],
    )


def test_cost_report_exact_counts():
    mb = _conv_gemm_graph()
    x = np.random.default_rng(5).normal(0, 1, (2, 4, 8, 8)) \
        .astype(np.float32)
    calib = tq.calibrate(mb, [x], device="cpu")
    qfn = tq.lower_int8(mb, calib, min_weight_bytes=1)
    rep = tq.int8_cost_report(qfn, x)
    assert qfn.quantized_nodes == ["c"]  # the Gemm is the output head
    assert rep["macs"] == 2 * 8 * 6 * 6 * 36
    assert rep["dequant_elems"] == 2 * 8 * 6 * 6
    assert rep["quantize_elems"] == 2 * 4 * 8 * 8
    jcal = jq.calibrate(mb, [x], min_weight_bytes=1)
    jfn = jq.lower_int8(mb, jcal, min_weight_bytes=1)
    assert rep == jq.int8_cost_report(
        jfn, jax.ShapeDtypeStruct(x.shape, np.float32))


def _deep_matmul_graph(n=1024, n_out=16, seed=6, scale=0.03):
    rng = np.random.default_rng(seed)
    w1 = rng.normal(0, scale, (n, n)).astype(np.float32)
    w2 = rng.normal(0, scale, (n, n_out)).astype(np.float32)
    mb = fo.model(
        [fo.node("MatMul", ["x", "w1"], ["h"]),
         fo.node("Sigmoid", ["h"], ["r"]),
         fo.node("MatMul", ["r", "w2"], ["y"])],
        inputs=[fo.value_info("x", ["batch", n])],
        outputs=[fo.value_info("y", ["batch", n_out])],
        initializers=[fo.tensor("w1", w1), fo.tensor("w2", w2)],
    )
    return mb, rng.normal(0, 1, (8, n)).astype(np.float32)


def test_advisory_fires_on_compute_shaped_graph_as_in_jax():
    mb, x = _deep_matmul_graph()
    calib = tq.calibrate(mb, [x], device="cpu")
    qfn = tq.lower_int8(mb, calib, min_weight_bytes=1)
    assert "h" in qfn.quantized_nodes
    adv = tq.int8_throughput_advisory(qfn, torch.empty(64, 1024))
    assert adv is not None
    assert adv["intensity_flop_per_byte"] > adv["threshold"] == 100.0
    assert "compute-shaped" in adv["message"]
    assert "--precision bf16" in adv["message"]
    jfn = jq.lower_int8(mb, jq.calibrate(mb, [x], min_weight_bytes=1),
                        min_weight_bytes=1)
    jadv = jq.int8_throughput_advisory(
        jfn, jax.ShapeDtypeStruct((64, 1024), np.float32))
    assert adv["intensity_flop_per_byte"] == jadv["intensity_flop_per_byte"]


@pytest.mark.parametrize("key", list(SPECS))
def test_advisory_quiet_where_jax_is_quiet(graphs, jax_calib, key):
    """The bandwidth-shaped hand-built graph, and each tiny family graph at
    the batch-256 probe the zoo uses: the advisory computes, and like the
    JAX package's says nothing."""
    mb = _conv_gemm_graph()
    x = np.random.default_rng(7).normal(0, 1, (2, 4, 8, 8)) \
        .astype(np.float32)
    qfn = tq.lower_int8(mb, tq.calibrate(mb, [x], device="cpu"),
                        min_weight_bytes=1)
    assert tq.int8_throughput_advisory(qfn, x) is None
    g = graphs[key]
    jfn, tfn = _lower_both(g, jax_calib[key][0], "fp32")
    probe = (256, g.spec.sample_count)
    rep = tq.int8_cost_report(tfn, torch.empty(probe))
    assert rep["macs"] > 0
    assert tq.int8_throughput_advisory(tfn, torch.empty(probe)) is None
    assert jq.int8_throughput_advisory(
        jfn, jax.ShapeDtypeStruct(probe, np.float32)) is None


def test_advisory_lands_in_precision_info():
    """onnx_model_int8 computes the advisory (its failure would leave no
    "advisory" key here) and reports it."""
    from birda_tpu_torch.models import contracts

    mb, x = _deep_matmul_graph(n_out=5, seed=8, scale=0.05)
    x = x[:4]
    calib = tq.calibrate(mb, [x], device="cpu")
    cfg = contracts.ModelConfig(
        family=contracts.ModelFamily.CUSTOM, sample_rate=1024,
        segment_duration=1.0, sample_count=1024, num_classes=5,
        activation=contracts.ScoreActivation.SIGMOID, embedding_dim=None)
    m = zoo.onnx_model_int8(mb, cfg, zoo.synthetic_labels(5), calib)
    assert m.precision_info["mode"] == "int8"
    adv = m.precision_info.get("advisory")
    assert adv is not None and adv["compute_shaped"] is True
    assert adv["intensity_flop_per_byte"] > 20


# -- the zoo ---------------------------------------------------------------------------

def _zoo_pair(graphs, jax_calib, storage_only, key="v24"):
    """The JAX zoo's and the port's int8/mixed model, both at bf16 compute
    with the front-end fused (the JAX package fuses it with its Pallas
    kernel enabled, BIRDA_STFT_KERNEL=pallas)."""
    g = graphs[key]
    family = {"v24": ModelFamily.BIRDNET_V24,
              "perch": ModelFamily.PERCH_V2,
              "v30": ModelFamily.BIRDNET_V30}[key]
    contract = contract_for(family)
    labels = zoo.synthetic_labels(contract.num_classes)
    from birda_tpu.models.contracts import contract_for as jax_contract_for
    from birda_tpu.models.zoo import onnx_model_int8 as jax_onnx_model_int8

    want = jax_onnx_model_int8(g.model_bytes, jax_contract_for(family.value),
                               labels, jax_calib[key][0],
                               compute_dtype=jnp.bfloat16,
                               storage_only=storage_only)
    got = zoo.onnx_model_int8(g.model_bytes, contract, labels,
                              _port_calib(jax_calib[key][0]),
                              compute_dtype=torch.bfloat16,
                              storage_only=storage_only)
    return got, want


@pytest.mark.parametrize("storage_only", [False, True])
@pytest.mark.parametrize("key", list(SPECS))
def test_precision_info_matches_jax(graphs, jax_calib, monkeypatch, key,
                                    storage_only):
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    got, want = _zoo_pair(graphs, jax_calib, storage_only, key)
    assert got.precision_info == want.precision_info
    assert got.source == want.source == (
        "onnx-mixed" if storage_only else "onnx-int8")
    assert set(got.precision_info) == set(want.precision_info)


def _model_configs(model_file, labels_file, model_type):
    from birda_tpu.config.types import ModelConfig as JaxModelConfig
    from birda_tpu.config.types import ModelType as JaxModelType

    from birda_tpu_torch.config.types import ModelConfig, ModelType

    return (JaxModelConfig(path=model_file, labels=labels_file,
                           model_type=JaxModelType(model_type)),
            ModelConfig(path=model_file, labels=labels_file,
                        model_type=ModelType(model_type)))


@pytest.mark.parametrize("precision", ["bf16", "int8", "mixed"])
@pytest.mark.parametrize("key", list(SPECS))
def test_precision_info_matches_jax_on_the_cpu_route(home, graphs, key,
                                                     precision):
    """``load_model_graph`` on the CPU backend in both packages: the same
    precision report (bf16 computes fp32 there and reports none; int8 and
    mixed report their selection from the same cached scales, which the
    JAX package computes and the port reads)."""
    from birda_tpu.orchestrator import load_model_graph as jax_load

    from birda_tpu_torch.orchestrator import load_model_graph

    jmc, tmc = _model_configs(
        *cpp.write_inputs(home, key, graphs[key])[:3])
    want = jax_load(jmc, "m", precision=precision, backend="cpu")
    got = load_model_graph(tmc, "m", precision=precision, device="cpu")
    assert got.precision_info == want.precision_info
    assert got.source == want.source
    if precision == "bf16":
        assert got.precision_info is None
    else:
        assert got.precision_info["mode"] == precision


def _card_double(monkeypatch):
    """The backend selector doubled to answer ``cuda`` with the CPU as its
    device, so that the card's branch of the rule is taken without a
    card."""
    from birda_tpu_torch.inference import backend

    real = backend.select_backend

    def select(requested="auto"):
        devices, status = real("cpu")
        return devices, backend.BackendStatus(requested, "cuda")

    monkeypatch.setattr(backend, "select_backend", select)


@pytest.mark.parametrize("precision,cpu,card", [
    ("fp32", None, None),
    ("bf16", None, torch.bfloat16),
    ("int8", None, torch.bfloat16),
    ("mixed", None, torch.bfloat16),
])
def test_compute_dtype_rule_for_cpu_and_card(precision, cpu, card):
    """The JAX package's rule (``birda_tpu/orchestrator.py:278-294``,
    ``:342``) as a plain function of the precision and the backend a run
    takes: the card computes bf16 (and the non-quantized ops of int8 and
    mixed) in bf16, the CPU in fp32."""
    from birda_tpu_torch.orchestrator import compute_dtype_for

    assert compute_dtype_for(precision, "cpu") is cpu
    assert compute_dtype_for(precision, "cuda") is card


@pytest.mark.parametrize("precision", ["bf16", "int8", "mixed"])
def test_load_model_graph_takes_the_backend_it_runs_on(home, graphs,
                                                       monkeypatch,
                                                       precision, caplog):
    """The rule is applied to the backend the device resolves to: on the
    CPU the float params stay float32 and the JAX package's warning is
    logged; with the backend selector answering ``cuda`` they are bf16,
    as on the card, and nothing is logged."""
    from birda_tpu_torch.orchestrator import load_model_graph

    _, tmc = _model_configs(
        *cpp.write_inputs(home, "v24", graphs["v24"])[:3])

    def float_dtypes(model):
        params = model.bind_device(torch.device("cpu"))
        return {t.dtype for t in params.values() if t.is_floating_point()}

    with caplog.at_level("WARNING", logger="birda_tpu_torch.orchestrator"):
        on_cpu = load_model_graph(tmc, "m", precision=precision,
                                  device="cpu")
    assert float_dtypes(on_cpu) == {torch.float32}
    assert (f"--precision {precision} requested but the actual backend is "
            "CPU; non-quantized compute runs fp32 there") in caplog.text
    caplog.clear()
    _card_double(monkeypatch)
    with caplog.at_level("WARNING", logger="birda_tpu_torch.orchestrator"):
        on_card = load_model_graph(tmc, "m", precision=precision,
                                   device="gpu")
    assert float_dtypes(on_card) == {torch.bfloat16}
    assert "actual backend is CPU" not in caplog.text
    assert on_card.precision_info["mode"] == precision


@pytest.mark.parametrize("precision,bound", [("bf16", 1e-3), ("int8", 5e-3),
                                             ("mixed", 5e-3)])
@pytest.mark.parametrize("key", ["v24", "v30"])
def test_analyze_cpu_precision_matches_jax(home, graphs, key, precision,
                                          bound):
    """``analyze --cpu --precision P`` in both packages on the same file
    (``tests/torch_cpu_precision_parity.py``): the same windows with the
    same species, each confidence within 1e-3 for bf16 (fp32 compute on the
    CPU in both) and within 5e-3 for int8 and mixed
    (``test_scores_match_jax``'s ``int8-fp32`` bound; the JAX run computes
    and caches the scales, the port's run reads them)."""
    (jname, want), (tname, got) = cpp.analyze_both(home, key, graphs[key],
                                                   precision)
    assert tname == jname
    assert want and len(got) == len(want)
    jw, tw = cpp.windows(want), cpp.windows(got)
    assert tw.keys() == jw.keys()
    for w, species in jw.items():
        assert tw[w].keys() == species.keys(), w
        for name, conf in species.items():
            assert abs(tw[w][name] - conf) <= bound, (w, name)


def test_boundary_policy_env_knob(graphs, jax_calib, monkeypatch):
    """BIRDA_INT8_BOUNDARY re-tunes the storage policy of int8 (not mixed),
    reported through precision_info, as in the JAX package."""
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    default, _ = _zoo_pair(graphs, jax_calib, False)
    monkeypatch.setenv("BIRDA_INT8_BOUNDARY", "strict")
    strict, jstrict = _zoo_pair(graphs, jax_calib, False)
    mixed, _ = _zoo_pair(graphs, jax_calib, True)
    assert default.precision_info["boundary_store"] == "all"
    assert strict.precision_info == jstrict.precision_info
    assert strict.precision_info["boundary_store"] == "strict"
    assert (strict.precision_info["int8_boundary_tensors"]
            > default.precision_info["int8_boundary_tensors"])
    assert mixed.precision_info["boundary_store"] == "storage"


def test_int8_params_halve_the_footprint(graphs, jax_calib):
    g = fs.cached_build(fs.tiny_spec(fs.BIRDNET_V30_SPEC), seed=1)
    x = next(tq.calibration_signals(g.spec.sample_count, batch=2,
                                    n_batches=1))
    calib = tq.calibrate(g.model_bytes, [x], device="cpu")
    qfn = tq.lower_int8(g.model_bytes, calib, protect_outputs=False)
    assert any(v.dtype == np.int8 for v in qfn.params.values())
    fbytes = sum(v.nbytes for v in tl.lower(g.model_bytes).params.values())
    qbytes = sum(v.nbytes for v in qfn.params.values())
    assert qbytes < 0.55 * fbytes


# -- int8_accuracy -------------------------------------------------------------------

def test_compare_scores_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (40, 30))
    b = np.clip(a + rng.normal(0, 0.03, a.shape), 0, 1)
    got = dataclasses.asdict(tacc.compare_scores(a, b))
    want = dataclasses.asdict(jacc.compare_scores(a, b))
    assert got == want
    rep = tacc.compare_scores(a, b)
    assert rep.failures() == jacc.compare_scores(a, b).failures()
    assert rep.render(["x"] * 30) == jacc.compare_scores(a, b).render(
        ["x"] * 30)


def test_evaluate_model_matches_jax(graphs):
    """fp32 against int8 of the tiny v2.4 graph, self-calibrated on the
    first rows, on the CPU in both packages."""
    g = graphs["v24"]
    x = next(jq.calibration_signals(g.spec.sample_count, batch=6,
                                    n_batches=1, seed=3))
    want = jacc.evaluate_model(g.model_bytes, x, batch=3, calibration_rows=4)
    got = tacc.evaluate_model(g.model_bytes, x, batch=3, calibration_rows=4)
    assert (got.n_segments, got.n_classes) == (6, g.spec.num_classes)
    assert got.top1_agreement == want.top1_agreement
    assert abs(got.max_abs_delta - want.max_abs_delta) <= 5e-3
    assert got.max_abs_delta < 0.05


# -- analyze end to end on the CPU -----------------------------------------------------

@pytest.fixture()
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    return tmp_path


@pytest.fixture()
def tiny_setup(home, graphs):
    """The tiny v2.4 graph as the configured default model, and a 6 s
    48 kHz tone (the JAX package's TestEndToEndParity input)."""
    from birda_tpu_torch.config.types import Config, ModelConfig, ModelType

    g = graphs["v24"]
    model_file = home / "tiny-v24.onnx"
    model_file.write_bytes(g.model_bytes)
    labels_file = home / "labels.txt"
    labels_file.write_text("".join(
        f"{s}\n" for s in zoo.synthetic_labels(g.spec.num_classes)))
    cfg = Config()
    cfg.models["tiny-onnx"] = ModelConfig(path=model_file, labels=labels_file,
                                          model_type=ModelType.BIRDNET_V24)
    cfg.defaults.model = "tiny-onnx"
    rate = 48_000
    t = np.arange(rate * 6) / rate
    audio = home / "rec.wav"
    write_wav(audio, (0.4 * np.sin(2 * np.pi * 2500 * t)).astype(np.float32),
              rate)
    return cfg, audio


def _run(home, cfg, audio, precision, outdir, **kw):
    from birda_tpu_torch.orchestrator import AnalyzeOptions, analyze_files

    opts = AnalyzeOptions(inputs=[audio], output_dir=home / outdir,
                          device_flags={"cpu": True}, precision=precision,
                          min_confidence=0.05, **kw)
    assert analyze_files(opts, cfg) == 0
    with open(home / outdir / "rec.BirdNET.results.csv",
              encoding="utf-8-sig") as f:
        return list(csv.DictReader(f))


def _conf(rows):
    return {(r["Start (s)"], r["Scientific name"]): float(r["Confidence"])
            for r in rows}


def _assert_tracks(want, got, tol=0.05):
    """Every detection of both runs within ``tol``; a species kept by one
    run only (a near-tie at the top-k cut, bf16 against fp32) lies within
    ``tol`` of the other run's lowest kept confidence in that window."""
    assert want and got
    for k in want.keys() & got.keys():
        assert abs(got[k] - want[k]) < tol, k
    for table, other in ((want, got), (got, want)):
        for k in table.keys() - other.keys():
            floor = min(c for (s, _), c in other.items() if s == k[0])
            assert table[k] < floor + tol, k
    assert len(want.keys() & got.keys()) >= 0.8 * len(want)


def test_int8_detections_track_fp32_through_analyze(home, tiny_setup):
    """`--precision int8` end to end: scales cached on the first run and
    loaded on the second (identical CSV rows), detections within 0.05 of
    the fp32 run (JAX: TestEndToEndParity). On the CPU both packages
    compute int8's float ops in fp32; a species kept by one run only still
    has to lie within 0.05 of the other's lowest kept confidence."""
    cfg, audio = tiny_setup
    rows_f = _run(home, cfg, audio, "fp32", "out_f")
    rows_q = _run(home, cfg, audio, "int8", "out_q")
    cache = list((home / "cache").rglob("int8_calib/*.json"))
    assert len(cache) == 1
    stamp = cache[0].stat().st_mtime_ns
    _assert_tracks(_conf(rows_f), _conf(rows_q))
    assert _run(home, cfg, audio, "int8", "out_q2") == rows_q
    assert cache[0].stat().st_mtime_ns == stamp


def test_cache_written_by_either_package_serves_the_other(home, graphs):
    from birda_tpu.onnx.quantize import cached_calibration as jax_cached

    g = graphs["v24"]
    calib, loaded = jax_cached(g.model_bytes, g.spec.sample_count)
    assert loaded is False
    got, loaded = tq.cached_calibration(g.model_bytes, g.spec.sample_count,
                                        device="cpu")
    assert loaded is True and got.stats == calib.stats


def test_mixed_precision_through_analyze(home, tiny_setup):
    from birda_tpu_torch.orchestrator import load_model_graph

    cfg, audio = tiny_setup
    model = load_model_graph(cfg.models["tiny-onnx"], "tiny-onnx",
                             precision="mixed", device="cpu")
    info = model.precision_info
    assert info == {"mode": "mixed", "quantized_nodes": 0,
                    "int8_boundary_tensors": 0, "boundary_store": "storage"}
    _assert_tracks(_conf(_run(home, cfg, audio, "fp32", "out_f")),
                   _conf(_run(home, cfg, audio, "mixed", "out_m")))


def test_calibration_audio_recalibrates(home, tiny_setup):
    """--calibration-audio calibrates on the user's audio (cut into batches
    as the JAX package cuts them) and caches nothing."""
    from birda_tpu.orchestrator import \
        _calibration_batches_from_audio as jax_batches

    from birda_tpu_torch.orchestrator import _calibration_batches_from_audio

    cfg, audio = tiny_setup
    got = _calibration_batches_from_audio(audio, 48_000, 144_000)
    want = jax_batches(audio, 48_000, 144_000)
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0], want[0])
    rows = _run(home, cfg, audio, "int8", "out_c", calibration_audio=audio)
    assert rows
    assert not list((home / "cache").rglob("int8_calib/*.json"))


@pytest.mark.parametrize("precision", ["int8", "mixed"])
def test_api_reports_precision_info(home, tiny_setup, graphs, precision):
    """api.analyze runs int8/mixed on tiny v2.4 and tiny Perch v2, and the
    model's precision report reaches the pipeline_started event."""
    from birda_tpu_torch.api import analyze
    from birda_tpu_torch.output import json_envelope as env

    cfg, audio = tiny_setup
    g = graphs["perch"]
    perch = home / "perch.onnx"
    perch.write_bytes(g.model_bytes)
    perch_labels = home / "perch-labels.txt"
    perch_labels.write_text("\n".join(
        zoo.synthetic_labels(g.spec.num_classes)) + "\n")
    runs = [
        analyze([audio], model="tiny-onnx", device="cpu", precision=precision,
                config=cfg),
        analyze([audio], model_path=perch, labels_path=perch_labels,
                model_type="perch-v2", device="cpu", precision=precision,
                min_confidence=1e-6, top_k=5, config=cfg),
    ]
    for r in runs:
        assert r.exit_code == 0 and r.detections
        assert r.precision["mode"] == precision
        assert (r.precision["quantized_nodes"] > 0) == (precision == "int8")
        p = env.pipeline_started_payload(1, "m", 0.1, {"requested": "cpu"},
                                         precision=r.precision)
        assert p["precision"] == r.precision


def test_cli_precision_flags(home, tiny_setup, capsys):
    from birda_tpu_torch.cli.main import main

    cfg, audio = tiny_setup
    model = cfg.models["tiny-onnx"]
    base = ["analyze", str(audio), "--model-path", str(model.path),
            "--labels-path", str(model.labels), "--model-type", "birdnet-v24",
            "--cpu", "-q", "-c", "0.05"]
    for precision in ("int8", "mixed"):
        assert main([*base, "--precision", precision,
                     "-o", str(home / precision)]) == 0
        assert list((home / precision).glob("*.csv"))
    with pytest.raises(SystemExit) as e:
        main([*base, "--precision", "bf16", "--calibration-audio",
              str(audio)])
    assert e.value.code == 2
    assert "--precision int8/mixed" in capsys.readouterr().err
    assert main([*base, "--precision", "mixed", "--calibration-audio",
                 str(audio), "-o", str(home / "mixed-calibrated")]) == 0
