"""The public names of the JAX package's modules that the port's
counterparts carry too, each against its JAX counterpart on the same
inputs, and ``BIRDA_STFT_KERNEL``, read per front-end node call as the JAX
package reads it.

Bounds: scores of the tiny v2.4 graph in fp32 within 1e-4 (fp32 rounding,
as ``tests/test_torch_classifier.py``); the bf16 composed route that
``BIRDA_STFT_KERNEL=gather`` asks for against the JAX evaluator's gather
route in fp32 (XLA on the CPU cannot run its bf16 products) within the
port's documented bf16 budget, 5e-3 absolute for v2.4's sigmoid scores
and 5e-2 of the top score for Perch v2's softmax (below 1e-3 with random
weights).
"""

import numpy as np
import pytest
import torch

from birda_tpu.inference import backend as jax_backend
from birda_tpu.inference.classifier import BirdClassifier as JaxClassifier
from birda_tpu.models import zoo as jax_zoo
from birda_tpu.onnx import fullscale as fs
from birda_tpu.onnx import lowering as jl
from birda_tpu.ops import resample as jax_resample

from birda_tpu_torch.errors import RuntimeInitialization
from birda_tpu_torch.inference import backend
from birda_tpu_torch.inference.classifier import BirdClassifier
from birda_tpu_torch.models import zoo
from birda_tpu_torch.models.contracts import ModelFamily, contract_for
from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.ops import resample, stft_conv

TOP_K = 5
SCORE_BOUND = 1e-4


@pytest.fixture(scope="module")
def graph():
    return fs.cached_build(fs.tiny_spec(fs.BIRDNET_V24_SPEC), seed=1)


@pytest.fixture(scope="module")
def pair(graph):
    contract = contract_for(ModelFamily.BIRDNET_V24)
    labels = zoo.synthetic_labels(graph.spec.num_classes)
    jax_clf = JaxClassifier(
        jax_zoo.onnx_model(graph.model_bytes, contract, labels),
        device="cpu", min_confidence=0.0, top_k=TOP_K)
    port_clf = BirdClassifier(
        zoo.onnx_model(graph.model_bytes, contract, labels), device="cpu",
        min_confidence=0.0, top_k=TOP_K)
    return jax_clf, port_clf


@pytest.mark.parametrize("min_confidence", [0.0, 0.5])
def test_predict_is_one_segment_of_predict_batch_as_in_jax(pair,
                                                           min_confidence):
    from birda_tpu.inference.classifier import \
        InferenceOptions as JaxOptions

    from birda_tpu_torch.inference.classifier import InferenceOptions

    jax_clf, port_clf = pair
    seg = np.random.default_rng(3).normal(
        0, 0.2, port_clf.sample_count).astype(np.float32)
    got = port_clf.predict(seg, InferenceOptions(min_confidence, 3))
    want = jax_clf.predict(seg, JaxOptions(min_confidence, 3))
    assert got == port_clf.predict_batch(
        seg[None, :], InferenceOptions(min_confidence, 3))[0]
    assert [p.index for p in got.predictions] == \
        [p.index for p in want.predictions]
    assert [p.species for p in got.predictions] == \
        [p.species for p in want.predictions]
    for a, b in zip(got.predictions, want.predictions):
        assert abs(a.confidence - b.confidence) <= SCORE_BOUND
    assert (got.embeddings is None) == (want.embeddings is None)


def test_execution_provider_status_is_the_backend_status(pair):
    jax_clf, port_clf = pair
    got = port_clf.execution_provider_status()
    assert got is port_clf.backend_status
    assert got.to_json_dict() == \
        jax_clf.execution_provider_status().to_json_dict() == \
        {"requested": "cpu", "actual": "cpu"}


@pytest.mark.parametrize("spec", [fs.BIRDNET_V24_SPEC, fs.PERCH_V2_SPEC],
                         ids=["v24", "perch"])
def test_input_info_lists_the_fed_inputs_as_in_jax(spec):
    g = fs.cached_build(fs.tiny_spec(spec), seed=1)
    got = tl.lower(g.model_bytes).input_info()
    want = jl.lower(g.model_bytes).input_info()
    assert [(v.name, v.elem_type, v.shape) for v in got] == \
        [(v.name, v.elem_type, v.shape) for v in want]
    assert [v.name for v in got] == tl.lower(g.model_bytes).input_names


@pytest.mark.parametrize("from_rate,to_rate", [
    (48_000, 32_000), (44_100, 48_000), (22_050, 32_000), (256_000, 48_000),
    (8_000, 48_000), (32_000, 32_000)])
def test_device_resample_supported_as_in_jax(from_rate, to_rate):
    assert resample.device_resample_supported(from_rate, to_rate) is \
        jax_resample.device_resample_supported(from_rate, to_rate) is True


def test_ensure_runtime_available_on_the_cpu_as_in_jax():
    """The CPU runtime initializes: neither package raises."""
    assert backend.ensure_runtime_available("cpu") is None
    assert jax_backend.ensure_runtime_available() is None


def test_ensure_runtime_available_raises_the_typed_error_as_in_jax(
        monkeypatch):
    """Where the runtime the default needs cannot initialize, both
    packages raise their ``RuntimeInitialization``: the port's default is
    the card, which this machine lacks; the JAX package's when jax has no
    backend."""
    import jax

    from birda_tpu.errors import RuntimeInitialization as JaxInit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeInitialization, match="no CUDA device"):
        backend.ensure_runtime_available()
    with pytest.raises(RuntimeInitialization):
        backend.ensure_runtime_available("cuda")

    def no_backend():
        raise RuntimeError("Unable to initialize backend 'tpu'")

    monkeypatch.setattr(jax, "devices", no_backend)
    with pytest.raises(JaxInit) as want:
        jax_backend.ensure_runtime_available()
    assert RuntimeInitialization.__name__ == type(want.value).__name__
    assert RuntimeInitialization.__mro__[1].__name__ == \
        type(want.value).__mro__[1].__name__


# -- BIRDA_STFT_KERNEL -----------------------------------------------------------

def _scores(out):
    return (out[0] if isinstance(out, tuple) else out).float().numpy()


@pytest.mark.parametrize("spec,kernel,relative", [
    (fs.BIRDNET_V24_SPEC, "fused_logmel", False),
    (fs.PERCH_V2_SPEC, "conv1d_stft", True)], ids=["v24", "perch"])
def test_gather_takes_the_composed_route_as_the_jax_gather_route(
        monkeypatch, spec, kernel, relative):
    """``gather`` sends the front-end node to the composed route (counted
    ``composed``, nothing launched) and gives the JAX evaluator's gather
    route within the bf16 budget; ``auto`` and ``pallas`` keep the kernel
    route (its plain version on the CPU), with one output between them.
    The variable is read at each node call: one lowered function follows
    it."""
    g = fs.cached_build(fs.tiny_spec(spec), seed=1)
    x = np.random.default_rng(0).normal(
        0, 0.1, (2, g.spec.sample_count)).astype(np.float32)
    fn = tl.lower(g.model_bytes, compute_dtype=torch.bfloat16)
    got, routes = {}, {}
    for mode in ("auto", "pallas", "gather"):
        monkeypatch.setenv("BIRDA_STFT_KERNEL", mode)
        before, launches = dict(stft_conv.ROUTES), dict(stft_conv.LAUNCHES)
        got[mode] = _scores(fn(torch.from_numpy(x)))
        routes[mode] = {k: v - before.get(k, 0)
                        for k, v in stft_conv.ROUTES.items()
                        if v != before.get(k, 0)}
        assert dict(stft_conv.LAUNCHES) == launches
    assert routes == {"auto": {f"{kernel}:kernel": 1},
                      "pallas": {f"{kernel}:kernel": 1},
                      "gather": {f"{kernel}:composed": 1}}
    assert np.array_equal(got["auto"], got["pallas"])

    monkeypatch.setenv("BIRDA_STFT_KERNEL", "gather")
    want = jl.lower(g.model_bytes)(x)
    want = np.asarray(want[0] if isinstance(want, tuple) else want,
                      np.float32)
    err = np.abs(got["gather"] - want).max()
    if relative:
        err /= np.abs(want).max()
    assert got["gather"].shape == want.shape
    assert err <= (5e-2 if relative else 5e-3)
