"""Chunk runner of the PyTorch port (birda_tpu_torch/inference/classifier.py)
against the JAX package's ChunkRunner, on the tiny v2.4 graph in fp32.

The same int16 chunk goes through both device steps (dequantize, resample
when the source rate differs, overlapped windows, model, top-k): the top-k
indices must be equal and the values within 1e-4 (fp32 rounding).
"""

import numpy as np
import pytest
import torch

from birda_tpu.inference.classifier import BirdClassifier as JaxClassifier
from birda_tpu.models import zoo as jax_zoo
from birda_tpu.onnx import fullscale as fs

from birda_tpu_torch.errors import Inference as InferenceErr
from birda_tpu_torch.inference.classifier import BirdClassifier
from birda_tpu_torch.models import zoo
from birda_tpu_torch.models.contracts import ModelFamily, contract_for

BATCH = 4
TOP_K = 5


@pytest.fixture(scope="module")
def pair():
    g = fs.cached_build(fs.tiny_spec(fs.BIRDNET_V24_SPEC), seed=1)
    contract = contract_for(ModelFamily.BIRDNET_V24)
    labels = zoo.synthetic_labels(g.spec.num_classes)
    jax_clf = JaxClassifier(
        jax_zoo.onnx_model(g.model_bytes, contract, labels), device="cpu",
        min_confidence=0.0, top_k=TOP_K)
    port_clf = BirdClassifier(
        zoo.onnx_model(g.model_bytes, contract, labels), device="cpu",
        min_confidence=0.0, top_k=TOP_K)
    return jax_clf, port_clf


def _audio(n, rate, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    return (0.3 * np.sin(2 * np.pi * (2000 + 500 * t) * t)
            + rng.normal(0, 0.05, n)).astype(np.float32)


def _compare(jax_rows, port_rows):
    assert len(port_rows) == len(jax_rows)
    for j, p in zip(jax_rows, port_rows):
        assert [x.index for x in p.predictions] == \
            [x.index for x in j.predictions]
        assert [x.species for x in p.predictions] == \
            [x.species for x in j.predictions]
        for a, b in zip(p.predictions, j.predictions):
            assert abs(a.confidence - b.confidence) <= 1e-4


@pytest.mark.parametrize("n_real,src_rate", [
    pytest.param(BATCH, None, id="full-chunk"),
    pytest.param(2, None, id="short-tail-chunk"),
    pytest.param(BATCH, 44_100, id="44k1-source"),
])
def test_chunk_runner_matches_jax(pair, n_real, src_rate):
    jax_clf, port_clf = pair
    seg = port_clf.sample_count
    step = seg // 2  # overlapped windows
    jr = jax_clf.chunk_runner(BATCH, step, src_rate=src_rate)
    pr = port_clf.chunk_runner(BATCH, step, src_rate=src_rate)
    assert pr.chunk_samples == jr.chunk_samples
    assert pr.resample_on_device == (src_rate is not None)
    rate = src_rate or port_clf.sample_rate
    if n_real == BATCH:
        chunk = _audio(pr.chunk_samples, rate)
    else:  # a tail: fewer samples than the runner holds, zero-padded
        chunk = _audio((n_real - 1) * step + seg - 1000, rate, seed=1)
    _compare(jr.predict_chunk(chunk, n_real),
             pr.predict_chunk_async(chunk, n_real).collect())


def test_predict_batch_matches_jax(pair):
    jax_clf, port_clf = pair
    rows = np.stack([_audio(port_clf.sample_count, 48_000, seed=s)
                     for s in range(2)])
    _compare(jax_clf.predict_batch(rows), port_clf.predict_batch(rows))


def test_device_out_of_memory_is_a_typed_error(pair, monkeypatch):
    _, port_clf = pair
    runner = port_clf.chunk_runner(BATCH, port_clf.sample_count)

    def oom(waveform):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(port_clf.model, "apply", oom)
    with pytest.raises(InferenceErr, match=r"halve the batch size "
                                           r"\(--batch-size 2\)"):
        runner.predict_chunk(np.zeros(runner.chunk_samples, np.float32),
                             BATCH)


def test_explicit_cuda_request_fails_loudly_without_a_card(monkeypatch):
    """``cuda``/``gpu`` and the default ``auto`` all mean the card: without
    one they raise and name the CPU request; only ``cpu`` runs there."""
    from birda_tpu_torch.errors import RuntimeInitialization
    from birda_tpu_torch.inference.backend import select_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for request in ("cuda", "gpu"):
        with pytest.raises(RuntimeInitialization, match="CUDA was requested"):
            select_backend(request)
    for request in ("auto", None):
        with pytest.raises(RuntimeInitialization,
                           match=r"default device is the CUDA card.*"
                                 r"device=\"cpu\" \(--cpu\)"):
            select_backend(request)
    assert select_backend("cpu")[1].to_json_dict() == {
        "requested": "cpu", "actual": "cpu"}
    with pytest.raises(RuntimeInitialization, match="unknown device"):
        select_backend("tpu")


def test_quantize_without_native_library_matches_jax(pair, monkeypatch):
    """Where the native audio library does not load, the int16 payload and
    scale equal the JAX runner's numpy fallback bit for bit."""
    from birda_tpu.native import audio as jax_native_audio

    from birda_tpu_torch.native import audio as native_audio

    monkeypatch.setattr(jax_native_audio, "available", lambda: False)
    monkeypatch.setattr(native_audio, "available", lambda: False)
    jax_clf, port_clf = pair
    seg = port_clf.sample_count
    jr = jax_clf.chunk_runner(BATCH, seg)
    pr = port_clf.chunk_runner(BATCH, seg)
    for chunk in (_audio(pr.chunk_samples - 777, 48_000, seed=3),
                  np.zeros(pr.chunk_samples, np.float32)):
        (jp, js), (pp, ps) = jr._quantize(chunk), pr._quantize(chunk)
        assert pp.dtype == np.int16
        assert np.array_equal(pp, jp)
        assert ps == js
