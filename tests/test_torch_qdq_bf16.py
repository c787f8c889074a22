"""Perch v2's QDQ form (``chip_smoke.qdq_graph`` on the tiny spec) on the
bf16 route and through ``analyze``, both packages on the CPU:

- bf16, the framer's weight dequantized from int8 on the device and taken
  by ``conv1d_stft`` (its plain version here) against the JAX package's
  Pallas kernel in interpret mode: every node of the port on the JAX values
  of its inputs within 2e-2 of the node's largest magnitude (quantized
  values exactly), the same dtype at every node, and end to end the same
  argmax. End to end the two differ by as much as the JAX package's own
  bf16 route differs from its fp32 one on this graph (both 1-3% of the top
  score: ``scripts/torch_qdq_parity.py``): a bf16 Sigmoid one unit in the
  last place apart flips a uint8 step downstream and the step propagates.
  So the end-to-end bound here is the argmax; the 2e-2 bound holds node by
  node.
- ``analyze`` in fp32 over one 12 s recording at 32 kHz: the same
  detections (windows, species and their order), confidences within 2e-2
  of the largest (in one of its windows fp32 rounding puts an activation
  one uint8 step apart, as above).
"""

import numpy as np
import pytest
import torch

from fixtures_audio import write_wav
from torch_jax_parity import node_by_node, run_jax, run_port, signal, \
    tiny_qdq_perch

from birda_tpu_torch.models.zoo import synthetic_labels

PERCH_FLOOR = 1e-6
PERCH_TOP_K = 5


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


def test_bf16_matches_jax_pallas(perch, monkeypatch):
    from birda_tpu_torch.ops import stft_conv

    g, qdq = perch
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    x = signal(g)
    calls = []
    real = stft_conv.conv1d_stft
    monkeypatch.setattr(stft_conv, "conv1d_stft",
                        lambda *a, **k: calls.append(tuple(a[1].shape))
                        or real(*a, **k))
    node_by_node(qdq, [x], bf16=True)
    (js, _), jd = run_jax(qdq, [x], bf16=True)
    calls.clear()
    (ts, _), td = run_port(qdq, [x], bf16=True)
    assert calls == [(640, 640)]
    assert {k: v[0] for k, v in td.items()} == {k: v[0]
                                                for k, v in jd.items()}
    assert td["predictions"][0] == "bfloat16"
    assert np.array_equal(ts.float().numpy().argmax(-1),
                          np.asarray(js, np.float32).argmax(-1))


@pytest.fixture()
def analyze_setup(perch, tmp_path, monkeypatch):
    for d in ("config", "cache", "data"):
        monkeypatch.setenv(f"XDG_{d.upper()}_HOME", str(tmp_path / d))
    g, qdq = perch
    model = tmp_path / "perch_v2_int8_arm.onnx"
    model.write_bytes(qdq)
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(synthetic_labels(g.spec.num_classes)) + "\n")
    rate = g.spec.sample_rate
    t = np.arange(rate * 12) / rate
    wav = tmp_path / "rec.wav"
    write_wav(wav, (0.3 * np.sin(2 * np.pi * (2500 + 300 * t) * t)
                    + np.random.default_rng(3).normal(0, 0.05, t.shape))
              .astype(np.float32), rate)
    return [wav], dict(model_path=model, labels_path=labels,
                       model_type="perch-v2", min_confidence=PERCH_FLOOR,
                       top_k=PERCH_TOP_K, device="cpu")


def test_analyze_matches_jax(analyze_setup):
    import birda_tpu.api as jax_api

    import birda_tpu_torch.api as torch_api

    wavs, kw = analyze_setup
    want = jax_api.analyze(wavs, **kw)
    got = torch_api.analyze(wavs, **kw)
    assert got.exit_code == want.exit_code == 0
    rows = [{(d.start_time, d.end_time, d.scientific_name): d.confidence
             for d in r.detections} for r in (got, want)]
    assert rows[0].keys() == rows[1].keys()
    assert len(rows[1]) == 3 * PERCH_TOP_K  # 12 s in 5 s windows
    assert [list(r) for r in rows[0:1]] == [list(rows[1])]
    top = max(rows[1].values())
    assert max(abs(rows[0][k] - v) for k, v in rows[1].items()) <= 2e-2 * top
