"""The port's per-node bisection tool (birda_tpu_torch/onnx/parity.py)
against the JAX package's (birda_tpu/onnx/parity.py), on tiny BirdNET v2.4
and tiny Perch v2 in fp32 (same seeded graphs and inputs in both):

- ``capture_activations`` returns the same tensors under the same names,
  each within 1e-4 of its largest magnitude of the JAX package's;
- with the JAX package's own capture as the recording, the port finds no
  divergence at the tool's default 1e-3;
- a weight perturbation planted in one conv is named as the first
  divergence, the same node by both packages;
- ``node_records`` reads a recorder npz alike;
- the port's tool resolves its device as the port's entry points do: the
  card unless the caller asks for the CPU (these tests ask for it).
"""

import numpy as np
import pytest
import torch

from birda_tpu.onnx import fullscale as fs
from birda_tpu.onnx import lowering as jl
from birda_tpu.onnx import parity as jp

from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.onnx import parity as tp

REL_BOUND = 1e-4
SPECS = {"v24": fs.BIRDNET_V24_SPEC, "perch": fs.PERCH_V2_SPEC}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graphs():
    return {k: fs.cached_build(fs.tiny_spec(s), seed=1)
            for k, s in SPECS.items()}


def _signal(g):
    return np.random.default_rng(5).normal(
        0, 0.1, (2, g.spec.sample_count)).astype(np.float32)


@pytest.fixture(scope="module")
def captures(graphs):
    out = {}
    for key, g in graphs.items():
        x = _signal(g)
        jfn, tfn = jl.lower(g.model_bytes), tl.lower(g.model_bytes)
        out[key] = (x, jfn, tfn, jp.capture_activations(jfn, x),
                    tp.capture_activations(tfn, x, device="cpu"))
    return out


@pytest.mark.parametrize("key", list(SPECS))
def test_captures_agree_per_tensor(captures, key):
    _, _, tfn, want, got = captures[key]
    produced = [o for n in tfn.graph.nodes for o in n.outputs if o]
    assert set(produced) <= set(got)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == np.shape(w), name
        w = np.asarray(w, np.float64)
        if not w.size:
            continue
        err = np.abs(np.asarray(g, np.float64) - w).max()
        assert err <= REL_BOUND * max(np.abs(w).max(), 1e-30), name


@pytest.mark.parametrize("key", list(SPECS))
def test_jax_capture_as_recording_finds_no_divergence(captures, key):
    x, _, tfn, want, _ = captures[key]
    assert tp.find_first_divergence(tfn, x, want, device="cpu") is None


def _weights(fn):
    """Every weight a run reads: the lifted params and the inline
    constants (a tiny graph's conv weights stay inline)."""
    return {**fn._eval.const, **fn.params}


def _first_conv(fn):
    """The first 2-D Conv (the stem on v2.4, past the front end)."""
    w = _weights(fn)
    return next(n for n in fn.graph.nodes
                if n.op_type == "Conv" and np.ndim(w[n.inputs[1]]) == 4)


@pytest.mark.parametrize("key", list(SPECS))
def test_planted_perturbation_is_named_alike(captures, key):
    """The perturbed weight is fed in the params, which a run lays over
    the graph's constants, in both packages."""
    x, jfn, tfn, want, _ = captures[key]
    node = _first_conv(tfn)
    name = node.inputs[1]
    bad = np.asarray(_weights(tfn)[name]) * np.float32(1.05)
    got = tp.find_first_divergence(tfn, x, want,
                                   params={**tfn.params, name: bad},
                                   device="cpu")
    ref = jp.find_first_divergence(jfn, x, want,
                                   params={**jfn.params, name: bad})
    assert got is not None and ref is not None
    assert (got.tensor, got.op_type, got.node_name) == \
        (ref.tensor, ref.op_type, ref.node_name) == \
        (node.outputs[0], "Conv", node.name)
    assert got.max_abs_err == pytest.approx(ref.max_abs_err, rel=1e-3)
    assert got.render().startswith(f"first divergence at tensor "
                                   f"'{node.outputs[0]}' (op Conv")


def test_node_records_reads_a_recorder_npz(tmp_path):
    path = tmp_path / "ref.npz"
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.savez(path, scores=a, **{"node:conv_1": a, "node:add_2": -a})
    with np.load(path) as ref:
        got, want = tp.node_records(ref), jp.node_records(ref)
    assert sorted(got) == sorted(want) == ["add_2", "conv_1"]
    assert all(np.array_equal(got[k], want[k]) for k in got)


def test_capture_runs_on_the_device_of_the_params(captures):
    """Host inputs go to the device asked for, where the params lie (the
    CPU here), and bf16 values come back as float32 numpy."""
    x, _, _, _, _ = captures["v24"]
    g = fs.cached_build(fs.tiny_spec(fs.BIRDNET_V24_SPEC), seed=1)
    fn = tl.lower(g.model_bytes, compute_dtype=torch.bfloat16)
    params = {k: torch.tensor(v).to(torch.bfloat16)
              for k, v in fn.params.items()}
    got = tp.capture_activations(fn, x, params=params, device="cpu")
    out = fn.output_names[0]
    assert got[out].dtype == np.float32
    assert got[out].shape == (2, g.spec.num_classes)
    assert np.isfinite(got[out]).all()


def test_capture_resolves_its_device_as_the_port_does(captures,
                                                      monkeypatch):
    """By default the tool runs on the card, as the JAX package's runs on
    its default accelerator: without one it fails with the port's typed
    error, which names the CPU request, and runs nothing on the CPU."""
    from birda_tpu_torch.errors import RuntimeInitialization

    x, _, tfn, want, _ = captures["v24"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeInitialization, match='device="cpu"'):
        tp.capture_activations(tfn, x)
    with pytest.raises(RuntimeInitialization, match="CUDA"):
        tp.find_first_divergence(tfn, x, want, device="cuda")
