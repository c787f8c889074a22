"""The port's acceptance rehearsal (scripts/torch_accept_asset.py, on the
CPU here) against the JAX package's (scripts/accept_asset.py), on the same
stand-in asset: ``tests/test_accept_asset.py``'s ``torch.onnx.export`` of a
fusable Conv1d-STFT front end and a small head, with its recorded scores.

Each case runs both scripts and compares the gate statuses: a good asset
accepted end to end, a parity regression (without node recordings: the
re-record hint; with them: the same first diverging node named), a label
mismatch, an unsupported graph, no reference. The int8 gate is held
against the JAX package's ``evaluate_model`` given the same calibration
rows, which the port's script draws apart from its eval rows.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import fixtures_onnx as fo
from test_accept_asset import accept_asset, asset  # noqa: F401 — fixture

_SPEC = importlib.util.spec_from_file_location(
    "torch_accept_asset",
    Path(__file__).resolve().parent.parent / "scripts"
    / "torch_accept_asset.py")
torch_accept_asset = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(torch_accept_asset)


def _gates(script, argv, capsys, port):
    argv = [str(a) for a in argv] + (["--cpu"] if port else [])
    rc = script.main(argv)
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    return rc, summary["gates"], out


def _both(argv, capsys):
    want = _gates(accept_asset, argv, capsys, port=False)
    got = _gates(torch_accept_asset, argv, capsys, port=True)
    return want, got


def test_good_asset_accepted_alike(asset, capsys):  # noqa: F811
    (jrc, jg, _), (prc, pg, out) = _both(
        [asset["model"], asset["labels"], "--reference", asset["ref"]],
        capsys)
    assert prc == jrc == 0
    assert pg == jg == {g: "PASS" for g in (
        "load", "preflight", "labels", "fusion", "parity", "int8", "bench")}
    assert "segments/s" in out and "calibrated on 16 other rows" in out


def test_parity_regression_fails_alike(asset, capsys):  # noqa: F811
    bad = asset["tmp"] / "bad_ref_port.npz"
    scores = asset["scores"].copy()
    scores[0, 0] += 0.25
    np.savez_compressed(bad, inputs=asset["inputs"], scores=scores)
    (jrc, jg, jout), (prc, pg, pout) = _both(
        [asset["model"], asset["labels"], "--reference", bad,
         "--skip-int8", "--skip-bench"], capsys)
    assert prc == jrc == 1
    assert pg == jg and pg["parity"] == "FAIL"
    assert "record-nodes" in jout and "record-nodes" in pout


def test_parity_regression_names_the_same_node(asset, capsys):  # noqa: F811
    """With node recordings (the JAX package's own capture of the asset,
    one recorded tensor planted off), both scripts name the same first
    diverging node."""
    from birda_tpu.onnx import lowering as jl
    from birda_tpu.onnx import parity as jp

    x = asset["inputs"]
    fn = jl.lower(asset["model"].read_bytes())
    acts = jp.capture_activations(fn, x[:1])
    node = next(n for n in fn.graph.nodes if n.op_type == "MatMul")
    name = node.outputs[0]
    acts[name] = np.asarray(acts[name]) + np.float32(0.5)
    scores = asset["scores"].copy()
    scores[0, 0] += 0.25
    ref = asset["tmp"] / "nodes_ref.npz"
    np.savez_compressed(ref, inputs=x, scores=scores, node_input_rows=1,
                        **{f"node:{k}": v for k, v in acts.items()})
    (jrc, jg, jout), (prc, pg, pout) = _both(
        [asset["model"], asset["labels"], "--reference", ref,
         "--skip-int8", "--skip-bench"], capsys)
    assert prc == jrc == 1 and pg == jg
    want = f"first divergence at tensor '{name}' (op MatMul"
    assert want in jout and want in pout


def test_label_mismatch_fails_alike(asset, capsys):  # noqa: F811
    short = asset["tmp"] / "short_labels_port.txt"
    short.write_text("Only one_Label\n")
    (jrc, jg, _), (prc, pg, out) = _both(
        [asset["model"], short, "--skip-int8", "--skip-bench"], capsys)
    assert prc == jrc == 1
    assert pg == jg and pg["labels"] == "FAIL"
    assert "12 classes" in out


def test_unsupported_graph_fails_alike(tmp_path, capsys):
    mb = fo.model(
        [fo.node("NonZero", ["x"], ["y"])],
        inputs=[fo.value_info("x", [2, 3])],
        outputs=[fo.value_info("y", [2, "n"], elem_type=7)],
    )
    model_path = tmp_path / "bad.onnx"
    model_path.write_bytes(mb)
    labels = tmp_path / "labels.txt"
    labels.write_text("a_b\n")
    (jrc, jg, _), (prc, pg, out) = _both([model_path, labels], capsys)
    assert prc == jrc == 1
    assert pg == jg == {"load": "PASS", "preflight": "FAIL"}
    assert "NonZero" in out


def test_no_reference_skips_parity_alike(asset, capsys):  # noqa: F811
    (jrc, jg, _), (prc, pg, _) = _both(
        [asset["model"], asset["labels"], "--skip-bench"], capsys)
    assert prc == jrc == 0
    assert pg == jg and pg["parity"] == "SKIP"


def test_int8_gate_matches_jax_on_the_same_calibration_rows(asset):  # noqa: F811,E501
    """The port's int8 report on the eval rows, calibrated on rows drawn
    apart from them, against the JAX package's evaluate_model given the
    same calibration rows: the same verdict, top-1 agreement and
    threshold crossings, drift within 1e-3."""
    import torch

    from birda_tpu.onnx import int8_accuracy as jax_int8

    from birda_tpu_torch.onnx import int8_accuracy as port_int8

    mb = asset["model"].read_bytes()
    eval_in, calib = torch_accept_asset.int8_rows(asset["inputs"].shape)
    assert len(eval_in) == 64 and sum(len(c) for c in calib) == 16
    assert not any(np.any(np.all(np.isclose(eval_in, row), axis=1))
                   for c in calib for row in c)
    want = jax_int8.evaluate_model(mb, eval_in, calibration_batches=calib)
    got = port_int8.evaluate_model(
        mb, torch.from_numpy(eval_in),
        calibration_batches=[torch.from_numpy(c) for c in calib])
    criteria = port_int8.Criteria()
    assert got.failures(criteria) == want.failures(jax_int8.Criteria())
    assert got.top1_agreement == want.top1_agreement
    assert [vars(c) for c in got.crossings] == \
        [vars(c) for c in want.crossings]
    assert got.max_abs_delta == pytest.approx(want.max_abs_delta, abs=1e-3)
