"""``scripts/torch_int8_recall_report.py`` (the port's int8 recall report)
against the JAX package's ``scripts/int8_recall_report.py`` on the tiny
v2.4 graph, once through ``--reference`` and once through ``--audio``
(fixture recordings at 48 kHz and at 44.1 kHz, which the host resamples,
beside a stray text file that the tool skips), and through
``--calibration-audio``.

Both tools score fp32 against int8 of the same inputs at fp32 compute;
they differ by fp32 rounding in the two evaluators and in calibration.
Bounds: the segments and classes equal; the crossing counts at each
threshold within 0.1% of the scores compared (segments x classes); the
agreement rates within 1/segments (one segment flipping); the |Δ| figures
within 5e-3 (``tests/test_torch_quantize.py::
test_evaluate_model_matches_jax``); the exit codes equal.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from birda_tpu.onnx import fullscale as fs

from fixtures_audio import write_wav

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
DELTA_BOUND = 5e-3


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("recall")
    g = fs.cached_build(fs.tiny_spec(fs.BIRDNET_V24_SPEC), seed=1)
    model = d / "tiny_v24.onnx"
    model.write_bytes(g.model_bytes)
    labels = d / "labels.txt"
    labels.write_text("".join(f"sp{i}\n" for i in range(g.spec.num_classes)))
    recs = d / "recs"
    recs.mkdir()
    rng = np.random.default_rng(4)
    for i, (rate, secs) in enumerate(((48_000, 9.0), (44_100, 7.5))):
        t = np.arange(int(rate * secs)) / rate
        x = (0.3 * np.sin(2 * np.pi * (1500 + 700 * i + 300 * t) * t)
             + rng.normal(0, 0.05, t.size))
        write_wav(recs / f"rec{i}.wav", x, rate)
    (recs / "notes.txt").write_text("not audio\n")
    ref = d / "ref.npz"
    np.savez(ref, inputs=rng.normal(0, 0.2, (6, g.spec.sample_count))
             .astype(np.float32))
    return model, labels, recs, ref


def _run_port(argv, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = _script("torch_int8_recall_report").main(argv)
    finally:
        torch.set_num_threads(threads)
    return rc, capsys.readouterr().out


def _run_jax(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["int8_recall_report.py", *argv])
    rc = _script("int8_recall_report").main()
    return rc, capsys.readouterr().out


def _report(out: str) -> dict:
    """The numbers of a rendered report, by line."""
    head = re.search(r"int8 accuracy report: (\d+) segments x (\d+) classes",
                     out)
    delta = re.search(r"\|Δ\| max ([\d.]+)\s+mean ([\d.]+)", out)
    agree = re.search(r"top-1 agreement ([\d.]+)\s+top-5 Jaccard ([\d.]+)",
                      out)
    cross = re.findall(r"thr (\S+)\s*: both (\d+)\s+missed (\d+) .*"
                       r"spurious (\d+)", out)
    return {"segments": int(head[1]), "classes": int(head[2]),
            "delta": (float(delta[1]), float(delta[2])),
            "agreement": (float(agree[1]), float(agree[2])),
            "crossings": [tuple(map(float, c)) for c in cross],
            "pass": "all acceptance criteria pass" in out}


@pytest.mark.parametrize("route", ["reference", "audio", "calibration"])
def test_report_matches_the_jax_script(assets, capsys, monkeypatch, route):
    model, labels, recs, ref = assets
    argv = [str(model), "--labels", str(labels)]
    if route == "reference":
        argv += ["--reference", str(ref)]
    else:
        argv += ["--audio", str(recs), "--limit", "6"]
    if route == "calibration":
        argv += ["--calibration-audio", str(recs / "rec1.wav")]
    rc, out = _run_port([*argv, "--cpu"], capsys)
    want_rc, want_out = _run_jax(argv, capsys, monkeypatch)
    assert out.startswith("device: cpu (CPU)\n")
    assert rc == want_rc
    got, want = _report(out), _report(want_out)
    n = want["segments"]
    assert (got["segments"], got["classes"]) == (n, 6522)
    assert n == 6
    for a, b in zip(got["delta"], want["delta"]):
        assert abs(a - b) <= DELTA_BOUND
    for a, b in zip(got["agreement"], want["agreement"]):
        assert abs(a - b) <= 1 / n + 1e-9
    assert [c[0] for c in got["crossings"]] == \
        [c[0] for c in want["crossings"]] == [0.05, 0.1, 0.25, 0.5]
    for a, b in zip(got["crossings"], want["crossings"]):
        assert np.abs(np.subtract(a, b)).max() <= 1e-3 * n * 6522
    assert got["pass"] == want["pass"] == (rc == 0)


def test_runs_on_the_card_unless_asked_for_the_cpu(assets, monkeypatch):
    """Without ``--cpu`` the tool asks for the card, and without one it
    raises the port's typed error before it reads any input."""
    from birda_tpu_torch.errors import RuntimeInitialization

    model, _, _, ref = assets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeInitialization, match="--cpu"):
        _script("torch_int8_recall_report").main(
            [str(model), "--reference", str(ref)])


def test_needs_exactly_one_input_route(assets, capsys):
    model, _, recs, ref = assets
    with pytest.raises(SystemExit) as e:
        _script("torch_int8_recall_report").main([str(model), "--cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        _script("torch_int8_recall_report").main(
            [str(model), "--reference", str(ref), "--audio", str(recs)])
    assert "exactly one of --reference / --audio" in capsys.readouterr().err
