"""The analyze path of the PyTorch port end to end (birda_tpu_torch.api,
orchestrator, pipeline processor, CLI) against the JAX package, on the tiny
v2.4 graph in fp32 over two generated 9 s recordings (48 kHz, and 44.1 kHz
so the device resampler runs).

Also: the port runs where neither jax nor flax, pyarrow or click can be
imported, as on a CUDA host that has only PyTorch.
"""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fixtures_audio import write_wav

from birda_tpu.onnx import fullscale as fs

from birda_tpu_torch.models.zoo import synthetic_labels

REPO = Path(__file__).resolve().parent.parent
CONF_BOUND = 1e-4


@pytest.fixture()
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    return tmp_path


@pytest.fixture()
def setup(home):
    g = fs.build(fs.tiny_spec(fs.BIRDNET_V24_SPEC), seed=1)
    model = home / "birdnet-v24-tiny.onnx"
    model.write_bytes(g.model_bytes)
    labels = home / "labels.txt"
    labels.write_text("\n".join(synthetic_labels(g.spec.num_classes)) + "\n")
    rng = np.random.default_rng(0)
    wavs = []
    for rate in (48_000, 44_100):
        t = np.arange(int(rate * 9)) / rate
        x = 0.3 * np.sin(2 * np.pi * (2500 + 300 * t) * t) \
            + rng.normal(0, 0.05, t.shape)
        p = home / f"rec_{rate}.wav"
        write_wav(p, x.astype(np.float32), rate)
        wavs.append(p)
    kw = dict(model_path=model, labels_path=labels,
              model_type="birdnet-v24", min_confidence=0.1, device="cpu")
    return wavs, kw


def _rows(result):
    return {f.path.name: [(d.start_time, d.end_time, d.scientific_name,
                           d.common_name, d.confidence)
                          for d in f.detections]
            for f in result.files}


def _assert_same_detections(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert want[name], f"no detections for {name}"
        assert [r[:4] for r in got[name]] == [r[:4] for r in want[name]]
        for a, b in zip(got[name], want[name]):
            assert abs(a[4] - b[4]) <= CONF_BOUND


def test_analyze_matches_jax(setup):
    import birda_tpu.api as jax_api

    import birda_tpu_torch.api as torch_api

    wavs, kw = setup
    want = jax_api.analyze(wavs, **kw)
    got = torch_api.analyze(wavs, **kw)
    assert got.exit_code == want.exit_code == 0
    assert got.backend == {"requested": "cpu", "actual": "cpu"}
    assert got.summary["total_segments"] == 6
    _assert_same_detections(_rows(got), _rows(want))


def test_cli_csv_matches_jax_cli(setup, home):
    from click.testing import CliRunner

    from birda_tpu.cli.main import cli

    from birda_tpu_torch.cli.main import main

    wavs, kw = setup
    args = ["--model-path", str(kw["model_path"]),
            "--labels-path", str(kw["labels_path"]),
            "--model-type", "birdnet-v24", "-c", "0.1", "--cpu", "-f", "csv",
            "-q"]
    for name, run in (
        ("jax", lambda a: CliRunner().invoke(cli, a).exit_code),
        ("torch", main),
    ):
        out = home / name
        assert run(["analyze", *map(str, wavs), *args, "-o", str(out)]) == 0
    for wav in wavs:
        tables = []
        for name in ("jax", "torch"):
            (path,) = (home / name).glob(f"{wav.stem}*.csv")
            with open(path, encoding="utf-8-sig") as f:
                tables.append(list(csv.reader(f)))
        want, got = tables
        assert got[0] == want[0]  # header
        assert len(got) == len(want) > 1
        conf = [i for i, h in enumerate(want[0]) if h.lower() == "confidence"]
        assert conf
        for g_row, w_row in zip(got[1:], want[1:]):
            for i, (a, b) in enumerate(zip(g_row, w_row)):
                if i in conf:
                    assert abs(float(a) - float(b)) <= CONF_BOUND
                else:
                    assert a == b


# Tiny Perch v2: softmax scores below 1e-3 with random weights, so the runs
# keep the top 5 of each segment above a floor of 1e-6, and confidences are
# held within 1e-4 of the file's largest score (fp32 rounding).
PERCH_FLOOR = 1e-6
PERCH_TOP_K = 5


@pytest.fixture()
def perch_setup(setup, home):
    wavs, kw = setup
    g = fs.cached_build(fs.tiny_spec(fs.PERCH_V2_SPEC), seed=1)
    model = home / "perch-v2-tiny.onnx"
    model.write_bytes(g.model_bytes)
    labels = home / "perch-labels.txt"
    labels.write_text("\n".join(synthetic_labels(g.spec.num_classes)) + "\n")
    return wavs, dict(model_path=model, labels_path=labels,
                      model_type="perch-v2", min_confidence=PERCH_FLOOR,
                      top_k=PERCH_TOP_K, device="cpu")


def _by_window(rows):
    """(start, end, name) -> confidence, and the largest confidence."""
    table = {(r[0], r[1], r[2]): r[-1] for r in rows}
    return table, max(table.values())


def test_perch_analyze_matches_jax(perch_setup):
    import birda_tpu.api as jax_api

    import birda_tpu_torch.api as torch_api

    wavs, kw = perch_setup
    want = _rows(jax_api.analyze(wavs, **kw))
    result = torch_api.analyze(wavs, **kw)
    got = _rows(result)
    assert result.exit_code == 0
    assert result.summary["total_segments"] == 4  # 9 s in 5 s windows
    assert got.keys() == want.keys()
    for name in want:
        (g, _), (w, top) = _by_window(got[name]), _by_window(want[name])
        assert len(w) == 2 * PERCH_TOP_K
        assert g.keys() == w.keys()
        assert max(abs(g[k] - w[k]) for k in w) <= 1e-4 * top


def test_perch_cli_csv_matches_jax_cli(perch_setup, home):
    from click.testing import CliRunner

    from birda_tpu.cli.main import cli

    from birda_tpu_torch.cli.main import main

    wavs, kw = perch_setup
    args = ["--model-path", str(kw["model_path"]),
            "--labels-path", str(kw["labels_path"]),
            "--model-type", "perch-v2", "-c", str(PERCH_FLOOR), "--cpu",
            "-f", "csv", "-q"]
    for name, run in (
        ("jax", lambda a: CliRunner().invoke(cli, a).exit_code),
        ("torch", main),
    ):
        out = home / f"perch-{name}"
        assert run(["analyze", *map(str, wavs), *args, "-o", str(out)]) == 0
    for wav in wavs:
        tables = []
        for name in ("jax", "torch"):
            (path,) = (home / f"perch-{name}").glob(f"{wav.stem}*.csv")
            with open(path, encoding="utf-8-sig") as f:
                tables.append(list(csv.reader(f)))
        want, got = tables
        assert got[0] == want[0]  # header
        assert len(got) == len(want) > 1

        def rows(table):
            return _by_window([(r[0], r[1], r[2], float(r[4]))
                               for r in table[1:]])

        (g, _), (w, top) = rows(got), rows(want)
        assert g.keys() == w.keys()
        assert max(abs(g[k] - w[k]) for k in w) <= 1e-4 * top


def test_runs_without_jax_flax_pyarrow_or_click(setup, home):
    """The port runs where neither jax, flax, pyarrow, click nor the JAX
    package itself can be imported: tiny v2.4 and tiny Perch v2 (scores
    below 1e-3 with random weights, so a floor of 1e-6 and the top 5), in
    fp32 and bf16, and tiny v2.4 in int8 and mixed (calibrated here)."""
    wavs, kw = setup
    perch = fs.build(fs.tiny_spec(fs.PERCH_V2_SPEC), seed=1)
    perch_model = home / "perch-v2-tiny.onnx"
    perch_model.write_bytes(perch.model_bytes)
    perch_labels = home / "perch-labels.txt"
    perch_labels.write_text(
        "\n".join(synthetic_labels(perch.spec.num_classes)) + "\n")
    blocked = ("jax", "jaxlib", "flax", "pyarrow", "click", "birda_tpu")
    code = f"""
import json, sys
for name in {blocked!r}:
    sys.modules[name] = None
from birda_tpu_torch.api import analyze
models = [({str(kw['model_path'])!r}, {str(kw['labels_path'])!r},
           "birdnet-v24", 0.1, 10),
          ({str(perch_model)!r}, {str(perch_labels)!r}, "perch-v2", 1e-6, 5)]
runs = [analyze({[str(w) for w in wavs]!r}, model_path=m, labels_path=l,
                model_type=t, min_confidence=c, top_k=k, device="cpu",
                precision=p)
        for m, l, t, c, k in models for p in ("fp32", "bf16")]
runs += [analyze({[str(w) for w in wavs]!r}, model_path=models[0][0],
                 labels_path=models[0][1], model_type="birdnet-v24",
                 min_confidence=0.1, device="cpu", precision=p)
         for p in ("int8", "mixed")]
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {blocked!r})
print(json.dumps({{"exit": [r.exit_code for r in runs], "loaded": loaded,
                  "detections": [len(f.detections) for r in runs
                                 for f in r.files]}}))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["exit"] == [0] * 6
    assert out["loaded"] == []
    assert len(out["detections"]) == 12 and all(out["detections"])


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without a CUDA
    card, and alone in a directory without the rest of the repository."""
    script = tmp_path / "chip_smoke.py"
    script.write_bytes((REPO / "chip_smoke.py").read_bytes())
    for cwd, path in ((REPO, REPO / "chip_smoke.py"), (tmp_path, script)):
        r = subprocess.run([sys.executable, str(path)], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


@pytest.mark.parametrize("kwargs,what", [
    pytest.param({"bat": "bat-v1"}, "--bat", id="bat"),
    pytest.param({"jobs": 2}, "--jobs above 1", id="jobs"),
    pytest.param({"lat": 60.2, "lon": 24.9, "week": 20},
                 "geomodel range filter", id="range-filter"),
])
def test_unported_options_are_refused(setup, kwargs, what):
    import birda_tpu_torch.api as torch_api
    from birda_tpu_torch.errors import ClassifierBuild

    wavs, kw = setup
    with pytest.raises(ClassifierBuild, match="not yet ported") as e:
        torch_api.analyze(wavs, **{**kw, **kwargs})
    assert what in str(e.value)
