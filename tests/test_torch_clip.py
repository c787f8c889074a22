"""``api.clip`` and the CLI's ``clip`` in the port against the JAX
package's, on the same detection CSVs and WAV recordings: the same clips,
byte for byte, under the same names, and the same summary (clip entries,
file counts, failures, with each package's output directory in its
paths), in CSV mode (padding, confidence and species filters, groups that
merge, a file whose audio is missing, a source at 44.1 kHz found by its
suffix) and in direct mode (``start``/``end``). The CLI is compared in the
human, json and ndjson modes with the exit codes, a batch whose every
file fails included. The port decodes through its own ``audio/decode`` and
writes through its own ``native/audio``, the JAX package through its.
"""

import json

import numpy as np
import pytest
from click.testing import CliRunner

from fixtures_audio import write_wav

import birda_tpu.api as jax_api
import birda_tpu.cli.main as jax_cli

import birda_tpu_torch.api as port_api
import birda_tpu_torch.cli.main as port_cli

HEADER = "Start (s),End (s),Scientific name,Common name,Confidence,File\n"


def _tone(rate, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    return (0.3 * np.sin(2 * np.pi * 1800 * t)
            + rng.normal(0, 0.05, t.shape)).astype(np.float32)


@pytest.fixture()
def recordings(tmp_path):
    """Two recordings with their detection CSVs, and one CSV whose audio
    is missing."""
    src = tmp_path / "src"
    src.mkdir()
    write_wav(src / "meadow.wav", _tone(48_000, 30, 1), 48_000)
    write_wav(src / "forest.wav", _tone(44_100, 20, 2), 44_100)
    rows = {
        "meadow.wav": [(1.0, 4.0, "Parus major", "Great Tit", 0.91),
                       (3.0, 6.0, "Parus major", "Great Tit", 0.62),
                       (12.0, 15.0, "Corvus corax", "Raven", 0.35),
                       (27.0, 30.0, "Turdus merula", "Blackbird", 0.8)],
        "forest.wav": [(0.0, 3.0, "Erithacus rubecula", "Robin", 0.7),
                       (9.5, 12.5, "Parus major", "Great Tit", 0.55)],
        "ghost.wav": [(0.0, 3.0, "A a", "X", 0.9)],
    }
    csvs = []
    for audio, dets in rows.items():
        p = src / f"{audio}.BirdNET.results.csv"
        p.write_text(HEADER + "".join(
            f"{s},{e},{sci},{com},{c},{audio}\n"
            for s, e, sci, com, c in dets))
        csvs.append(p)
    return src, csvs


def _clips(out):
    return {str(p.relative_to(out)): p.read_bytes()
            for p in sorted(out.rglob("*")) if p.is_file()}


def _summary(s, out):
    """The summary with the output directory taken out of its paths."""
    return (s.total_clips, s.processed_files,
            [{k: (str(v).replace(str(out), "<out>") if k == "path" else v)
              for k, v in c.items()} for c in s.clips],
            s.failures)


@pytest.mark.parametrize("kw", [
    {},
    {"pre": 0.5, "post": 1.0},
    {"min_confidence": 0.6},
    {"species": "Parus major", "pre": 0.0, "post": 0.0},
], ids=["defaults", "padding", "confidence", "species"])
def test_api_clip_csv_mode(tmp_path, recordings, kw):
    _, csvs = recordings
    out = {}
    for name, api in (("jax", jax_api), ("port", port_api)):
        d = tmp_path / name
        out[name] = (_summary(api.clip(csvs, d, **kw), d), _clips(d))
    assert out["port"] == out["jax"]
    summary, clips = out["port"]
    assert summary[0] == len(clips) > 0


def test_api_clip_direct_mode(tmp_path, recordings):
    src, _ = recordings
    files = [src / "meadow.wav", src / "forest.wav"]
    out = {}
    for name, api in (("jax", jax_api), ("port", port_api)):
        d = tmp_path / name
        out[name] = (_summary(api.clip(files, d, start=2.25, end=7.5,
                                       species="manual"), d), _clips(d))
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 2


def test_api_clip_all_failed_raises_alike(tmp_path, recordings):
    from birda_tpu.errors import ClipBatchAllFailed as JaxAllFailed

    from birda_tpu_torch.errors import ClipBatchAllFailed

    _, csvs = recordings
    ghost = [p for p in csvs if p.name.startswith("ghost")]
    with pytest.raises(JaxAllFailed) as want:
        jax_api.clip(ghost, tmp_path / "jax")
    with pytest.raises(ClipBatchAllFailed) as got:
        port_api.clip(ghost, tmp_path / "port")
    assert str(got.value) == str(want.value)


def _run_jax(argv):
    r = CliRunner().invoke(jax_cli.cli, argv)
    return r.exit_code, r.stdout


def _run_port(argv, capsys):
    capsys.readouterr()
    code = port_cli.main(argv)
    return code, capsys.readouterr().out


def _normalize(out, d):
    text = out.replace(str(d), "<out>").strip()
    if text.startswith(("[", "{")):
        docs = json.loads(text) if text.startswith("[") else \
            [json.loads(ln) for ln in text.splitlines()]
        for doc in docs:
            doc.pop("timestamp", None)
        return docs
    return text


@pytest.mark.parametrize("mode", ["human", "json", "ndjson"])
@pytest.mark.parametrize("case", ["csv", "direct", "all_failed"])
def test_cli_clip(tmp_path, recordings, capsys, mode, case):
    src, csvs = recordings
    if case == "csv":
        args = [str(p) for p in csvs] + ["--pre", "1", "--post", "0.5",
                                         "--confidence", "0.5"]
        code = 0
    elif case == "direct":
        args = ["--audio", str(src / "forest.wav"), "--start", "1.5",
                "--end", "4", "--species", "Robin call"]
        code = 0
    else:
        args = [str(p) for p in csvs if p.name.startswith("ghost")]
        code = 1
    mode_args = [] if mode == "human" else ["--output-mode", mode]
    out = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        argv = ["clip", *args, "-o", str(d), *mode_args]
        rc, text = _run_jax(argv) if name == "jax" else \
            _run_port(argv, capsys)
        out[name] = (rc, _normalize(text, d), _clips(d) if d.exists()
                     else {})
    assert out["port"] == out["jax"]
    assert out["port"][0] == code


@pytest.mark.parametrize("argv", [
    ["--start", "1"],
    ["--audio", "a.wav", "--start", "1", "--end", "2", "b.wav"],
    ["--start", "1", "--end", "2"],
    [],
    ["x.csv", "--pre", "-1"],
    ["x.csv", "--confidence", "1.5"],
])
def test_cli_clip_usage_errors(argv, capsys):
    want = CliRunner().invoke(jax_cli.cli, ["clip", *argv])
    with pytest.raises(SystemExit) as got:
        port_cli.main(["clip", *argv])
    err = capsys.readouterr().err
    assert got.value.code == want.exit_code == 2
    message = want.stderr.strip().splitlines()[-1]
    # click's "Error: Invalid value for '--pre': m" / "Error: m" against
    # argparse's "prog clip: error: argument --pre: m" / "error: m".
    assert message.split(": ")[-1] in err.strip().splitlines()[-1]
