"""``scripts/torch_bench_host_budget.py`` (the port's host budget) against
the JAX package's ``scripts/bench_host_budget.py`` at a small size: the
same ``host`` record (its keys, the chunk's audio seconds), every time and
rate positive, and whether the port's native decoder loaded. Times on this
machine's CPU are not compared: they measure this host, not a card.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
ARGS = ["--seconds", "2", "--batch", "4"]
HOST_KEYS = ["decode_x_realtime_1thread", "assemble_ms_per_chunk",
             "quantize_ms_per_chunk", "chunk_audio_seconds",
             "host_bound_x_realtime_excl_decode",
             "host_bound_x_realtime_serial_1thread", "note"]


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def records():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert _script("torch_bench_host_budget").main(ARGS) == 0
    port = json.loads(out.getvalue())
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["bench_host_budget.py", *ARGS]
    try:
        with contextlib.redirect_stdout(out):
            assert _script("bench_host_budget").main() == 0
    finally:
        sys.argv = argv
    return port, json.loads(out.getvalue())


def test_keys_match_the_jax_script(records):
    port, jax = records
    assert set(port) == {"host", "native_decoder_loaded"}
    assert list(port["host"]) == list(jax["host"]) == HOST_KEYS
    assert port["host"]["note"] == jax["host"]["note"]
    # Two seconds at 48 kHz: one window, shorter than 3 s.
    assert port["host"]["chunk_audio_seconds"] == pytest.approx(2.0)
    assert jax["host"]["chunk_audio_seconds"] == pytest.approx(2.0)


def test_every_value_is_positive(records):
    port, _ = records
    for key, value in port["host"].items():
        if key != "note":
            assert isinstance(value, float) and value > 0, key


def test_reports_whether_the_native_decoder_loaded(records):
    from birda_tpu_torch.native import audio

    assert records[0]["native_decoder_loaded"] is audio.available()


def test_runs_where_the_native_library_does_not_load(monkeypatch, capsys):
    """A machine whose native decoder does not build (no FFmpeg libraries)
    writes its test file with the standard library, decodes it with the
    Python WAV reader and quantizes in numpy, and says so."""
    from birda_tpu_torch.native import audio

    monkeypatch.setattr(audio, "_load", lambda: None)
    assert _script("torch_bench_host_budget").main(ARGS) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["native_decoder_loaded"] is False
    assert list(rec["host"]) == HOST_KEYS
    assert all(v > 0 for k, v in rec["host"].items() if k != "note")
