"""The port's CLI reads the JAX CLI's ``BIRDA_*`` environment variables.

For each variable the two commands share, the port's ``analyze`` must build
the same options as the JAX ``birda analyze`` under the same environment
(each run stops where the analysis would start: ``analyze_files`` is
replaced by a recorder), refuse what the JAX command refuses, and let a
flag on the command line win over its variable. ``--decode-workers`` is
bounded to 0-64 as ``click.IntRange(0, 64)`` bounds it.
"""

import enum
from pathlib import Path

import pytest

from birda_tpu_torch.cli.main import main

#: AnalyzeOptions fields that the command line sets.
FIELDS = [
    "inputs", "model", "model_path", "labels_path", "model_type", "bat",
    "formats", "output_dir", "min_confidence", "overlap", "batch_size",
    "combine", "force", "no_csv_bom", "lat", "lon", "week", "month", "day",
    "day_of_year", "range_threshold", "rerank", "range_unmatched", "slist",
    "stale_lock_timeout", "jobs", "stdout_mode", "dual_output_mode",
    "geomodel_path", "geomodel_labels_path", "allow_download",
    "region_labels", "decode_workers", "devices", "precision",
    "calibration_audio",
]

#: Every BIRDA_* variable of the JAX analyze command.
VARIABLES = [
    "BIRDA_MODEL", "BIRDA_MODEL_PATH", "BIRDA_LABELS_PATH",
    "BIRDA_MODEL_TYPE", "BIRDA_BAT", "BIRDA_FORMAT", "BIRDA_OUTPUT_DIR",
    "BIRDA_MIN_CONFIDENCE", "BIRDA_OVERLAP", "BIRDA_BATCH_SIZE",
    "BIRDA_COMBINE", "BIRDA_NO_CSV_BOM", "BIRDA_LATITUDE", "BIRDA_LONGITUDE",
    "BIRDA_WEEK", "BIRDA_MONTH", "BIRDA_DAY", "BIRDA_DAY_OF_YEAR",
    "BIRDA_RANGE_THRESHOLD", "BIRDA_RERANK", "BIRDA_RANGE_UNMATCHED",
    "BIRDA_SLIST", "BIRDA_STALE_LOCK_TIMEOUT", "BIRDA_JOBS",
    "BIRDA_NO_PROGRESS", "BIRDA_OUTPUT_MODE", "BIRDA_DECODE_WORKERS",
    "BIRDA_DEVICES", "BIRDA_PRECISION", "BIRDA_CALIBRATION_AUDIO",
    "BIRDA_REGION_LABELS", "BIRDA_PROFILE", "BIRDA_GEOMODEL_PATH",
    "BIRDA_GEOMODEL_LABELS_PATH", "BIRDA_META_MODEL_PATH",
]


@pytest.fixture()
def clean_env(tmp_path, monkeypatch):
    for name in VARIABLES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    return monkeypatch


def _plain(value):
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def _record(seen):
    def analyze_files(options, config, reporter=None):
        seen["options"] = {f: _plain(getattr(options, f)) for f in FIELDS}
        return 0
    return analyze_files


def _human_reporter(module, seen):
    """A HumanReporter that records whether progress bars were asked for."""
    real = getattr(module.HumanReporter, "real", module.HumanReporter)

    def make(enabled=True):
        seen["progress"] = enabled
        return real(enabled)
    make.real = real
    return make


def _jax(args, env, monkeypatch):
    from click.testing import CliRunner

    import birda_tpu.cli.main as jax_cli
    import birda_tpu.output.progress as jax_progress

    seen = {}
    monkeypatch.setattr(jax_cli, "analyze_files", _record(seen))
    monkeypatch.setattr(jax_progress, "HumanReporter",
                        _human_reporter(jax_progress, seen))
    result = CliRunner().invoke(jax_cli.cli, ["analyze", *args], env=env)
    return result.exit_code, seen


def _port(args, env, monkeypatch):
    import birda_tpu_torch.orchestrator as orchestrator
    import birda_tpu_torch.output.progress as port_progress

    seen = {}
    monkeypatch.setattr(orchestrator, "analyze_files", _record(seen))
    monkeypatch.setattr(port_progress, "HumanReporter",
                        _human_reporter(port_progress, seen))
    with monkeypatch.context() as m:
        for name, value in env.items():
            m.setenv(name, value)
        try:
            code = main(["analyze", *args])
        except SystemExit as e:
            code = e.code
    return code, seen


ARGS = ["rec.wav", "--cpu"]

ENV_CASES = {
    "model": {"BIRDA_MODEL": "tiny"},
    "ad_hoc": {"BIRDA_MODEL_PATH": "/m/tiny.onnx",
               "BIRDA_LABELS_PATH": "/m/labels.txt",
               "BIRDA_MODEL_TYPE": "perch-v2"},
    "bat": {"BIRDA_BAT": "usa-east"},
    "formats": {"BIRDA_FORMAT": "csv,json raven"},
    "output": {"BIRDA_OUTPUT_DIR": "/out", "BIRDA_OUTPUT_MODE": "json"},
    "min_confidence": {"BIRDA_MIN_CONFIDENCE": "0.25"},
    "overlap_batch": {"BIRDA_OVERLAP": "1.5", "BIRDA_BATCH_SIZE": "16"},
    "combine_yes": {"BIRDA_COMBINE": "yes"},
    "combine_off": {"BIRDA_COMBINE": "Off"},
    "no_csv_bom": {"BIRDA_NO_CSV_BOM": "1"},
    "coordinates": {"BIRDA_LATITUDE": "60.2", "BIRDA_LONGITUDE": "-24.9",
                    "BIRDA_WEEK": "20"},
    "month_day": {"BIRDA_MONTH": "5", "BIRDA_DAY": "17",
                  "BIRDA_DAY_OF_YEAR": "140"},
    "range": {"BIRDA_RANGE_THRESHOLD": "0.05", "BIRDA_RERANK": "true",
              "BIRDA_RANGE_UNMATCHED": "drop"},
    "slist_lock": {"BIRDA_SLIST": "/s.txt", "BIRDA_STALE_LOCK_TIMEOUT": "2h"},
    "jobs_devices": {"BIRDA_JOBS": "3", "BIRDA_DEVICES": "2"},
    "no_progress": {"BIRDA_NO_PROGRESS": "y"},
    "decode_workers": {"BIRDA_DECODE_WORKERS": "64"},
    "precision": {"BIRDA_PRECISION": "int8"},
    "calibration": {"BIRDA_PRECISION": "mixed",
                    "BIRDA_CALIBRATION_AUDIO": "/c.wav"},
    "region": {"BIRDA_REGION_LABELS": "/r/europe.txt"},
    "geomodel": {"BIRDA_GEOMODEL_PATH": "/g.onnx",
                 "BIRDA_GEOMODEL_LABELS_PATH": "/g.txt"},
    "meta_model": {"BIRDA_META_MODEL_PATH": "/meta.onnx"},
    "empty_is_unset": {"BIRDA_PRECISION": "", "BIRDA_COMBINE": ""},
}


#: Cases whose variables change no option (an empty variable is unset, off
#: is the flag's default, the meta-model path is deprecated and only warns).
NO_EFFECT = {"empty_is_unset", "combine_off", "meta_model"}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_variables_give_the_jax_commands_options(case, clean_env):
    env = ENV_CASES[case]
    want_code, want = _jax(ARGS, env, clean_env)
    got_code, got = _port(ARGS, env, clean_env)
    assert want_code == got_code == 0
    assert got == want
    _, unset = _port(ARGS, {}, clean_env)
    assert (got == unset) == (case in NO_EFFECT)


FLAG_CASES = {
    "precision": ({"BIRDA_PRECISION": "int8"}, ["--precision", "bf16"]),
    "format": ({"BIRDA_FORMAT": "json raven"}, ["-f", "csv"]),
    "combine": ({"BIRDA_COMBINE": "0"}, ["--combine"]),
    "min_confidence": ({"BIRDA_MIN_CONFIDENCE": "0.9"}, ["-c", "0.2"]),
    # The flag wins before the variable is read: its bad value is unseen.
    "invalid_variable": ({"BIRDA_DECODE_WORKERS": "65"},
                         ["--decode-workers", "3"]),
}


@pytest.mark.parametrize("env,flags", list(FLAG_CASES.values()),
                         ids=list(FLAG_CASES))
def test_a_flag_beats_its_variable(env, flags, clean_env):
    want_code, want = _jax(ARGS + flags, env, clean_env)
    got_code, got = _port(ARGS + flags, env, clean_env)
    assert want_code == got_code == 0
    assert got == want
    _, unflagged = _port(ARGS, {}, clean_env)
    assert got["options"] != unflagged["options"]


REFUSED = {
    "min_confidence": ({"BIRDA_MIN_CONFIDENCE": "2"}, []),
    "combine": ({"BIRDA_COMBINE": "maybe"}, []),
    "precision": ({"BIRDA_PRECISION": "int4"}, []),
    "format": ({"BIRDA_FORMAT": "mp3"}, []),
    "bat": ({"BIRDA_BAT": "mars"}, []),
    "decode_workers_variable": ({"BIRDA_DECODE_WORKERS": "65"}, []),
    "decode_workers_negative": ({}, ["--decode-workers", "-1"]),
    "decode_workers_above_64": ({}, ["--decode-workers", "65"]),
    "devices_zero": ({"BIRDA_DEVICES": "0"}, []),
    "week_and_month": ({"BIRDA_WEEK": "3"}, ["--month", "5", "--day", "1"]),
    "month_without_day": ({"BIRDA_MONTH": "5"}, []),
    "geomodel_half": ({"BIRDA_GEOMODEL_PATH": "/g.onnx"}, []),
    "calibration_in_fp32": ({"BIRDA_CALIBRATION_AUDIO": "/c.wav"}, []),
}


@pytest.mark.parametrize("env,flags", list(REFUSED.values()), ids=list(REFUSED))
def test_what_the_jax_command_refuses_is_refused(env, flags, clean_env):
    want_code, want = _jax(ARGS + flags, env, clean_env)
    got_code, got = _port(ARGS + flags, env, clean_env)
    assert want_code == got_code == 2
    assert "options" not in got and "options" not in want


def test_profile_variable_writes_a_trace(clean_env, tmp_path):
    """``BIRDA_PROFILE`` (``--profile``) wraps the analysis in a
    torch.profiler run and writes its Chrome trace into the directory."""
    trace_dir = tmp_path / "trace"
    code, seen = _port(ARGS, {"BIRDA_PROFILE": str(trace_dir)}, clean_env)
    assert code == 0 and "options" in seen
    (trace,) = Path(trace_dir).glob("birda.*.pt.trace.json")
    assert trace.stat().st_size > 0
