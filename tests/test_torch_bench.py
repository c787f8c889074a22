"""The port's measuring tools (``scripts/torch_bench.py``,
``scripts/torch_bench_int8.py``, ``scripts/torch_sweep_int8_batch.py``)
on the CPU, at the tiny graphs, against ``bench.py`` and the JAX scripts:

- without a card and without ``--device cpu`` each raises
  ``RuntimeInitialization`` and exits non-zero with no result line;
- the bench step on a seeded int16 batch gives the JAX ``_bench_onnx``
  step's top-5: values within ``TOP5_BOUND``, the same indices up to
  classes whose bf16 scores tie within that bound;
- the realtime arithmetic and the segment count are ``bench._measure``'s;
- ``quantized_nodes`` is the JAX ``lower_int8`` count, and the int8
  record carries ``bench_int8.py``'s keys;
- each timed window steps until it lasts ``MIN_WINDOW_S``;
- the native backbone is held on its logits and embeddings against fp32,
  and planted faults (and a backbone that ignores its dtype) break that
  check;
- the sweep prints one line per point and the argmax line;
- a tiny ``e2e`` writes its CSVs through ``analyze``;
- a budget of 0 s, a failed check or an unknown key exits non-zero with a
  ``"complete": false`` line and no result line.

Times on this machine's CPU measure this host, not a card: only their
arithmetic and signs are held.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
sys.path.insert(0, str(SCRIPTS))

import torch_bench as tb  # noqa: E402

#: Top-5 sigmoid (v2.4, v3.0) or softmax (Perch v2) scores of the port's
#: bf16 step against the JAX package's bf16 step on the same batch,
#: absolute: the bf16 score bound of the JAX package's own tests.
TOP5_BOUND = 1e-2
SMALL = ["--device", "cpu", "--iters", "2", "--repeats", "2", "--batch",
         "4"]
TOOLS = ["torch_bench", "torch_bench_int8", "torch_sweep_int8_batch"]


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """A cache of its own (graphs and calibration scales), one torch
    thread per test process, and windows of one pass over the batches
    (``test_windows_are_sized_by_time`` holds the sizing)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(tb, "MIN_WINDOW_S", 0.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fresh_bench():
    spec = importlib.util.spec_from_file_location("bench_under_test",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    """``main(argv)``'s return code and its stdout lines, parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.strip()]


def _subprocess(tool, args, **env):
    return subprocess.run(
        [sys.executable, str(SCRIPTS / f"{tool}.py"), *args],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, **env})


# -- the device contract ----------------------------------------------------------

@pytest.mark.parametrize("tool", TOOLS)
def test_without_a_card_each_tool_raises_and_exits_non_zero(tool):
    r = _subprocess(tool, [], CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "RuntimeInitialization" in r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    assert lines and lines[-1]["complete"] is False
    assert "no CUDA device" in lines[-1]["error"]
    assert not any("metric" in ln or "best" in ln for ln in lines)


def test_auto_raises_a_typed_error_in_process(monkeypatch, capsys):
    from birda_tpu_torch.errors import RuntimeInitialization

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeInitialization):
        tb.main(["--device", "auto", "--only", "birdnet_v24"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["complete"] is False and "metric" not in line


# -- the step and its arithmetic against bench.py -----------------------------------

@pytest.mark.parametrize("family", ["birdnet-v24", "birdnet-v30", "perch-v2"])
def test_bench_step_gives_the_jax_steps_top5(family, monkeypatch):
    import jax
    import jax.numpy as jnp

    from birda_tpu.onnx import fullscale as jfs

    # The JAX front end on its Pallas kernel in interpret mode, as the JAX
    # package's own CPU tests run it (XLA:CPU has no bf16 dot).
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    bench = _fresh_bench()
    captured = {}

    def capture(step_fn, args, xs_shape, seconds_per_segment, iters,
                reuse_inputs=False):
        captured.update(step=step_fn, args=args)
        return 1.0

    monkeypatch.setattr(bench, "_measure", capture)
    bench._bench_onnx(jfs.tiny_spec(jfs.SPECS[family]), batch=4, iters=1)
    cpu = torch.device("cpu")
    prep = tb.prepare(family, "bf16", cpu)
    x16 = tb.int16_batches(1, 4, prep.spec.sample_count, seed=3)[0]
    top_k = jax.lax.top_k
    seen = {}

    def recording_top_k(scores, k):  # the step's whole score rows too
        seen["scores"] = np.asarray(scores)
        return top_k(scores, k)

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    want_vals, want_idx = captured["step"](
        captured["args"], jnp.asarray(x16).astype(jnp.float32)
        * (1.0 / 32768.0))
    want_vals, want_idx = np.asarray(want_vals), np.asarray(want_idx)
    with torch.inference_mode():
        got_vals, got_idx = torch.topk(
            prep.scores(tb.dequantize(torch.from_numpy(x16))), tb.TOP_K)
    got_vals, got_idx = got_vals.numpy(), got_idx.numpy()
    assert np.abs(got_vals - want_vals).max() <= TOP5_BOUND
    # The same indices, up to classes whose bf16 scores tie within the
    # bound: where the port picks another class at a rank, the JAX step
    # scored that class within the bound of its own pick.
    same = got_idx == want_idx
    tied = np.abs(np.take_along_axis(seen["scores"], got_idx, 1)
                  - want_vals) <= TOP5_BOUND
    assert (same | tied).all()
    if family == "perch-v2":  # softmax scores without ties
        assert same.all()


def test_realtime_arithmetic_is_bench_measures(monkeypatch):
    import jax

    bench = _fresh_bench()
    clock = iter([10.0, 12.5])

    class Clock:
        perf_counter = staticmethod(lambda: next(clock))
        monotonic = staticmethod(bench.time.monotonic)
        time = staticmethod(bench.time.time)

    monkeypatch.setattr(bench, "time", Clock)
    iters, batch, samples, segment_s = 3, 5, 64, 3.0
    want = bench._measure(lambda a, x: jax.lax.top_k(x, 5), 0,
                          (iters, batch, samples), segment_s, iters)
    assert tb.realtime(batch, iters, 2.5, segment_s) == pytest.approx(
        want, rel=1e-12)
    # the port's record: batch x iters segments per window, the median
    # window's rate
    rec = tb.measure(tb.prepare("birdnet-v24", "bf16", torch.device("cpu")),
                     batch=2, iters=3, repeats=3, seed=0,
                     dev=torch.device("cpu"))
    assert rec["steps_per_window"] == 3
    assert rec["segments_per_window"] == 2 * 3
    assert rec["x_realtime"] == pytest.approx(
        rec["segments_per_s"] * 144_000 / 48_000)
    assert rec["x_realtime_min"] <= rec["x_realtime"] <= rec["x_realtime_max"]
    assert len(rec["x_realtime_windows"]) == 3
    assert rec["steps"] == rec["routes"]["fused_logmel:kernel"] == (
        1 + 3 + 9 + tb.PROFILE_STEPS)


def test_windows_are_sized_by_time(monkeypatch):
    """Each window steps through the batches until it lasts MIN_WINDOW_S,
    as one timed pass over them predicts."""
    monkeypatch.setattr(tb, "MIN_WINDOW_S", 0.5)
    rec = tb.measure(tb.prepare("birdnet-v24", "bf16", torch.device("cpu")),
                     batch=2, iters=2, repeats=3, seed=0,
                     dev=torch.device("cpu"))
    steps = rec["steps_per_window"]
    assert steps == max(2, -(-2 * 0.5 // rec["sizing_window_s"]))
    assert steps > 2 and rec["segments_per_window"] == 2 * steps
    assert rec["x_realtime"] == pytest.approx(tb.realtime(
        2, steps, rec["window_s"], 3.0))
    assert rec["steps"] == 1 + 2 + 3 * steps + tb.PROFILE_STEPS


def test_int16_batches_are_bench_pys_draw_from_a_seed():
    x = tb.int16_batches(2, 3, 50, seed=9)
    host = np.random.default_rng(9).normal(0, 0.1, (2, 3, 50))
    assert x.dtype == np.int16
    assert np.array_equal(x, np.clip(host * 32767.0, -32768, 32767)
                          .astype(np.int16))
    assert not np.array_equal(x[0], x[1])  # distinct batches


# -- the int8 tool --------------------------------------------------------------------

@pytest.mark.parametrize("family", ["birdnet-v24", "perch-v2"])
def test_quantized_nodes_is_the_jax_lower_int8_count(family, tmp_path,
                                                      monkeypatch):
    from birda_tpu.onnx import fullscale as jfs
    from birda_tpu.onnx import quantize as jq

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "jax"))
    g = jfs.cached_build(jfs.tiny_spec(jfs.SPECS[family]), seed=1)
    calib, _ = jq.cached_calibration(g.model_bytes, g.spec.sample_count)
    want = len(jq.lower_int8(g.model_bytes, calib).quantized_nodes)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "port"))
    prep = tb.prepare(family, "int8", torch.device("cpu"))
    assert prep.setup["calibration_cached"] is False
    assert prep.quantized_nodes == want > 0


def test_int8_tool_carries_bench_int8_keys():
    import torch_bench_int8

    rc, lines = _run(torch_bench_int8.main, ["birdnet-v24", *SMALL])
    assert rc == 0 and len(lines) == 2
    rec = lines[-1]["birdnet-v24"]
    assert lines[0] == {"birdnet-v24": rec}
    assert list(rec)[:9] == [
        "bf16_x_realtime", "int8_x_realtime", "speedup", "quantized_nodes",
        "max_score_drift_vs_bf16", "top1_agree", "param_bytes_int8",
        "param_bytes_bf16", "card"]
    assert rec["card"] == "cpu"
    assert rec["speedup"] == pytest.approx(
        rec["int8_x_realtime"] / rec["bf16_x_realtime"])
    assert rec["quantized_nodes"] == \
        rec["measurements"]["int8"]["quantized_nodes"] > 0
    assert 0 <= rec["max_score_drift_vs_bf16"] <= tb.SCORE_DRIFT_BOUND
    assert rec["top1_agree"] == 1.0
    assert all(rec[k] > 0 for k in ("bf16_x_realtime", "int8_x_realtime",
                                     "param_bytes_int8", "param_bytes_bf16"))


# -- the sweep ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage_only", ["", "1"], ids=["int8", "mixed"])
def test_sweep_prints_one_line_per_point_and_the_argmax(storage_only,
                                                       monkeypatch):
    import torch_sweep_int8_batch as sweep

    monkeypatch.delenv("BATCHES", raising=False)
    monkeypatch.setenv("STORAGE_ONLY", storage_only)
    rc, lines = _run(sweep.main, ["perch-v2", "--device", "cpu", "--iters",
                                  "1", "--repeats", "1"])
    mode = "mixed" if storage_only else "int8"
    assert rc == 0 and len(lines) == 3
    points, summary = lines[:2], lines[2]
    assert [(p["family"], p["batch"], p["mode"]) for p in points] == [
        ("perch-v2", 8, mode), ("perch-v2", 16, mode)]
    assert all(p["x_realtime"] > 0 and p["card"] == "cpu" for p in points)
    best = max(points, key=lambda p: p["x_realtime"])
    assert summary == {"best": {"perch-v2": {
        "batch": best["batch"], "x_realtime": best["x_realtime"]}},
        "mode": mode, "card": "cpu"}


def test_sweep_takes_its_grid_from_batches(monkeypatch):
    import torch_sweep_int8_batch as sweep

    monkeypatch.setenv("BATCHES", "3")
    rc, lines = _run(sweep.main, ["birdnet-v24", "--device", "cpu",
                                  "--iters", "1", "--repeats", "1"])
    assert rc == 0 and [ln.get("batch") for ln in lines[:-1]] == [3]


# -- torch_bench: e2e, the result line, the failure contract -------------------------

def test_tiny_e2e_writes_its_csvs():
    rc, lines = _run(tb.main, [*SMALL, "--only", "e2e", "--e2e-seconds", "9",
                               "--e2e-files", "2"])
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    rec = line["extra"]["measurements"]["e2e"]
    assert rec["files"] == 2 and len(rec["csv_bytes"]) == 2
    assert all(b > 0 for b in rec["csv_bytes"])
    assert line["extra"]["e2e_x_realtime"] == rec["x_realtime"] > 0
    assert rec["routes"]["fused_logmel:kernel"] > 0
    # no headline selected: no value
    assert line["value"] is None and line["vs_baseline"] is None


def test_result_line_has_bench_pys_shape_and_keys():
    rc, lines = _run(tb.main, [*SMALL, "--only",
                               "birdnet_v24,perch_v2,native_v24"])
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert line["metric"].endswith("(cpu smoke, tiny)")
    assert line["unit"] == "x realtime"
    extra = line["extra"]
    assert line["value"] == extra["birdnet_v24_x_realtime"] > 0
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / tb.BASELINE_BIRDNET_V24)
    assert extra["perch_v2_vs_its_baseline"] == pytest.approx(
        extra["perch_v2_x_realtime"] / tb.BASELINE_PERCH_V2)
    assert extra["card"] == "cpu"
    recs = extra["measurements"]
    assert set(recs) == {"birdnet_v24", "perch_v2", "native_v24"}
    for key, rec in recs.items():
        assert rec["batch"] == 4 and rec["drift"] <= tb.SCORE_DRIFT_BOUND
        assert rec["top1_agree"] == 1.0
    assert recs["perch_v2"]["drift_relative_to_max_score"] is True
    assert recs["perch_v2"]["routes"]["conv1d_stft:kernel"] > 0
    # the native backbone in bf16 runs no front-end kernel
    assert recs["native_v24"]["routes"] == {} == recs["native_v24"]["launches"]


def test_native_check_reads_logits_and_embeddings():
    """The native backbone is held on its logits and embeddings relative
    to their largest fp32 value: the sigmoid scores of synthetic weights
    sit at 0.5 and read nothing, a bf16 run reads above 0 and within the
    bound, and every planted fault (each stage without its swish) past
    it."""
    cpu = torch.device("cpu")
    rec = tb.measure(tb.prepare("birdnet-v24", "bf16", cpu, native=True),
                     batch=4, iters=1, repeats=1, seed=0, dev=cpu)
    assert rec["drift_of"] == "logits and embeddings"
    assert 0 < rec["drift"] == max(rec["logits_drift"],
                                   rec["embeddings_drift"])
    assert rec["drift"] <= rec["drift_bound"] == tb.NATIVE_DRIFT_BOUND
    assert rec["max_score_drift"] < 1e-4 * rec["drift"] / 1e-2
    assert rec["top1_agree"] == 1.0
    # the tiny model: a stem, three blocks (none residual) and a head conv
    assert len(rec["planted_fault_drift"]) == 5
    assert rec["planted_fault_drift_min"] > tb.NATIVE_DRIFT_BOUND
    assert rec["stage_dtypes"] == ["bfloat16"]


def test_native_faults_are_planted_only_where_they_change_the_model():
    """A stage without a swish (a fused block of expand 1 ends in a bare
    conv) plants no fault; a residual block is also skipped. Every planted
    fault reads past the sound bf16 reading."""
    from birda_tpu_torch.models import zoo

    blocks = ((16, 1, 3, 1, 1, True), (24, 2, 3, 2, 2, False))
    cpu = torch.device("cpu")
    bf16 = zoo.native_model("birdnet-v24", dtype=torch.bfloat16,
                            blocks=blocks)
    fp32 = zoo.native_model("birdnet-v24", blocks=blocks)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.1, (2, bf16.config.sample_count)).astype(np.float32))
    with torch.inference_mode():
        rec = tb.native_drift(bf16, fp32.apply(x), x, cpu)
    # stem, fused block, MBConv at stride 2, residual MBConv, head conv
    assert set(rec["planted_fault_drift"]) == {
        "stage 0 without swish", "stage 2 without swish",
        "stage 3 without swish", "stage 3 skipped", "stage 4 without swish"}
    assert rec["planted_fault_drift_min"] > 2 * rec["drift"] > 0
    assert rec["stage_dtypes"] == ["bfloat16"]


@pytest.mark.parametrize("fault", ["no swish", "fp32 stages"])
def test_native_check_fails_a_faulty_bf16_backbone(fault, monkeypatch):
    """A bf16 backbone with one stage's swish gone, or one that ignores its
    dtype (C10's fault), fails the run."""
    from birda_tpu_torch.models import zoo
    from birda_tpu_torch.models.backbone import ConvBNAct

    tiny = zoo.tiny_model

    def faulty(family, seed=0, dtype=torch.float32):
        if dtype == torch.float32:
            return tiny(family, seed=seed)
        if fault == "fp32 stages":
            return tiny(family, seed=seed)
        model = tiny(family, seed=seed, dtype=dtype)
        stage = model.bind_device(torch.device("cpu")).layers[2]
        for c in stage.modules():
            if isinstance(c, ConvBNAct):
                c.act = False
        return model

    monkeypatch.setattr(zoo, "tiny_model", faulty)
    cpu = torch.device("cpu")
    with pytest.raises(tb.MeasurementFailed) as e:
        tb.measure(tb.prepare("birdnet-v24", "bf16", cpu, native=True),
                   batch=4, iters=1, repeats=1, seed=0, dev=cpu)
    rec = e.value.record
    if fault == "no swish":
        assert rec["drift"] > tb.NATIVE_DRIFT_BOUND
        assert "drift" in str(e.value)
    else:
        assert rec["drift"] == 0.0 and rec["stage_dtypes"] == ["float32"]
        assert "stages out in ['float32']" in str(e.value)


def test_default_batch_is_the_ports_cuda_default():
    cuda = torch.device("cuda", 0)  # the device object only; nothing runs
    assert tb.default_batch("birdnet-v24", cuda) == 64
    assert tb.default_batch("perch-v2", cuda) == 32
    assert tb.default_batch("birdnet-v30", cuda) == 32


@pytest.mark.parametrize("tool,args", [
    ("torch_bench", ["--only", "birdnet_v24"]),
    ("torch_bench_int8", ["birdnet-v24"]),
    ("torch_sweep_int8_batch", ["perch-v2"]),
])
def test_a_budget_of_zero_exits_non_zero_without_a_result(tool, args):
    r = _subprocess(tool, [*args, "--device", "cpu", "--budget", "0"])
    assert r.returncode != 0
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1 and lines[0]["complete"] is False
    assert "budget" in lines[0]["error"]


def test_a_failed_check_exits_with_what_it_has(monkeypatch, capsys):
    monkeypatch.setattr(tb, "SCORE_DRIFT_BOUND", 0.0)
    with pytest.raises(tb.MeasurementFailed, match="drift"):
        tb.main([*SMALL, "--only", "native_v24,birdnet_v24"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1 and lines[0]["complete"] is False
    assert "MeasurementFailed" in lines[0]["error"]
    assert lines[0]["partial"]["extra"]["measurements"] == {}
    failed = lines[0]["failed_record"]  # what the failed measurement had
    assert failed["family"] == "birdnet-v24" and failed["drift"] > 0
    assert failed["x_realtime"] > 0


def test_int8_tool_keeps_the_probe_drift_when_a_check_fails(monkeypatch,
                                                          capsys):
    import torch_bench_int8

    monkeypatch.setattr(tb, "SCORE_DRIFT_BOUND", 0.0)
    with pytest.raises(tb.MeasurementFailed):
        torch_bench_int8.main(["birdnet-v24", *SMALL])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["complete"] is False
    kept = line["partial"]["birdnet-v24"]
    assert set(kept) == {"quantized_nodes", "max_score_drift_vs_bf16",
                         "top1_agree"}
    assert line["partial"]["card"] == "cpu"


def test_an_unknown_key_is_refused(capsys):
    with pytest.raises(ValueError, match="unknown measurement"):
        tb.main([*SMALL, "--only", "birdnet_v24,nope"])
    assert json.loads(capsys.readouterr().out)["complete"] is False


def test_budget_reads_the_jax_tools_variable(monkeypatch):
    monkeypatch.setenv("BIRDA_BENCH_BUDGET", "77")
    assert tb.budget_default() == 77.0
    monkeypatch.delenv("BIRDA_BENCH_BUDGET")
    assert tb.budget_default() == tb.DEFAULT_BUDGET_S == 1380.0


def test_profile_window_traces_no_kernel_on_the_cpu():
    from birda_tpu_torch.ops.measure import idle_share, profile_steps

    x = torch.ones(8, 8)
    rec = profile_steps(lambda: x @ x, 2)
    assert rec == {"device_busy_ms_per_step": 0.0, "kernels_per_step": 0.0,
                   "top_kernels_ms_per_step": []}
    assert idle_share(0.0, 5.0) is None
    assert idle_share(2.0, 5.0) == pytest.approx(0.6)
