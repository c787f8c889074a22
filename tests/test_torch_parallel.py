"""The parallel modes of the PyTorch port's ``analyze`` on the CPU: the
counterparts of ``tests/test_mesh_wiring.py``, the ``--jobs`` tests of
``tests/test_orchestrator.py`` and ``tests/test_multihost.py``.

``--devices N`` shards each batch over N replicas. The JAX suite runs it on
a virtual 8-device CPU platform; here the port's backend selector is doubled
to list eight CPU replicas (``eight_replicas``), each computing its rows of
the batch. A sharded run must write the single-device run's CSV byte for
byte, and ``--jobs 2`` the sequential run's. The pod contract
(``BIRDA_COORDINATOR``) is held by two real processes that join through it
and stamp their ranks into their lock bodies.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from fixtures_audio import write_wav

from birda_tpu_torch.cli.main import main
from birda_tpu_torch.parallel import mesh
from birda_tpu_torch.parallel.sharding import shard_data_parallel

REPO = Path(__file__).resolve().parent.parent
MODEL = ["--model-path", "synthetic:tiny", "--labels-path", "synthetic:tiny",
         "--model-type", "birdnet-v24"]
#: Confidences of the port against the JAX package, absolute.
SCORE_BOUND = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs in several
    processes at once, and torch's thread pools would oversubscribe the
    cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    monkeypatch.setenv("BIRDA_NO_COMPILE_CACHE", "1")
    monkeypatch.delenv("BIRDA_NO_SHARD", raising=False)
    return tmp_path


@pytest.fixture()
def eight_replicas(monkeypatch):
    """The backend selector doubled: a CPU request lists eight CPU
    replicas, as the JAX suite's virtual platform lists eight CPU
    devices."""
    from birda_tpu_torch.inference import backend, classifier

    real = backend.select_backend

    def select(requested="auto"):
        devices, status = real(requested)
        return (devices * 8 if devices[0].type == "cpu" else devices), status

    monkeypatch.setattr(backend, "select_backend", select)
    monkeypatch.setattr(classifier, "select_backend", select)


def _recording(home, name="rec.wav", secs=10.0, rate=48_000, seed=0):
    t = np.arange(int(rate * secs)) / rate
    x = 0.4 * np.sin(2 * np.pi * (2000 + 100 * seed) * t) \
        + np.random.default_rng(seed).normal(0, 0.05, t.shape)
    p = home / name
    write_wav(p, x.astype(np.float32), rate)
    return p


def _analyze(audio, out_dir, *extra):
    inputs = [str(a) for a in (audio if isinstance(audio, list) else [audio])]
    assert main(["analyze", *inputs, "-o", str(out_dir), "-f", "csv",
                 "-c", "0.01", "--cpu", *MODEL, *extra]) == 0
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.csv"))}


def _started_payload(out: str) -> dict:
    for line in out.splitlines():
        if line.startswith("{"):
            doc = json.loads(line)
            if doc["event"] == "pipeline_started":
                return doc["payload"]
    raise AssertionError("no pipeline_started event in output")


# -- --devices -------------------------------------------------------------------

def test_sharded_csv_byte_identical(home, eight_replicas):
    audio = _recording(home)
    csv_1 = _analyze(audio, home / "out1", "--devices", "1")
    csv_8 = _analyze(audio, home / "out8", "--devices", "8")
    assert csv_8 == csv_1
    assert len(next(iter(csv_1.values()))) > 100  # the run found detections


def test_sharded_run_computes_each_replicas_rows(home, eight_replicas,
                                                 monkeypatch):
    """Each of the eight replicas runs its own contiguous rows of every
    batch, in order."""
    from birda_tpu_torch.inference import classifier

    calls = []
    real = classifier.ChunkRunner._step

    def step(self, chunk, scale, rows):
        calls.append((rows.start, rows.stop))
        return real(self, chunk, scale, rows)

    monkeypatch.setattr(classifier.ChunkRunner, "_step", step)
    _analyze(_recording(home), home / "out", "--devices", "8", "-b", "16")
    assert calls and len(calls) % 8 == 0
    for i in range(0, len(calls), 8):
        per = calls[i][1]
        assert calls[i:i + 8] == [(per * r, per * r + per) for r in range(8)]


def test_sharding_reported_in_protocol(home, eight_replicas, capsys):
    from click.testing import CliRunner

    from birda_tpu.cli.main import cli

    audio = _recording(home)
    capsys.readouterr()
    _analyze(audio, home / "out", "--devices", "8", "--output-mode", "ndjson")
    got = _started_payload(capsys.readouterr().out)
    assert got["sharding"] == {"devices": 8, "axis": "data", "backend": "cpu"}
    r = CliRunner().invoke(cli, ["analyze", str(audio), "-o",
                                 str(home / "jax"), "-f", "csv", "-c", "0.01",
                                 "--cpu", *MODEL, "--devices", "8",
                                 "--output-mode", "ndjson"])
    assert r.exit_code == 0, r.output
    assert got["sharding"] == _started_payload(r.output)["sharding"]


@pytest.mark.parametrize("extra,env", [
    pytest.param([], None, id="cpu_default"),
    pytest.param(["--devices", "1"], None, id="devices_1"),
    pytest.param(["--devices", "8"], "1", id="no_shard_env"),
])
def test_unsharded_runs(home, eight_replicas, capsys, monkeypatch, caplog,
                        extra, env):
    """The CPU shards only on an explicit N; --devices 1 and BIRDA_NO_SHARD
    turn it off (the variable with a warning when --devices asks for
    more)."""
    if env:
        monkeypatch.setenv("BIRDA_NO_SHARD", env)
    capsys.readouterr()
    with caplog.at_level(logging.WARNING):
        _analyze(_recording(home), home / "out", *extra,
                 "--output-mode", "ndjson")
    assert "sharding" not in _started_payload(capsys.readouterr().out)
    warned = any("ignoring --devices 8" in r.getMessage()
                 for r in caplog.records)
    assert warned == (env is not None)


def test_too_many_devices_is_typed_error(home, eight_replicas, capsys):
    from click.testing import CliRunner

    from birda_tpu.cli.main import cli

    audio = _recording(home)
    args = ["analyze", str(audio), "-o", str(home / "out"), "-f", "csv",
            "--cpu", *MODEL, "--devices", "9"]
    want = CliRunner().invoke(cli, args)
    capsys.readouterr()
    assert main(args) == want.exit_code == 1
    err = capsys.readouterr().err
    assert "--devices 9 requested but only 8 local cpu device(s) are " \
        "available" in err
    assert "--devices 9 requested but only 8 local cpu" in want.output


def test_batch_pads_to_mesh_multiple(home, eight_replicas, caplog):
    audio = _recording(home)
    csv_1 = _analyze(audio, home / "out1", "--devices", "1")
    with caplog.at_level(logging.INFO):
        csv_8 = _analyze(audio, home / "out8", "--devices", "8", "-b", "6")
    assert csv_8 == csv_1
    assert any("batch size 6 padded to 8" in r.getMessage()
               for r in caplog.records)


def test_api_devices_matches_unsharded_and_jax(home, eight_replicas):
    import birda_tpu

    import birda_tpu_torch.api

    audio = _recording(home)
    kwargs = dict(model_path="synthetic:tiny", labels_path="synthetic:tiny",
                  model_type="birdnet-v24", min_confidence=0.01,
                  device="cpu")
    runs = [birda_tpu_torch.api.analyze([audio], devices=n, **kwargs)
            for n in (1, 8)]
    want = birda_tpu.analyze([audio], devices=8, **kwargs)
    assert [r.exit_code for r in runs] == [0, 0] and want.exit_code == 0

    def rows(r):
        return [(d.scientific_name, d.confidence, d.start_time)
                for d in r.files[0].detections]

    assert rows(runs[1]) == rows(runs[0])
    assert len(rows(want)) == len(rows(runs[1])) > 0
    for (gn, gc, gt), (wn, wc, wt) in zip(rows(runs[1]), rows(want)):
        assert (gn, gt) == (wn, wt) and abs(gc - wc) <= SCORE_BOUND


@pytest.mark.parametrize("devices,backend", [
    (None, "cpu"), (None, "accelerator"), (0, "cpu"), (1, "accelerator"),
    (3, "cpu"), (8, "accelerator"), (9, "cpu"),
])
def test_resolve_mesh_follows_the_jax_rules(devices, backend):
    import jax

    from birda_tpu.errors import ConfigValidation as JaxConfigValidation
    from birda_tpu.orchestrator import AnalyzeOptions as JaxOptions
    from birda_tpu.orchestrator import resolve_mesh as jax_resolve_mesh

    from birda_tpu_torch.errors import ConfigValidation
    from birda_tpu_torch.orchestrator import AnalyzeOptions, resolve_mesh

    names = {"cpu": ("cpu", "cpu"), "accelerator": ("tpu", "cuda")}[backend]
    port_devices = [torch.device("cpu")] * 8
    try:
        want = jax_resolve_mesh(JaxOptions(devices=devices),
                                jax.devices("cpu"), names[0])
        want = None if want is None else int(want.devices.size)
    except JaxConfigValidation as e:
        want = str(e).replace(names[0], names[1])
    try:
        got = resolve_mesh(AnalyzeOptions(devices=devices), port_devices,
                           names[1])
        got = None if got is None else len(got)
    except ConfigValidation as e:
        got = str(e)
    assert got == want


def test_shard_data_parallel_splits_and_gathers_in_order():
    x = torch.arange(24.0).reshape(8, 3)
    seen = []

    def fn(device, rows):
        seen.append((device.type, rows.start, rows.stop))
        return x[rows] * 2, x[rows].sum(1)

    doubled, sums = shard_data_parallel(fn, [torch.device("cpu")] * 4)(8) \
        .wait()
    assert seen == [("cpu", 0, 2), ("cpu", 2, 4), ("cpu", 4, 6),
                    ("cpu", 6, 8)]
    assert np.array_equal(doubled, (x * 2).numpy())
    assert np.array_equal(sums, x.sum(1).numpy())
    seen.clear()
    (one, _) = shard_data_parallel(fn, [torch.device("cpu")])(8).wait()
    assert seen == [("cpu", 0, 8)] and np.array_equal(one, doubled)


def test_indivisible_batch_is_the_jax_error():
    import jax.numpy as jnp

    from birda_tpu.parallel import mesh as jax_mesh
    from birda_tpu.parallel.sharding import (
        shard_data_parallel as jax_shard_data_parallel)

    m = jax_mesh.make_mesh(8, backend="cpu")
    with pytest.raises(ValueError) as want:
        jax_shard_data_parallel(lambda x: x, m)(jnp.zeros((6, 2)))
    with pytest.raises(ValueError) as got:
        shard_data_parallel(lambda d, r: (), [torch.device("cpu")] * 8)(6)
    assert str(got.value) == str(want.value)
    assert mesh.pad_to_multiple(6, [None] * 8) == \
        jax_mesh.pad_to_multiple(6, m) == 8
    assert mesh.pad_to_multiple(16, [None] * 8) == 16


def test_chunk_runner_batch_must_divide_over_the_replicas(eight_replicas):
    from birda_tpu.inference.classifier import BirdClassifier as JaxClassifier
    from birda_tpu.models import zoo as jz
    from birda_tpu.parallel import mesh as jax_mesh

    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models import zoo

    want = JaxClassifier(jz.tiny_model(), device="cpu",
                         mesh=jax_mesh.make_mesh(8, backend="cpu"))
    got = BirdClassifier(zoo.tiny_model(), device="cpu",
                         mesh=[torch.device("cpu")] * 8)
    with pytest.raises(ValueError) as w:
        want.chunk_runner(6, 144_000)
    with pytest.raises(ValueError) as g:
        got.chunk_runner(6, 144_000)
    assert str(g.value) == str(w.value)


# -- --jobs --------------------------------------------------------------------------

def test_jobs_csv_byte_identical(home):
    audio = [_recording(home, f"f{i}.wav", secs=7.0, seed=i)
             for i in range(3)]
    seq = _analyze(audio, home / "seq", "--jobs", "1")
    par = _analyze(audio, home / "par", "--jobs", "2")
    assert len(seq) == 3 and all(len(v) > 100 for v in seq.values())
    assert par == seq


def _exploding(monkeypatch, bad_name):
    import birda_tpu_torch.orchestrator as orch

    real = orch.process_file
    threads = set()

    def process_file(classifier, pcfg):
        threads.add(threading.current_thread().name)
        if pcfg.input_path.name == bad_name:
            raise RuntimeError("synthetic worker failure")
        return real(classifier, pcfg)

    monkeypatch.setattr(orch, "process_file", process_file)
    return threads


def test_unexpected_exception_isolated_parallel(home, monkeypatch):
    """A non-BirdaError in one worker fails that file, not the run."""
    bad = _recording(home, "aa_bad.wav", secs=3.0)
    good = _recording(home, "zz_good.wav", secs=3.0)
    threads = _exploding(monkeypatch, "aa_bad.wav")
    out = home / "out"
    got = _analyze([bad, good], out, "--jobs", "2")
    assert list(got) == ["zz_good.BirdNET.results.csv"]
    assert threads and threading.current_thread().name not in threads


def test_stdout_mode_forces_sequential_jobs(home, caplog, capsys):
    from birda_tpu_torch.config.types import Config, ModelConfig, ModelType
    from birda_tpu_torch.orchestrator import AnalyzeOptions, analyze_files

    cfg = Config()
    cfg.models["tiny"] = ModelConfig(path=Path("synthetic:tiny"),
                                     labels=Path("synthetic:tiny"),
                                     model_type=ModelType.BIRDNET_V24)
    cfg.defaults.model = "tiny"
    opts = AnalyzeOptions(inputs=[_recording(home, secs=4.0)],
                          stdout_mode=True, jobs=3,
                          device_flags={"cpu": True}, min_confidence=0.0)
    with caplog.at_level(logging.WARNING):
        assert analyze_files(opts, cfg) == 0
    assert opts.jobs == 1
    assert any("ignoring --jobs" in r.getMessage() for r in caplog.records)


def test_jobs_ctrl_c_cancels_queued_files(home, monkeypatch):
    """A SIGINT (SystemExit on the main thread) cancels the files not yet
    started: besides the one that raised, at most one more per worker
    starts (each parks on an event the test never sets)."""
    import birda_tpu_torch.orchestrator as orch

    files = [_recording(home, f"f{i}.wav", secs=3.0) for i in range(6)]
    processed = []
    never_set = threading.Event()

    def fake_process_file(classifier, pcfg):
        processed.append(pcfg.input_path.name)
        if pcfg.input_path.name == "f0.wav":  # the file the main thread
            raise SystemExit(130)             # waits on first
        never_set.wait(timeout=5.0)

    monkeypatch.setattr(orch, "process_file", fake_process_file)
    from birda_tpu_torch.config.types import Config, ModelConfig, ModelType
    from birda_tpu_torch.pipeline.coordinator import OutputFormat

    cfg = Config()
    cfg.models["tiny"] = ModelConfig(path=Path("synthetic:tiny"),
                                     labels=Path("synthetic:tiny"),
                                     model_type=ModelType.BIRDNET_V24)
    cfg.defaults.model = "tiny"
    opts = orch.AnalyzeOptions(
        inputs=files, output_dir=home / "out", formats=[OutputFormat.CSV],
        min_confidence=0.0, device_flags={"cpu": True}, jobs=2)
    with pytest.raises(SystemExit):
        orch.analyze_files(opts, cfg)
    assert len(processed) <= 1 + opts.jobs
    assert "f5.wav" not in processed


def test_decode_workers_yield_to_jobs():
    from birda_tpu.orchestrator import AnalyzeOptions as JaxOptions
    from birda_tpu.orchestrator import resolve_decode_workers as jax_resolve

    from birda_tpu_torch.orchestrator import (AnalyzeOptions,
                                              resolve_decode_workers)

    for jobs, workers in ((1, 0), (4, 0), (4, 3), (1, 2)):
        assert resolve_decode_workers(AnalyzeOptions(
            jobs=jobs, decode_workers=workers)) == jax_resolve(JaxOptions(
                jobs=jobs, decode_workers=workers))
    assert resolve_decode_workers(AnalyzeOptions(jobs=4)) == 1


def test_shared_chunk_runner_is_thread_safe():
    """``--jobs`` workers share one runner: many threads, each with its own
    chunks, each result equal to that chunk's serial result."""
    from birda_tpu_torch.inference.classifier import BirdClassifier
    from birda_tpu_torch.models.zoo import tiny_model

    clf = BirdClassifier(tiny_model(), device="cpu", min_confidence=0.0,
                         top_k=4)
    runner = clf.chunk_runner(4, 48_000)
    rng = np.random.default_rng(11)
    chunks = [rng.normal(0, 0.2, runner.chunk_samples).astype(np.float32)
              for _ in range(12)]

    def table(results):
        return [[(p.index, p.confidence) for p in r.predictions]
                for r in results]

    serial = [table(runner.predict_chunk(c, 4)) for c in chunks]
    got = {}
    start = threading.Barrier(len(chunks))

    def worker(i):
        start.wait()
        got[i] = [table(runner.predict_chunk(chunks[i], 4))
                  for _ in range(3)]

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(chunks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    for i, want in enumerate(serial):
        assert got[i] == [want] * 3, f"chunk {i}"


# -- the pod contract (ROADMAP C6) ------------------------------------------------------

@pytest.fixture()
def fresh_pod(monkeypatch):
    monkeypatch.setattr(mesh, "_distributed_initialized", False)


def test_no_pod_without_the_contract(fresh_pod):
    assert mesh.initialize_multihost(env={}) is False
    assert mesh._distributed_initialized is False
    assert mesh.process_index() == 0


@pytest.mark.parametrize("env", [
    {},
    {"BIRDA_NUM_PROCESSES": "2"},
    {"BIRDA_NUM_PROCESSES": "two", "BIRDA_PROCESS_ID": "0"},
    {"BIRDA_NUM_PROCESSES": "2", "BIRDA_PROCESS_ID": "1.5"},
], ids=["both_missing", "rank_missing", "world_not_int", "rank_not_int"])
def test_malformed_contract_is_the_jax_typed_error(fresh_pod, env):
    from birda_tpu.errors import ConfigValidation as JaxConfigValidation
    from birda_tpu.parallel import mesh as jax_mesh

    from birda_tpu_torch.errors import ConfigValidation

    env = {"BIRDA_COORDINATOR": "10.0.0.1:8476", **env}
    with pytest.raises(JaxConfigValidation) as want:
        jax_mesh.initialize_multihost(env=env)
    with pytest.raises(ConfigValidation) as got:
        mesh.initialize_multihost(env=env)
    assert str(got.value) == str(want.value)
    assert mesh._distributed_initialized is False


def test_contract_joins_once(fresh_pod, monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    env = {mesh.ENV_COORDINATOR: "10.0.0.1:8476",
           mesh.ENV_NUM_PROCESSES: "4", mesh.ENV_PROCESS_ID: "2"}
    assert mesh.initialize_multihost(env=env) is True
    assert calls == [(("gloo",), {"init_method": "tcp://10.0.0.1:8476",
                                  "world_size": 4, "rank": 2})]
    assert mesh.initialize_multihost(env=env) is True
    assert len(calls) == 1


def test_analyze_joins_the_pod_first(home, monkeypatch, caplog):
    import birda_tpu_torch.orchestrator as orch
    from birda_tpu_torch.parallel import mesh as port_mesh

    joined = []
    monkeypatch.setattr(port_mesh, "initialize_multihost",
                        lambda env=None: joined.append(True) or True)
    with caplog.at_level(logging.INFO):
        _analyze(_recording(home, secs=3.0), home / "out")
    assert joined == [True]
    assert any(r.getMessage().startswith("pod joined: files divide")
               for r in caplog.records if r.name == orch.__name__)


_CHILD = """
import json, os, sys
for name in ("jax", "jaxlib", "flax", "birda_tpu"):
    sys.modules[name] = None
from pathlib import Path
import torch.distributed as dist
from birda_tpu_torch.locking.file_lock import FileLock
from birda_tpu_torch.parallel import mesh
assert mesh.initialize_multihost() is True
rank = mesh.process_index()
ranks = [None, None]
dist.all_gather_object(ranks, rank)
tmp = Path(os.environ["POD_TMP"])
lock = FileLock.acquire(tmp / f"f{rank}.wav", tmp)
body = json.loads(lock.lock_path.read_text())
lock.release()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ranks": ranks, "body": body}))
"""


def test_two_processes_stamp_their_ranks_in_lock_bodies(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, BIRDA_COORDINATOR=f"127.0.0.1:{port}",
               BIRDA_NUM_PROCESSES="2", POD_TMP=str(tmp_path))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(env, BIRDA_PROCESS_ID=str(rank))) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["ranks"] == [0, 1] for o in outs)
    assert [o["body"]["process_index"] for o in outs] == [0, 1]
    assert all(o["body"]["pid"] == procs[i].pid for i, o in enumerate(outs))
