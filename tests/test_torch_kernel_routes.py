"""Which route a front-end node takes in the port's evaluator, and that
each route computes what the JAX evaluator computes.

The hand-written kernels hold a geometry wherever the signal span of at
least one frame fits a block's shared memory: a span of 128 frames, or of
fewer where a wide hop makes 128 too many (64 at hop 512/K 2048, hop
1024/K 1024 and hop 640/K 1280), and any mel width, in passes of at most
256 columns (``stft_conv.conv1d_kernel_fits``, ``logmel_kernel_fits``).
Past that (a window of about 73,000 samples) the Conv1d-STFT kernel
streams the span in pieces along the window wherever the JAX package's
VMEM budget holds. That covers every geometry whose VMEM budget holds for
the JAX package's Pallas kernels (``birda_tpu/ops/stft_conv.py``
``enabled``, ``fused_fits``), which take their kernels there. ``op_Conv``
and ``op_BirdaFusedMelFrontend`` ask the predicates before they dispatch,
from shapes alone, so that a CPU run takes the route the card would take
and counts it in ``stft_conv.ROUTES``. Where a kernel does not take the
geometry (a single window of 76,800 samples, past both budgets) the node
runs the JAX evaluator's composed route (``birda_tpu/onnx/lowering.py`` op_Conv's
gather form, op_BirdaFusedMelFrontend's fallback) with its dtypes. Bound:
bf16 output within 2e-2 of the largest magnitude of the JAX evaluator's
bf16 output, which takes its Pallas kernels in interpret mode; where its
VMEM budget fails too, of its fp32 output, since XLA on the CPU cannot run
the bf16 products of its composed route. Signals are cut to 20,000
samples where that holds a window: the routes do not depend on the signal
length once it does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birda_tpu.onnx import lowering as jl

from birda_tpu_torch.onnx import lowering as tl
from birda_tpu_torch.onnx.fuse import FUSED_OP
from birda_tpu_torch.ops import stft_conv
import torch_route_graphs as rg

S_CPU = 20_000
REL_BOUND = 2e-2


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    # The JAX evaluator fuses the front end and takes its Pallas kernels
    # (in interpret mode) only when asked to on a CPU.
    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the predicates ------------------------------------------------------------

@pytest.mark.parametrize("s,k,hop,c,fits", [
    (144_000, 2048, 278, 2050, True),    # v2.4's unfused DFT conv
    (160_000, 1024, 320, 1026, True),    # v3.0's
    (160_000, 640, 320, 640, True),      # Perch v2's framer
    (144_000, 2048, 512, 2050, True),    # librosa's default STFT
    (160_000, 1024, 1024, 1026, True),   # a non-overlapping framer
    (2_000, 2048, 278, 2050, False),     # a signal shorter than the window
    (160_000, 76_800, 76_800, 4, False),  # past shared memory and VMEM
    # Windows past shared memory where the JAX budget holds (C9): streamed.
    (160_000, 80_000, 10_000, 2, True),
    (160_000, 96_000, 320, 2, True),
    (160_000, 100_000, 12_500, 8, True),
    (160_000, 72_000, 320, 2, True),
    (160_000, 60_000, 18_438, 2, True),
])
def test_conv1d_kernel_fits(s, k, hop, c, fits):
    assert stft_conv.conv1d_kernel_fits(s, k, hop, c) is fits


@pytest.mark.parametrize("s,k,hop,c,m,fits", [
    (144_000, 2048, 278, 2050, 192, True),   # v2.4
    (160_000, 1024, 320, 1026, 128, True),   # v3.0
    (160_000, 640, 320, 642, 160, True),     # Perch v2's geometry
    (160_000, 1280, 640, 1282, 128, True),   # hop 640
    (160_000, 1024, 1024, 1026, 128, True),  # a non-overlapping framer
    (160_000, 1024, 320, 1026, 320, True),   # two 160-mel banks
    (160_000, 1024, 320, 1026, 256, True),   # the widest mel pass
    (1_000, 1024, 320, 1026, 128, False),    # shorter than the window
    (200_000, 90_000, 90_000, 8, 8, False),  # one window past shared memory
])
def test_logmel_kernel_fits(s, k, hop, c, m, fits):
    assert stft_conv.logmel_kernel_fits(s, k, hop, c, m) is fits


def test_predicates_are_the_wrappers_span_check():
    """A predicate says no on the span alone exactly where the wrapper's
    own check raises; where it says yes, the wrapper launches at the most
    frames per block that fit: 128 at the shipped geometries, 64 at the
    wide hops, 32 and 64 at the tiny test graphs' hops (8x the real one,
    rows of the window alone)."""
    for hop, k, conv, logmel in (
            (278, 2048, 128, 128), (320, 1024, 128, 128),
            (320, 640, 128, 128), (512, 2048, 64, 128),
            (1024, 1024, 64, 64), (640, 1280, 64, 64),
            (2224, 2048, 32, 32), (2560, 640, 64, 64),
            (76_800, 76_800, None, 1), (90_000, 90_000, None, None)):
        assert stft_conv.conv1d_frames(hop, k) == conv
        assert stft_conv.logmel_frames(hop, k) == logmel
        for name, frames in (("conv1d_stft", conv),
                             ("fused_logmel", logmel)):
            if frames is None:
                with pytest.raises(ValueError, match="shared memory"):
                    stft_conv._span_args(name, hop, k, frames)
            else:
                row, pad, got = stft_conv._span_args(name, hop, k, frames)
                k_pad = -(-k // 64) * 64
                assert (row, pad, got) == (min(hop, k_pad),
                                           stft_conv.span_pad(row), frames)


@pytest.mark.parametrize("s,k,hop,c,piece", [
    (160_000, 80_000, 10_000, 2, 448),
    (160_000, 100_000, 12_500, 8, 448),
    (160_000, 96_000, 320, 2, 22_080),
])
def test_streamed_layout_is_the_wrappers_span_check(s, k, hop, c, piece):
    """Past shared memory the Conv1d-STFT wrapper launches a block of 128
    frames whose span holds ``piece`` window samples at a time, in rows of
    ``min(hop, piece)``; where the JAX budget fails as well it refuses, as
    the predicate says no."""
    assert stft_conv.conv1d_frames(hop, k) is None
    assert stft_conv.conv1d_layout(s, k, hop, c) == (128, piece)
    assert stft_conv.span_smem_bytes(
        hop, piece, 2 * stft_conv.CONV_STAGING_BYTES, 128) \
        <= stft_conv.SMEM_LIMIT < stft_conv.span_smem_bytes(
            hop, piece + 64, 2 * stft_conv.CONV_STAGING_BYTES, 128)
    row, pad, frames = stft_conv._span_args("conv1d_stft", hop, k, 128,
                                            piece)
    assert (row, pad, frames) == (min(hop, piece), stft_conv.span_pad(row),
                                  128)
    assert stft_conv.conv1d_layout(160_000, 76_800, 76_800, 4) is None
    assert not stft_conv.pallas_budget(160_000, 76_800, 76_800, 4)


@pytest.mark.parametrize("divisors,enabled,whole_span_gaps", [
    pytest.param((1, 2, 4, 8, 16, 32, 64), 1491, 647, id="hop-k-over-2^n"),
    pytest.param(tuple(range(1, 65)), 19_290, 9970, id="hop-k-over-1-to-64"),
])
def test_conv1d_predicate_holds_wherever_the_jax_budget_holds_long_windows(
        monkeypatch, divisors, enabled, whole_span_gaps):
    """ROADMAP C9's grid: windows of 8,192 to 200,000 samples in steps of
    4,096, hops of the window over each divisor, 2, 8, 64 and 256
    channels, signals of 160,000, 320,000 and 1,000,000 samples holding a
    window. Wherever the JAX package takes its Pallas kernel, the port
    takes its CUDA kernel; the whole window's span alone misses
    ``whole_span_gaps`` of them, which the streamed span takes."""
    from birda_tpu.ops import stft_conv as jax_stft

    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    checked = missed = 0
    for s in (160_000, 320_000, 1_000_000):
        for k in range(8192, 200_001, 4096):
            if s < k:
                continue
            for hop in {k // d for d in divisors}:
                for c in (2, 8, 64, 256):
                    budget = stft_conv.pallas_budget(s, k, hop, c)
                    assert budget == jax_stft.enabled(
                        (1, s), (c, k), hop, jnp.bfloat16), (s, k, hop, c)
                    if budget:
                        checked += 1
                        missed += stft_conv.conv1d_frames(hop, k) is None
                        assert stft_conv.conv1d_kernel_fits(s, k, hop, c), \
                            (s, k, hop, c)
    assert (checked, missed) == (enabled, whole_span_gaps)


@pytest.mark.parametrize("hop,k,conv,logmel", [
    (278, 2048, 128, 128), (320, 1024, 128, 128), (320, 640, 128, 128),
    (512, 2048, 64, 128), (1024, 1024, 64, 64), (640, 1280, 64, 64),
    (2224, 2048, 32, 32), (2560, 640, 64, 64), (4096, 4096, 16, 16),
    (8192, 8192, 8, 8),
])
def test_shipped_and_wide_geometries_keep_their_frames_per_block(
        hop, k, conv, logmel):
    """The verify geometries (the release front ends and the wide ones)
    keep the whole window's span and their frames per block: the streamed
    span engages only past shared memory."""
    k_pad = -(-k // 64) * 64
    for s in (max(k, 144_000), 1_000_000):
        assert stft_conv.conv1d_layout(s, k, hop, 2 * (k // 2 + 1)) == (
            conv, k_pad)
    assert stft_conv.logmel_frames(hop, k) == logmel


def test_predicates_hold_wherever_the_jax_budget_holds(monkeypatch):
    """Over front-end geometries (windows of 256 to 8192 samples, hops
    from an eighth of the window to eight windows, DFT banks, framers and
    narrow convs, one to three mel banks), wherever the JAX package takes
    its Pallas kernel the port takes its CUDA kernel too."""
    from birda_tpu.ops import stft_conv as jax_stft

    monkeypatch.setenv("BIRDA_STFT_KERNEL", "pallas")
    checked = 0
    for s in (32_000, 144_000, 160_000, 320_000):
        for k in (256, 400, 512, 640, 1024, 1280, 2048, 4096, 8192):
            for hop in {k // 8, k // 4, k // 2, k * 4 // 5, k, 2 * k, 8 * k,
                        278, 320, 441, 512, 2560}:
                if s < k:
                    continue
                for c in (k, 2 * (k // 2 + 1), 64, 8):
                    if jax_stft.enabled((1, s), (c, k), hop, jnp.bfloat16):
                        checked += 1
                        assert stft_conv.conv1d_kernel_fits(s, k, hop, c), \
                            (s, k, hop, c)
                bins = k // 2 + 1
                for m in (64, 128, 192, 320, 512):
                    if jax_stft.fused_fits(s, k, hop, 2 * bins, m):
                        checked += 1
                        assert stft_conv.logmel_kernel_fits(
                            s, k, hop, 2 * bins, m), (s, k, hop, m)
    assert checked > 1000


# -- the routes through the evaluator, against the JAX evaluator ---------------

def _routes(case, fn, x):
    before = dict(stft_conv.ROUTES)
    out = fn(torch.from_numpy(x))
    took = {k: v - before.get(k, 0) for k, v in stft_conv.ROUTES.items()
            if v != before.get(k, 0)}
    return out, took


@pytest.mark.parametrize("name", [c.name for c in rg.CASES])
def test_route_and_bf16_output_match_jax(name):
    case = rg.BY_NAME[name]
    s = S_CPU if case.k < S_CPU else case.s
    mb = rg.build(case, s)
    x = rg.inputs(case, 2, s)
    fn = tl.lower(mb, compute_dtype=torch.bfloat16)
    fused = any(n.op_type == FUSED_OP for n in fn.graph.nodes)
    assert fused is (case.form == "frontend")
    before = stft_conv.LAUNCHES.copy()
    got, took = _routes(case, fn, x)
    assert stft_conv.LAUNCHES == before  # the CPU launches nothing
    assert took == {f"{case.kernel}:{case.route}": 1}
    assert got.dtype == torch.bfloat16

    if case.route == "kernel":
        jfn = jl.lower(mb, compute_dtype=jnp.bfloat16)
        want = np.asarray(jfn(x, params={
            k: np.asarray(v, jnp.bfloat16) for k, v in jfn.params.items()}),
            np.float32)
    else:
        jfn = jl.lower(mb)
        want = np.asarray(jfn(x), np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() <= REL_BOUND


#: One bf16 step at the output's largest magnitude: the two evaluators
#: round the same bf16 products, summed in fp32 in another order, and then
#: add the same bf16 bias in bf16.
C9_BOUND = 2.0 ** -7


@pytest.mark.parametrize("k,hop,c", [(80_000, 10_000, 2),
                                     (100_000, 12_500, 8)])
def test_long_window_bf16_conv_matches_the_jax_kernel_path(k, hop, c):
    """ROADMAP C9: a bf16 Conv1d-STFT with a bias whose window outgrows
    shared memory takes the kernel route (its plain version on the CPU),
    where the JAX evaluator takes its Pallas kernel (interpret mode) and
    adds the bias in bf16 after it, not the composed route's fp32 sums and
    fp32 bias."""
    s = 160_000
    case = rg.RouteCase("c9", "conv", s, k, hop, "kernel", channels=c)
    mb = rg.build(case)
    x = rg.inputs(case, 2)
    got, took = _routes(case, tl.lower(mb, compute_dtype=torch.bfloat16), x)
    assert took == {"conv1d_stft:kernel": 1}
    assert got.dtype == torch.bfloat16
    jfn = jl.lower(mb, compute_dtype=jnp.bfloat16)
    want = np.asarray(jfn(x, params={
        n: np.asarray(v, jnp.bfloat16) for n, v in jfn.params.items()}),
        np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape == (2, c, (s - k) // hop + 1)
    assert np.abs(got - want).max() <= C9_BOUND * np.abs(want).max()


@pytest.mark.parametrize("name", ["conv_hop512", "frontend_320_mels"])
def test_composed_route_keeps_the_jax_dtypes(name, monkeypatch):
    """Node by node, the composed route gives each tensor the JAX
    evaluator's dtype (bf16 out, not float32), and its output is the JAX
    evaluator's within the bound: the port's kernels are told they cannot
    hold the geometry here, so that its composed route runs on a conv and
    on a fused front end, while the JAX evaluator takes its Pallas kernels
    in interpret mode (XLA on the CPU cannot run the bf16 products of the
    JAX composed route)."""
    monkeypatch.setattr(stft_conv, "conv1d_kernel_fits", lambda *a: False)
    monkeypatch.setattr(stft_conv, "logmel_kernel_fits", lambda *a: False)
    case = rg.BY_NAME[name]
    mb = rg.build(case, S_CPU)
    x = rg.inputs(case, 1, S_CPU)

    class Port(tl._Evaluator):
        dtypes = {}

        def _store(self, n, v):
            self.dtypes[n] = str(getattr(v, "dtype", "")).removeprefix(
                "torch.")
            return v

    class Jax(jl._Evaluator):
        dtypes = {}

        def _store(self, n, v):
            self.dtypes[n] = str(getattr(v, "dtype", ""))
            return v

    from birda_tpu.onnx import proto as jp

    from birda_tpu_torch.onnx import proto as tp

    tm, jm = tp.load_model(mb), jp.load_model(mb)
    assert tl.maybe_fuse_frontend(tm, torch.bfloat16) is not None
    jl.maybe_fuse_frontend(jm, jnp.bfloat16)
    routes = dict(stft_conv.ROUTES)
    got = tl.OnnxFunction(tm, evaluator=Port(tm.graph, torch.bfloat16,
                                             tm.opset))(torch.from_numpy(x))
    assert {k: v - routes.get(k, 0) for k, v in stft_conv.ROUTES.items()
            if v != routes.get(k, 0)} == {f"{case.kernel}:composed": 1}
    want = jl.OnnxFunction(jm, evaluator=Jax(jm.graph, jnp.bfloat16,
                                             jm.opset))(x)
    out = "y" if case.form == "conv" else "logmel"
    assert Port.dtypes[out] == Jax.dtypes[out] == "bfloat16"
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= REL_BOUND


def test_fp32_conv_takes_no_route():
    """The routes are the bf16 kernels' question: an fp32 Conv1d-STFT runs
    its gather form and counts nothing."""
    case = rg.BY_NAME["conv_hop512"]
    fn = tl.lower(rg.build(case, S_CPU))
    _, took = _routes(case, fn, rg.inputs(case, 1, S_CPU))
    assert took == {}


def test_verify_script_cases_on_the_cpu():
    """``scripts/verify_kernels_cuda.py``'s cases at a cut signal on the
    CPU, where each wrapper takes its plain version: the kernel case holds
    both bounds, every route case takes its route and matches."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "verify_kernels_cuda", Path(__file__).resolve().parent.parent
        / "scripts" / "verify_kernels_cuda.py")
    verify = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(verify)
    cpu = torch.device("cpu")
    for name, _, k, hop, mels in verify.STFT_CASES[:1] + verify.WIDE_CASES[:4]:
        rec = verify.stft_case(name, S_CPU, k, hop, mels, 2, cpu)
        assert rec["ok"] and rec["launches"] == {"conv1d_stft": 0,
                                                 "fused_logmel": 0}, rec
        assert rec["conv_max_abs_err_vs_plain"] == 0
    for name, s, k, hop, c in verify.C9_CASES:
        rec = verify.conv_case(name, s, k, hop, c, 2, cpu)
        assert rec["ok"] and rec["launches"] == 0, rec
        assert rec["frames_per_block"] == 128
        assert rec["span_window_samples"] == 448
        assert rec["conv_max_abs_err_vs_plain"] == 0
    for case in rg.CASES:
        s = S_CPU if case.k < S_CPU else case.s
        rec = verify.route_case(case, 2, cpu, s=s)
        assert rec["ok"] and rec["route"] == case.route, rec
