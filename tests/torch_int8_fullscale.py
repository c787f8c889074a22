"""Full-depth BirdNET v3.0 in int8 and mixed, in both packages: the graph,
inputs and runs of ``tests/test_torch_int8_fullscale.py``, and the JAX
package's fixture that ``chip_smoke.py`` reads.

The graph is ``BIRDNET_V30_SPEC`` with random weights from seed 1, as the
measuring tools and ``chip_smoke.py`` build it. The inputs are the JAX
int8 bench's (``scripts/bench_int8.py``): the built-in calibration set
``calibration_signals(sample_count)`` (4 batches of 8) and the 8 probe
rows ``calibration_signals(sample_count, batch=8, n_batches=1, seed=123)``.
Every run here is on the CPU, at an explicit compute dtype. A route is
``precision-compute`` (``fp32-fp32``, ``bf16-bf16``, ``int8-fp32``,
``mixed-bf16``, ...; ``int8-nosmooth-fp32`` is int8 with
``smooth_alpha=None``).

Run from the repository root (a full-depth graph is about 540 MB: point
``XDG_CACHE_HOME`` at a directory with room):

    JAX_PLATFORMS=cpu python3 tests/torch_int8_fullscale.py fixture
    JAX_PLATFORMS=cpu python3 tests/torch_int8_fullscale.py chunk

``fixture`` writes :data:`FIXTURE`, the JAX package's int8 and mixed
scores on the probe rows at compute fp32, and the same with one value
rounded the other way; ``chunk`` prints mixed's drift against fp32 in both
packages on ``chip_smoke.py``'s v3.0 chunk (:func:`chunk_drifts`).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from pathlib import Path

import numpy as np

SEED = 1
PROBE_SEED = 123
PROBE_ROWS = 8
#: The JAX package's int8 and mixed scores of the probe rows at compute
#: fp32, and the same with one value rounded the other way
#: (:func:`one_flip_jax`), ``[8, 11560]`` float32 each
#: (``np.savez_compressed``).
FIXTURE = Path(__file__).resolve().parent / "data" / "v30_int8_jax_scores.npz"
#: ``torch.quantile``'s limit, past which the port could not use it; its
#: percentile is a ``topk`` at every size. At calibration batch 8 no v3.0
#: tensor reaches it: the largest hold 8,192,000 elements.
TORCH_QUANTILE_LIMIT = 1 << 24
#: The calibration tensors whose percentile :func:`percentile_pairs` holds
#: against ``jnp.percentile``: those of more than 2^22 elements.
LARGE_ELEMS = 1 << 22


def spec():
    from birda_tpu_torch.onnx import fullscale

    return fullscale.BIRDNET_V30_SPEC


def graph():
    """The full-depth graph (built once per cache directory)."""
    from birda_tpu_torch.onnx import fullscale

    return fullscale.cached_build(spec(), seed=SEED)


def calibration_batches():
    from birda_tpu_torch.onnx import quantize as tq

    return list(tq.calibration_signals(spec().sample_count))


def probe_rows() -> np.ndarray:
    from birda_tpu_torch.onnx import quantize as tq

    return next(tq.calibration_signals(spec().sample_count,
                                       batch=PROBE_ROWS, n_batches=1,
                                       seed=PROBE_SEED))


def jax_calibration(model_bytes: bytes):
    """The JAX package's fp32 calibration on the built-in set, through its
    own cache (``cached_calibration``: the same batches, and a second run
    reads the file instead of spending a quarter of an hour)."""
    from birda_tpu.onnx import quantize as jq

    return jq.cached_calibration(model_bytes, spec().sample_count)[0]


def port_calibration(model_bytes: bytes, batches=None):
    """The port's fp32 calibration on the CPU, on the same batches."""
    from birda_tpu_torch.onnx import quantize as tq

    return tq.calibrate(model_bytes, batches or calibration_batches(),
                        device="cpu")


def as_port(calib):
    """A calibration (either package's) as the port reads it."""
    from birda_tpu_torch.onnx import quantize as tq

    return tq.CalibrationResult.from_json(calib.to_json())


def _route(route: str):
    parts = route.split("-")
    return parts[0], parts[-1], "nosmooth" in parts


@contextlib.contextmanager
def pallas_front_end():
    """``BIRDA_STFT_KERNEL=pallas`` for the span of a JAX lowering or run:
    bf16 compute fuses the front end onto the Pallas kernel (in interpret
    mode off the TPU), as the JAX package's own CPU tests run it; XLA's CPU
    backend has no bf16 x bf16 -> f32 dot for the unfused mel product."""
    was = os.environ.get("BIRDA_STFT_KERNEL")
    os.environ["BIRDA_STFT_KERNEL"] = "pallas"
    try:
        yield
    finally:
        if was is None:
            del os.environ["BIRDA_STFT_KERNEL"]
        else:
            os.environ["BIRDA_STFT_KERNEL"] = was


#: The deepest grouped int8 conv :func:`exact_grouped_int8_conv` takes:
#: its products (at most 127 · 127 each) summed over this many terms stay
#: below 2^24, so every partial sum is exact in float32.
EXACT_FP32_DEPTH = 1040


def _conv_fp32_exact(conv):
    """``conv`` (``lax.conv_general_dilated``) with a grouped int8 x int8
    -> int32 convolution of at most :data:`EXACT_FP32_DEPTH` terms per
    output evaluated as a float32 convolution, exact there, and converted
    back to int32: bit for bit the integer result."""
    import jax.numpy as jnp

    def exact(lhs, rhs, *args, feature_group_count=1,
              preferred_element_type=None, **kw):
        depth = int(np.prod(np.shape(rhs)[1:]))
        if (feature_group_count > 1 and preferred_element_type == jnp.int32
                and jnp.asarray(lhs).dtype == jnp.int8
                and jnp.asarray(rhs).dtype == jnp.int8
                and depth <= EXACT_FP32_DEPTH):
            out = conv(jnp.asarray(lhs, jnp.float32),
                       jnp.asarray(rhs, jnp.float32), *args,
                       feature_group_count=feature_group_count,
                       preferred_element_type=jnp.float32, **kw)
            return out.astype(jnp.int32)
        return conv(lhs, rhs, *args, feature_group_count=feature_group_count,
                    preferred_element_type=preferred_element_type, **kw)

    return exact


@contextlib.contextmanager
def exact_grouped_int8_conv():
    """XLA's CPU backend runs a grouped int8 convolution some 50 times
    slower than the float32 one (a depthwise 3x3 over ``[8, 384, 125,
    32]``: 20 s against 0.47 s on 8 cores), which puts a full-depth v3.0
    int8 run of the JAX package past two CPU hours. For the span of a JAX
    run (:func:`scores_jax`), ``lax.conv_general_dilated`` evaluates those
    convs exactly in float32 instead (:func:`_conv_fp32_exact`; the port's
    own depthwise route), so the integers are the same; nothing in the JAX
    package changes."""
    from jax import lax

    conv = lax.conv_general_dilated
    lax.conv_general_dilated = _conv_fp32_exact(conv)
    try:
        yield
    finally:
        lax.conv_general_dilated = conv


def lower_jax(model_bytes: bytes, calib, route: str):
    """The JAX package's function of ``route`` and its params (float params
    at bf16 where compute is bf16, as its zoo stores them)."""
    with pallas_front_end():
        return _lower_jax(model_bytes, calib, route)


def _lower_jax(model_bytes: bytes, calib, route: str):
    import jax.numpy as jnp
    from birda_tpu.onnx import lowering as jl
    from birda_tpu.onnx import quantize as jq

    precision, compute, nosmooth = _route(route)
    dtype = jnp.bfloat16 if compute == "bf16" else jnp.float32
    if precision in ("fp32", "bf16"):
        fn = jl.lower(model_bytes,
                      compute_dtype=None if compute == "fp32" else dtype)
    else:
        fn = jq.lower_int8(model_bytes, calib, compute_dtype=dtype,
                           boundary_store="storage" if precision == "mixed"
                           else "all",
                           smooth_alpha=None if nosmooth else 0.5)
    params = fn.params
    if compute == "bf16":
        params = {k: (np.asarray(v, jnp.bfloat16)
                      if np.asarray(v).dtype.kind == "f" else v)
                  for k, v in params.items()}
    return fn, params


def lower_port(model_bytes: bytes, calib, route: str):
    """The port's function of ``route`` and its params on the CPU."""
    import torch

    from birda_tpu_torch.models.zoo import params_from_numpy
    from birda_tpu_torch.onnx import lowering as tl
    from birda_tpu_torch.onnx import quantize as tq

    precision, compute, nosmooth = _route(route)
    dtype = torch.bfloat16 if compute == "bf16" else None
    if precision in ("fp32", "bf16"):
        fn = tl.lower(model_bytes, compute_dtype=dtype)
    else:
        fn = tq.lower_int8(model_bytes, as_port(calib), compute_dtype=dtype,
                           boundary_store="storage" if precision == "mixed"
                           else "all",
                           smooth_alpha=None if nosmooth else 0.5)
    return fn, params_from_numpy(fn.params, "cpu", dtype)


def scores_jax(fn, params, rows) -> np.ndarray:
    with pallas_front_end(), exact_grouped_int8_conv():
        return np.asarray(fn(rows, params=params)[0], np.float32)


def scores_port(fn, params, rows) -> np.ndarray:
    import torch

    with torch.inference_mode():
        out = fn(torch.from_numpy(rows), params=params)[0]
    return out.float().numpy()


def record_quantized_jax(fn, params, rows):
    """The JAX package's run of ``rows`` recording each activation its int8
    evaluator quantizes (name -> int8 array, the first time each is
    quantized): ``(scores, recorded)``."""
    ev, plain, seen = fn._eval, fn._eval._qact, {}

    def recording(x, name):
        q = plain(x, name)
        if name not in seen:
            seen[name] = np.asarray(q)
        return q

    ev._qact = recording
    try:
        return scores_jax(fn, params, rows), seen
    finally:
        del ev._qact


def forced_port(model_bytes: bytes, calib, route: str, rows, reference):
    """The port's ``route`` on ``rows`` with each quantized activation taken
    from ``reference`` (the JAX run's) where the two quantize apart, and
    the tie statistics of those (``chip_smoke.forced_quantized``)."""
    from chip_smoke import TIE_REL, forced_quantized

    fn, params = lower_port(model_bytes, calib, route)
    return forced_quantized(fn, lambda: scores_port(fn, params, rows),
                            reference, TIE_REL)


def one_flip_jax(fn, params, rows):
    """The JAX package's run of ``rows`` with one value rounded the other
    way: of the first activation its int8 evaluator quantizes, the element
    nearest a rounding boundary (the value any other float arithmetic
    could round apart). Returns ``(scores, (tensor, element, value))``."""
    import jax.numpy as jnp

    from chip_smoke import quantizer_scale

    ev, plain, flipped = fn._eval, fn._eval._qact, []

    def flip(x, name):
        q = plain(x, name)
        if flipped or np.asarray(x).dtype.kind != "f":
            return q
        y = np.asarray(x, np.float32) * quantizer_scale(ev, name, x.ndim)
        inside = np.abs(y) < 127.0
        dist = np.where(inside, np.abs(y - np.floor(y) - 0.5), np.inf)
        i = np.unravel_index(np.argmin(dist), y.shape)
        q = np.array(q)
        low = np.floor(y[i])
        q[i] = low + 1 if q[i] == low else low
        flipped.append((name, [int(v) for v in i], float(y[i])))
        return jnp.asarray(q)

    ev._qact = flip
    try:
        return scores_jax(fn, params, rows), flipped[0]
    finally:
        del ev._qact


def selection(fn) -> dict:
    """What ``lower_int8`` chose, as comparable values."""
    return {"quantized_nodes": list(fn.quantized_nodes),
            "skipped_nodes": dict(fn.skipped_nodes),
            "int8_boundary_tensors": list(fn.int8_boundary_tensors),
            "smoothed_tensors": list(fn.smoothed_tensors)}


def weight_bytes(fn) -> dict:
    """Each quantized weight's int8 bytes and scale bytes, and each
    smoothing vector's bytes."""
    ev = fn._eval
    out = {}
    for name, s in ev._wscale.items():
        w = fn.params.get(name, ev.const.get(name))
        out[f"w:{name}"] = np.asarray(w).tobytes()
        out[f"s:{name}"] = np.asarray(s).tobytes()
    for name, s in ev._asmooth.items():
        out[f"m:{name}"] = np.asarray(s).tobytes()
    return out


FIELDS = ("amax", "pctl", "amean")


def stat_differences(port, jax_) -> dict:
    """Largest relative difference of each statistic over the tensors both
    calibrations hold, with the tensor where it lies; ``chamax`` relative
    to each channel's value plus 1e-5 of the tensor's ``amax``."""
    out = {}
    for f in FIELDS + ("chamax",):
        worst, where = 0.0, None
        for name, want in jax_.stats.items():
            got = port.stats[name]
            if f == "chamax":
                a = np.asarray(got[f], np.float64)
                b = np.asarray(want[f], np.float64)
                d = float((np.abs(a - b)
                           / (np.abs(b) + 1e-5 * want["amax"])).max())
            else:
                d = abs(got[f] - want[f]) / max(abs(want[f]), 1e-30)
            if d > worst:
                worst, where = d, name
        out[f] = (worst, where)
    return out


def percentile_pairs(model_bytes: bytes, batch) -> list:
    """The port's calibration percentile of every tensor of one batch of
    more than :data:`LARGE_ELEMS` elements beside ``jnp.percentile`` of the
    same tensor, with the order statistics one rank below and one rank
    above the port's: ``[(elements, port, jnp, below, above)]``.
    ``jnp.percentile`` computes its rank in float32, which at millions of
    elements can land one rank away."""
    import jax.numpy as jnp
    import torch

    from birda_tpu_torch.onnx import quantize as tq

    pairs = []
    plain = tq._percentile

    def both(xa, q):
        got = plain(xa, q)
        n = xa.numel()
        if n > LARGE_ELEMS:
            want = float(jnp.percentile(jnp.asarray(xa.numpy()), q))
            lo = int(np.floor(q / 100.0 * (n - 1)))
            top = torch.topk(xa.reshape(-1), n - lo + 1, sorted=True).values
            pairs.append((n, float(got), want, float(top[-1]),
                          float(top[-3])))
        return got

    tq._percentile = both
    try:
        port_calibration(model_bytes, [batch])
    finally:
        tq._percentile = plain
    return pairs


def drift(got: np.ndarray, want: np.ndarray) -> dict:
    return {"max_abs": float(np.abs(got - want).max()),
            "top1": int((got.argmax(-1) == want.argmax(-1)).sum())}


def moved(rows: np.ndarray) -> np.ndarray:
    """``rows`` moved by one float32 step towards zero."""
    return np.nextafter(rows, np.float32(0))


def self_drift(model_bytes: bytes, calib, route: str, rows) -> dict:
    """The JAX package's ``route`` against itself on ``rows`` moved by one
    float32 step: how far its scores move when one value somewhere lands
    one quantization step apart."""
    fn, params = lower_jax(model_bytes, calib, route)
    return drift(scores_jax(fn, params, moved(rows)),
                 scores_jax(fn, params, rows))


def chunk_rows() -> np.ndarray:
    """The 32-row chunk ``chip_smoke.py`` holds v3.0's precisions on: 160 s
    of its ``recording()`` (chirps over white noise) at 32 kHz, through
    int16, cut into 5 s segments."""
    from chip_smoke import SEED, recording

    seg = spec().sample_count
    x = recording(32_000, 160.0, SEED + 51)
    pcm = (np.clip(x, -1.0, 1.0) * 32767).astype("<i2")  # write_wav's
    return (pcm[:32 * seg].astype(np.float32) / 32767.0).reshape(32, seg)


def chunk_drifts() -> dict:
    """mixed at fp32 compute against fp32, both packages, on
    :func:`chunk_rows`, lowered from the JAX calibration: whether the
    drift ``chip_smoke.py`` reads there is the method's. Beside it, the
    JAX package's mixed against itself on the rows moved by one float32
    step (``np.nextafter`` towards zero): how far one rounding step apart
    at a quantization boundary carries to the scores there."""
    mb = graph().model_bytes
    jcal = jax_calibration(mb)
    rows = chunk_rows()
    out = {}
    for pkg, lower, score in (("jax", lower_jax, scores_jax),
                              ("port", lower_port, scores_port)):
        got = {}
        for route in ("fp32-fp32", "mixed-fp32"):
            fn, params = lower(mb, jcal, route)
            got[route] = score(fn, params, rows)
            if pkg == "jax" and route == "mixed-fp32":
                got["mixed-fp32 moved"] = score(fn, params, moved(rows))
            del fn, params
        out[pkg] = got
    return {"mixed-fp32 vs fp32-fp32": {
                pkg: drift(g["mixed-fp32"], g["fp32-fp32"])
                for pkg, g in out.items()},
            "port vs jax": {r: drift(out["port"][r], out["jax"][r])
                            for r in ("fp32-fp32", "mixed-fp32")},
            "jax mixed-fp32 vs itself, rows one step moved": drift(
                out["jax"]["mixed-fp32 moved"], out["jax"]["mixed-fp32"])}


def write_fixture() -> None:
    """:data:`FIXTURE` from the JAX package: int8 and mixed at compute fp32
    on the probe rows, lowered from its own calibration."""
    mb = graph().model_bytes
    jcal = jax_calibration(mb)
    rows = probe_rows()
    out = {}
    for precision in ("int8", "mixed"):
        fn, p = lower_jax(mb, jcal, f"{precision}-fp32")
        out[precision] = scores_jax(fn, p, rows)
        out[f"{precision}_one_flip"] = one_flip_jax(fn, p, rows)[0]
        del fn, p
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **out)


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    if argv[:1] == ["fixture"]:
        write_fixture()
        return 0
    if argv[:1] == ["chunk"]:
        print(json.dumps(chunk_drifts(), indent=1))
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
