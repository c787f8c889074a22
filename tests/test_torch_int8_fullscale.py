"""Full-depth BirdNET v3.0 in int8 and mixed: the port against the JAX
package, stage by stage, on the CPU (``tests/torch_int8_fullscale.py``
holds the graph, inputs and runs). Slow: a quarter of an hour on an
8-core CPU once the JAX calibration (about 24 minutes) is cached under
``$XDG_CACHE_HOME/birda/int8_calib``; the 540 MB graph is cached under
``$XDG_CACHE_HOME/birda/fixtures``.

1. Calibration statistics, fp32, both packages on the same batches: the
   same tensors, ``ndim`` and ``aelems``; ``amax`` within rtol 1e-5,
   ``pctl`` and ``amean`` within 2e-4 (sums over up to 8.2 M elements in
   another order; jnp's float32 rank), ``chamax`` within 1e-4 of each
   channel plus 1e-5 of the tensor's ``amax`` (the cached format keeps 6
   digits). On the largest tensors of a batch (8,192,000 elements, under
   the 2^24 of ``torch.quantile``), the port's percentile and
   ``jnp.percentile`` lie within one rank of each other (jnp computes the
   rank in float32).
2. Fed the JAX calibration, the same selection (quantized and skipped
   nodes with reasons, boundary and smoothed tensors) and byte-equal int8
   weights, weight scales and smoothing vectors, for int8 and mixed at
   both compute dtypes and int8 without smoothing.
3. Scores of the 8 probe rows. At fp32 compute each value the packages
   quantize apart must be a rounding tie one step apart (within
   ``chip_smoke.TIE_REL`` of its magnitude from ``k + 0.5``); with the
   values quantized apart taken from the JAX run, int8 and mixed hold
   5e-3 at fp32 compute and 2e-2 at bf16 (``test_scores_match_jax``'s
   bounds), with the same argmax at fp32 (at bf16 the JAX package's own
   argmax moves on a probe row under a one-step move of its input, which
   is printed beside). Left alone, one tie rounded apart carries
   to the scores at this depth, in the JAX package too (its move for one
   flipped value is printed), so those scores are printed beside. The
   JAX package's int8 and mixed at fp32, and their one-flip scores, are
   the committed fixture (within 1e-6), and the port's own CPU
   calibration selects as the JAX one does, as ``chip_smoke.py`` lowers it
   on the card.
4. Each package's int8 and mixed against its own fp32 and bf16: recorded
   (printed), not held to 5e-2.
"""

import json

import numpy as np
import pytest

import torch_int8_fullscale as F

pytestmark = pytest.mark.slow

QUANTIZED = ("int8-fp32", "mixed-fp32", "int8-bf16", "mixed-bf16",
             "int8-nosmooth-fp32")
SCORE_BOUNDS = {"fp32": 5e-3, "bf16": 2e-2}
FIXTURE_BOUND = 1e-6


@pytest.fixture(scope="module")
def model_bytes():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return F.graph().model_bytes


@pytest.fixture(scope="module")
def jcal(model_bytes):
    return F.jax_calibration(model_bytes)


@pytest.fixture(scope="module")
def tcal(model_bytes):
    return F.port_calibration(model_bytes)


@pytest.fixture(scope="module")
def runs(model_bytes, jcal):
    """``runs(pkg, route)``: the route's selection, weight bytes and
    probe-row scores, lowered once from the JAX calibration."""
    rows = F.probe_rows()
    memo = {}

    def run(pkg, route):
        if (pkg, route) not in memo:
            lower, score = ((F.lower_jax, F.scores_jax) if pkg == "jax"
                            else (F.lower_port, F.scores_port))
            fn, params = lower(model_bytes, jcal, route)
            quantized = hasattr(fn, "quantized_nodes")
            memo[pkg, route] = {
                "selection": F.selection(fn) if quantized else None,
                "bytes": F.weight_bytes(fn) if quantized else None,
                "scores": score(fn, params, rows)}
            del fn, params
        return memo[pkg, route]

    return run


def test_stage1_calibration_statistics(jcal, tcal):
    assert tcal.stats.keys() == jcal.stats.keys()
    assert len(tcal.stats) >= 900
    for name, want in jcal.stats.items():
        got = tcal.stats[name]
        assert (got["ndim"], got["aelems"]) == (want["ndim"], want["aelems"])
        for f, rtol in (("amax", 1e-5), ("pctl", 2e-4), ("amean", 2e-4)):
            assert got[f] == pytest.approx(want[f], rel=rtol), (name, f)
        np.testing.assert_allclose(got["chamax"], want["chamax"], rtol=1e-4,
                                   atol=1e-5 * want["amax"], err_msg=name)
    print(json.dumps({"stage1_max_rel": F.stat_differences(tcal, jcal)}))


def test_stage1_percentile_of_the_largest_tensors_is_jnp_percentile(
        model_bytes):
    pairs = F.percentile_pairs(model_bytes, F.calibration_batches()[0])
    assert len(pairs) >= 10
    for n, got, want, below, above in pairs:
        assert F.LARGE_ELEMS < n < F.TORCH_QUANTILE_LIMIT
        # jnp's float32 rank: within one rank of the port's
        assert below <= want <= above, n
        assert below <= got <= above, n
    print(json.dumps({"large_tensors": len(pairs),
                      "largest": max(p[0] for p in pairs),
                      "max_rel": max(abs(p[1] - p[2]) / p[2]
                                     for p in pairs)}))


@pytest.mark.parametrize("route", QUANTIZED)
def test_stage2_selection_and_weights(runs, route):
    want, got = runs("jax", route), runs("port", route)
    assert got["selection"] == want["selection"]
    assert got["bytes"].keys() == want["bytes"].keys()
    for name, b in want["bytes"].items():
        assert got["bytes"][name] == b, name
    sel = got["selection"]
    if route.startswith("mixed"):
        assert not sel["quantized_nodes"] and sel["int8_boundary_tensors"]
    else:
        assert len(sel["quantized_nodes"]) >= 300
        assert bool(sel["smoothed_tensors"]) == ("nosmooth" not in route)
    print(json.dumps({route: {k: len(v) for k, v in sel.items()}}))


@pytest.fixture(scope="module")
def forced(model_bytes, jcal):
    """``forced(route)``: the port's scores with each activation its int8
    evaluator quantizes taken from the JAX run's where the two quantize
    apart, the JAX scores, and the tie statistics of those values."""
    rows = F.probe_rows()
    memo = {}

    def run(route):
        if route not in memo:
            fn, params = F.lower_jax(model_bytes, jcal, route)
            want, recorded = F.record_quantized_jax(fn, params, rows)
            del fn, params
            got, stats = F.forced_port(model_bytes, jcal, route, rows,
                                       recorded)
            memo[route] = (got, want, stats)
        return memo[route]

    return run


@pytest.mark.parametrize("route", QUANTIZED)
def test_stage3_scores(model_bytes, jcal, runs, forced, route):
    """With every value the packages quantize apart taken from the JAX run,
    the scores hold the bound. At fp32 compute each such value is a
    rounding tie one step apart and the argmax is the same. At bf16
    compute the two packages' bf16 arithmetic moves values further than a
    tie, and the JAX package's own argmax moves on a probe row when its
    input moves by one float32 step, which is printed beside. The scores
    of the runs left alone are printed: one tie rounded apart carries far
    at this depth (the JAX package's own move for one:
    ``test_stage3_fixture_is_the_jax_package``)."""
    from chip_smoke import ties_only

    got, want, stats = forced(route)
    assert got.shape == want.shape == (F.PROBE_ROWS, 11_560)
    err = float(np.abs(got - want).max())
    out = {"forced": F.drift(got, want), "quantized_apart": stats,
           "left_alone": F.drift(runs("port", route)["scores"],
                                 runs("jax", route)["scores"])}
    fp32 = route.endswith("fp32")
    if not fp32:
        out["jax_vs_itself_one_step_moved"] = F.self_drift(
            model_bytes, jcal, route, F.probe_rows())
    print(json.dumps({route: out}))
    assert stats["tensors"] >= 200
    assert err <= SCORE_BOUNDS[route.split("-")[-1]]
    if fp32:
        assert ties_only(stats), stats
        assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_stage3_fixture_is_the_jax_package(model_bytes, jcal, runs):
    """The committed fixture is the JAX package's int8 and mixed at fp32
    on the probe rows, and its one-flip scores (one value, the nearest a
    rounding boundary, rounded the other way) are its own too; how far
    that one flip moves the reference is printed."""
    fixture = np.load(F.FIXTURE)
    rows = F.probe_rows()
    out = {}
    for precision in ("int8", "mixed"):
        want = runs("jax", f"{precision}-fp32")["scores"]
        fn, params = F.lower_jax(model_bytes, jcal, f"{precision}-fp32")
        flipped, where = F.one_flip_jax(fn, params, rows)
        del fn, params
        for key, scores in ((precision, want),
                            (f"{precision}_one_flip", flipped)):
            assert fixture[key].dtype == np.float32
            np.testing.assert_allclose(fixture[key], scores, rtol=0,
                                       atol=FIXTURE_BOUND)
        out[precision] = {"one_flip": where,
                          "moves_scores": F.drift(flipped, want)}
    print(json.dumps({"fixture": F.FIXTURE.stat().st_size, **out}))


def test_stage3_own_calibration_selects_as_the_jax_calibration(model_bytes,
                                                               jcal, tcal):
    """What ``chip_smoke.py`` lowers on the card from the port's own CPU
    calibration: the selection the JAX calibration gives, with activation
    scales within the calibrations' ``amax`` agreement (1e-5)."""
    for route in ("int8-fp32", "mixed-fp32"):
        own, _ = F.lower_port(model_bytes, tcal, route)
        ref, _ = F.lower_port(model_bytes, jcal, route)
        assert F.selection(own) == F.selection(ref)
        assert own._eval._ascale.keys() == ref._eval._ascale.keys()
        for name, s in ref._eval._ascale.items():
            assert own._eval._ascale[name] == pytest.approx(s, rel=1e-5)
        del own, ref


def test_stage4_each_package_against_its_own_float_routes(runs):
    """C12's numbers: recorded, not held to the 5e-2 drift bound."""
    out = {}
    for pkg in ("jax", "port"):
        ref = {r: runs(pkg, r)["scores"] for r in ("fp32-fp32", "bf16-bf16")}
        for route in QUANTIZED:
            s = runs(pkg, route)["scores"]
            assert np.isfinite(s).all()
            for r, want in ref.items():
                out[f"{pkg} {route} vs {r}"] = F.drift(s, want)
    fp32 = {pkg: runs(pkg, "fp32-fp32")["scores"] for pkg in ("jax", "port")}
    out["fp32 port vs jax"] = F.drift(fp32["port"], fp32["jax"])
    print(json.dumps(out, indent=1))
    assert out["fp32 port vs jax"]["max_abs"] <= 1e-4
