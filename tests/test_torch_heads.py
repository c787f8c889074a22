"""The secondary heads of the PyTorch port against the JAX package, on the
CPU: the geomodel range filter (RangeFilter and through analyze, under the
keep, drop and rerank policies), the bat two-stage head (CustomClassifier
and through analyze at 256 kHz), regional slicing (match_labels,
slice_to_region and through analyze) and the species list (api.species and
the species command's file).

Inputs are made from seeds with numpy: tiny BirdNET v2.4 and tiny Perch v2
from ``onnx/fullscale.tiny_spec`` (the real 6,522 and 14,795 classes and the
real 1,024-d v2.4 embedding), the fixture geomodel (a Gemm + Sigmoid with
the real [B,3] -> N contract, at the real 12,012 species where stated), and
Gemm + Sigmoid bat heads [B,1024] -> 38. Each test states its bound.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import fixtures_onnx as fo
from fixtures_audio import write_wav

from birda_tpu.onnx import fullscale as fs

from birda_tpu_torch.models.zoo import synthetic_labels

#: The pipeline tests' bound on a detection's confidence (fp32 rounding).
CONF_BOUND = 1e-4
#: Scores of a small head or the geomodel (one product and a sigmoid).
SCORE_BOUND = 1e-6
GEO_SPECIES = 12_012
#: (lat, lon, week) where the fixture geomodel's scores spread over (0, 1)
#: rather than saturate (its weights are N(0, 0.8) per degree).
QUERY = (0.5, -1.2, 2)
BAT_CLASSES = 38


@pytest.fixture()
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    monkeypatch.setenv("BIRDA_NO_COMPILE_CACHE", "1")
    return tmp_path


def _chirps(path: Path, rate: int, secs: float, seed: int) -> Path:
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * secs)) / rate
    x = 0.3 * np.sin(2 * np.pi * (2500 + 300 * t) * t) \
        + rng.normal(0, 0.05, t.shape)
    write_wav(path, x.astype(np.float32), rate)
    return path


@pytest.fixture()
def v24(home):
    g = fs.cached_build(fs.tiny_spec(fs.BIRDNET_V24_SPEC), seed=1)
    model = home / "birdnet-v24-tiny.onnx"
    model.write_bytes(g.model_bytes)
    labels = synthetic_labels(g.spec.num_classes)
    labels_path = home / "labels.txt"
    labels_path.write_text("\n".join(labels) + "\n")
    kw = dict(model_path=model, labels_path=labels_path,
              model_type="birdnet-v24", min_confidence=0.05, device="cpu")
    return kw, labels


@pytest.fixture()
def perch(home):
    g = fs.cached_build(fs.tiny_spec(fs.PERCH_V2_SPEC), seed=1)
    model = home / "perch-v2-tiny.onnx"
    model.write_bytes(g.model_bytes)
    labels = synthetic_labels(g.spec.num_classes)
    labels_path = home / "perch-labels.txt"
    labels_path.write_text("\n".join(labels) + "\n")
    kw = dict(model_path=model, labels_path=labels_path,
              model_type="perch-v2", min_confidence=1e-6, top_k=5,
              device="cpu")
    return kw, labels


def _rows(result):
    return {f.path.name: [(d.start_time, d.end_time, d.scientific_name,
                           d.common_name, d.confidence)
                          for d in f.detections]
            for f in result.files}


def _assert_same_detections(got, want, bound=CONF_BOUND):
    assert got.keys() == want.keys()
    for name in want:
        assert want[name], f"no detections for {name}"
        assert [r[:4] for r in got[name]] == [r[:4] for r in want[name]]
        for a, b in zip(got[name], want[name]):
            assert abs(a[4] - b[4]) <= bound


def _geomodel(home: Path, labels: list[str], n: int, own: int | None = None,
              seed: int = 42):
    """The fixture geomodel at ``n`` species: the classifier's first
    ``own`` labels (default ``n // 2``) and others that it does not know."""
    path = home / f"geo-{n}.onnx"
    path.write_bytes(fo.make_fixture_geomodel(num_species=n, seed=seed))
    own = labels[:n // 2 if own is None else own]
    other = [f"Geo only{i:05d}_Geo bird {i:05d}" for i in range(n - len(own))]
    labels_path = home / f"geo-{n}-labels.txt"
    labels_path.write_text("".join(f"{lab}\n" for lab in own + other))
    return path, labels_path, own + other


def _config(pkg: str, geo=None, geo_labels=None):
    import importlib

    cfg = importlib.import_module(f"{pkg}.config.types").Config()
    cfg.defaults.geomodel = geo
    cfg.defaults.geomodel_labels = geo_labels
    return cfg


# -- the geomodel range filter ---------------------------------------------------

def test_range_filter_predict_week_matches_jax(home):
    """At the real 12,012 species: the same species at threshold 0.03 and
    scores within SCORE_BOUND, by week and by month and day."""
    from birda_tpu.inference.range_filter import RangeFilter as JaxRangeFilter

    from birda_tpu_torch.inference.range_filter import RangeFilter

    geo, _, labels = _geomodel(home, synthetic_labels(8000), GEO_SPECIES)
    want = JaxRangeFilter.from_onnx(geo, labels, threshold=0.03)
    got = RangeFilter.from_onnx(geo, labels, threshold=0.03, device="cpu")
    assert got.device == torch.device("cpu")
    for w, g in ((want.predict_week(*QUERY), got.predict_week(*QUERY)),
                 (want.predict(-1.3, 0.7, 1, 14),
                  got.predict(-1.3, 0.7, 1, 14))):
        assert 0 < len(w) < GEO_SPECIES
        assert [(s.species, s.index) for s in g] == \
            [(s.species, s.index) for s in w]
        assert max(abs(a.score - b.score) for a, b in zip(g, w)) \
            <= SCORE_BOUND


def test_range_filter_label_count_and_device(home):
    from birda_tpu_torch.errors import GeomodelLabelCount, RuntimeInitialization
    from birda_tpu_torch.inference.range_filter import RangeFilter, query_device

    geo, _, labels = _geomodel(home, synthetic_labels(100), 64)
    with pytest.raises(GeomodelLabelCount):
        RangeFilter.from_onnx(geo, labels[:-1], device="cpu")
    with query_device("cpu"):
        assert RangeFilter.from_onnx(geo, labels).device.type == "cpu"
    if not torch.cuda.is_available():
        # Without a device the default is the card, which is missing.
        with pytest.raises(RuntimeInitialization):
            RangeFilter.from_onnx(geo, labels)


@pytest.mark.parametrize("policy", ["keep", "drop", "rerank"])
def test_range_filter_through_analyze_matches_jax(v24, home, policy):
    """Tiny v2.4 at 48 kHz with lat/lon/week and the fixture geomodel at
    12,012 species (the classifier's first 5,000 labels and 7,012 others,
    so that one of the tiny graph's detected species is unmatched):
    detections equal the JAX run's, confidences within CONF_BOUND; every
    detection kept under ``drop`` is a species the geomodel maps."""
    import birda_tpu.api as jax_api

    import birda_tpu_torch.api as torch_api

    kw, labels = v24
    geo, geo_labels, _ = _geomodel(home, labels, GEO_SPECIES, own=5000)
    wav = _chirps(home / "rec.wav", 48_000, 9.0, 0)
    run = dict(kw, lat=QUERY[0], lon=QUERY[1], week=QUERY[2],
               range_threshold=0.03,
               range_unmatched="keep" if policy == "keep" else "drop",
               rerank=policy == "rerank")
    want = jax_api.analyze([wav], **run,
                           config=_config("birda_tpu", geo, geo_labels))
    got = torch_api.analyze([wav], **run,
                            config=_config("birda_tpu_torch", geo,
                                           geo_labels))
    assert got.exit_code == want.exit_code == 0
    _assert_same_detections(_rows(got), _rows(want))
    assert got.range_filter["mapped_species"] == 5000
    if policy == "drop":
        mapped = {lab.split("_")[0] for lab in labels[:5000]}
        assert all(d.scientific_name in mapped for d in got.detections)


def test_range_filter_info_and_unavailable_geomodel(v24, home, caplog):
    """pipeline_started carries the geomodel coverage record; a configured
    geomodel that does not exist degrades to an unfiltered run with a
    warning, as in the JAX package."""
    import logging

    import birda_tpu_torch.api as torch_api
    from birda_tpu_torch.config.types import Config
    from birda_tpu_torch.orchestrator import AnalyzeOptions, analyze_files

    kw, labels = v24
    geo, geo_labels, _ = _geomodel(home, labels, 200)
    wav = _chirps(home / "rec.wav", 48_000, 4.0, 1)
    seen = {}

    class Reporter(torch_api._Collector):
        def pipeline_started(self, *a, **k):
            seen["range_filter"] = a[4]

    cfg = _config("birda_tpu_torch", geo, geo_labels)
    opts = AnalyzeOptions(
        inputs=[wav], model_path=kw["model_path"],
        labels_path=kw["labels_path"],
        model_type=__import__("birda_tpu_torch.config.types",
                              fromlist=["ModelType"]).ModelType("birdnet-v24"),
        device_flags={"cpu": True}, lat=60.2, lon=24.9, week=20,
        stream_detections=True, force=True)
    assert analyze_files(opts, cfg, Reporter()) == 0
    info = seen["range_filter"]
    assert info["geomodel_version"] == "3.0.2"
    assert info["total_species"] == len(labels)
    assert info["mapped_species"] == 100
    assert info["unmatched_policy"] == "keep"

    missing = Config()
    missing.defaults.geomodel = home / "absent.onnx"
    missing.defaults.geomodel_labels = home / "absent.txt"
    with caplog.at_level(logging.WARNING):
        assert analyze_files(opts, missing, Reporter()) == 0
    assert seen["range_filter"] is None
    assert any("Range filtering disabled" in r.message
               for r in caplog.records)


# -- the bat two-stage head ---------------------------------------------------

def _bat_head(home: Path, classes: int = BAT_CLASSES, seed: int = 0):
    """A Gemm + Sigmoid head [B,1024] -> ``classes`` under
    ``models_dir()/bat`` as BattyBirdNET-UK (``XDG_DATA_HOME``)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, (1024, classes)).astype(np.float32)
    b = rng.normal(0, 0.5, classes).astype(np.float32)
    head = fo.model(
        [fo.node("Gemm", ["input", "W", "B"], ["logits"]),
         fo.node("Sigmoid", ["logits"], ["probabilities"])],
        inputs=[fo.value_info("input", ["batch", 1024])],
        outputs=[fo.value_info("probabilities", ["batch", classes])],
        initializers=[fo.tensor("W", w), fo.tensor("B", b)])
    bat_dir = home / "data" / "birda" / "models" / "bat"
    bat_dir.mkdir(parents=True, exist_ok=True)
    onnx = bat_dir / "BattyBirdNET-UK-256kHz_fp32.onnx"
    onnx.write_bytes(head)
    labels = bat_dir / "BattyBirdNET-UK-256kHz_Labels.txt"
    labels.write_text("".join(f"Bat sp{i:02d} x_Bat {i}\n"
                              for i in range(classes)))
    return onnx, labels, w, b


def test_custom_classifier_matches_jax(home):
    """predict_batch and reclassify: the same labels in the same order,
    values within SCORE_BOUND; results without embeddings pass through."""
    from birda_tpu.inference.classifier import PredictionResult as JaxResult
    from birda_tpu.models.custom import CustomClassifier as JaxCustom

    from birda_tpu_torch.inference.classifier import PredictionResult
    from birda_tpu_torch.models.custom import CustomClassifier

    onnx, labels, w, b = _bat_head(home)
    emb = np.random.default_rng(3).normal(0, 1, (8, 1024)).astype(np.float32)
    want = JaxCustom.from_onnx(onnx, labels, min_confidence=0.3, top_k=5)
    got = CustomClassifier.from_onnx(onnx, labels, min_confidence=0.3,
                                     top_k=5, device="cpu")
    gp, wp = got.predict_batch(emb), want.predict_batch(emb)
    assert sum(map(len, wp)) > 0
    assert [[(p.species, p.index) for p in r] for r in gp] == \
        [[(p.species, p.index) for p in r] for r in wp]
    assert max(abs(a.confidence - c.confidence)
               for r, s in zip(gp, wp) for a, c in zip(r, s)) <= SCORE_BOUND
    # The head is the plain product: float64 on the host agrees.
    ref = 1 / (1 + np.exp(-(emb.astype(np.float64) @ w + b)))
    assert np.abs(got.scores(emb).numpy() - ref).max() <= SCORE_BOUND

    results = [PredictionResult([], e) for e in emb[:3]]
    jresults = [JaxResult([], e) for e in emb[:3]]
    got.reclassify(results)
    want.reclassify(jresults)
    assert [[p.species for p in r.predictions] for r in results] == \
        [[p.species for p in r.predictions] for r in jresults]
    untouched = [PredictionResult(["x"], None)]
    assert got.reclassify(untouched)[0].predictions == ["x"]


def test_bat_two_stage_through_analyze_matches_jax(v24, home):
    """Tiny v2.4 in bat mode over 4 s at 256 kHz (no resample, 144,000
    samples a window): every detection is a head label, starts step by
    0.5625 · 0.75 s, and the detections equal the JAX run's within
    CONF_BOUND."""
    import birda_tpu.api as jax_api

    import birda_tpu_torch.api as torch_api

    kw, _ = v24
    _bat_head(home)
    wav = _chirps(home / "bat.wav", 256_000, 4.0, 2)
    run = dict(kw, bat="uk", min_confidence=0.3)
    want = jax_api.analyze([wav], **run)
    got = torch_api.analyze([wav], **run)
    assert got.exit_code == want.exit_code == 0
    _assert_same_detections(_rows(got), _rows(want))
    assert all(d.scientific_name.startswith("Bat sp")
               for d in got.detections)
    # Windows step by 0.5625 · 0.75 s; the last one ends at the file's end.
    starts = sorted({d.start_time for d in got.detections})
    step = 0.5625 * 0.75
    assert starts[0] == 0.0 and len(starts) > 3
    assert np.allclose(np.diff(starts[:-1]), step)
    assert 0 < starts[-1] - starts[-2] <= step


def test_bat_region_is_validated(v24, home):
    import birda_tpu_torch.api as torch_api
    from birda_tpu_torch.errors import ConfigValidation, ModelFileNotFound

    kw, _ = v24
    wav = _chirps(home / "bat.wav", 256_000, 1.0, 2)
    with pytest.raises(ConfigValidation, match="unknown bat region"):
        torch_api.analyze([wav], **kw, bat="mars")
    with pytest.raises(ModelFileNotFound):  # no head installed
        torch_api.analyze([wav], **kw, bat="eu")


# -- regional slicing ------------------------------------------------------------

def test_match_labels_matches_jax():
    from birda_tpu.errors import ClassifierBuild as JaxBuild
    from birda_tpu.models.regional import match_labels as jax_match

    from birda_tpu_torch.errors import ClassifierBuild
    from birda_tpu_torch.models.regional import match_labels

    full = synthetic_labels(50)
    region = [full[7], full[3], "Species sp00011_Espèce commune",
              full[49]]  # the third by scientific name alone
    got = match_labels(full, region)
    assert got.dtype == np.int32
    assert np.array_equal(got, jax_match(full, region))
    assert got.tolist() == [7, 3, 11, 49]
    for fn, err in ((match_labels, ClassifierBuild), (jax_match, JaxBuild)):
        with pytest.raises(err, match="1 regional labels not present"):
            fn(full, region + ["Nowhere bird_Nowhere"])


def _stub(pkg: str, family: str, labels, out: dict):
    """A LoadedModel of ``pkg`` whose apply returns ``out`` (numpy) as that
    package's arrays: the same scores through both packages' slices."""
    import importlib

    contracts = importlib.import_module(f"{pkg}.models.contracts")
    zoo = importlib.import_module(f"{pkg}.models.zoo")
    if pkg == "birda_tpu":
        import jax.numpy as jnp

        conv = jnp.asarray
    else:
        conv = torch.from_numpy
    return zoo.LoadedModel(
        config=contracts.contract_for(family), labels=labels,
        apply=lambda x: {k: conv(v) for k, v in out.items()})


@pytest.mark.parametrize("family", ["birdnet-v24", "perch-v2"])
def test_slice_to_region_matches_jax(v24, perch, family):
    """Every 8th label kept, over the scores the port's tiny graph gives
    for two segments: a sigmoid slice (v2.4) is bit-equal to the JAX
    slice; a softmax slice (Perch) is within SCORE_BOUND of it and its rows
    sum to 1 within SCORE_BOUND; embeddings and labels pass through; the
    view carries no precision report, as the JAX package's."""
    from birda_tpu.models.regional import slice_to_region as jax_slice

    from birda_tpu_torch.models import contracts
    from birda_tpu_torch.models.regional import slice_to_region
    from birda_tpu_torch.models.zoo import onnx_model

    kw, labels = v24 if family == "birdnet-v24" else perch
    contract = contracts.contract_for(family)
    model = onnx_model(kw["model_path"], contract, labels)
    x = np.random.default_rng(5).normal(0, 0.1, (2, contract.sample_count))
    with torch.inference_mode():
        out = {k: v.numpy() for k, v in model.apply(
            torch.from_numpy(x.astype(np.float32))).items()}
    region = labels[::8]
    got = slice_to_region(_stub("birda_tpu_torch", family, labels, out),
                          region, region="r")
    want = jax_slice(_stub("birda_tpu", family, labels, out), region,
                     region="r")
    assert got.labels == want.labels == region
    assert got.num_classes == want.num_classes == len(region)
    assert got.precision_info is None
    g = {k: v.numpy() for k, v in got.apply(None).items()}
    w = {k: np.asarray(v) for k, v in want.apply(None).items()}
    assert np.array_equal(g["logits"], w["logits"])
    assert np.array_equal(g["embeddings"], out["embeddings"])
    if family == "birdnet-v24":
        assert np.array_equal(g["scores"], w["scores"])
        assert np.array_equal(g["scores"], out["scores"][:, ::8])
    else:
        assert np.abs(g["scores"] - w["scores"]).max() <= SCORE_BOUND
        assert np.abs(g["scores"].sum(-1) - 1).max() <= SCORE_BOUND
        kept = out["scores"][:, ::8].astype(np.float64)
        assert np.abs(g["scores"] - kept / kept.sum(-1, keepdims=True)) \
            .max() <= SCORE_BOUND


@pytest.mark.parametrize("family", ["birdnet-v24", "perch-v2"])
def test_region_labels_through_analyze_matches_jax(v24, perch, home, family):
    """``region_labels`` keeping every 8th label: detections equal the JAX
    run's (v2.4: confidences within CONF_BOUND; Perch, whose renormalized
    scores stay far below 1 with random weights: within CONF_BOUND of the
    largest), and every detection is a regional label."""
    import birda_tpu.api as jax_api

    import birda_tpu_torch.api as torch_api

    kw, labels = v24 if family == "birdnet-v24" else perch
    region = home / "region-r8.txt"
    region.write_text("".join(f"{lab}\n" for lab in labels[::8]))
    wav = _chirps(home / "rec.wav", 48_000, 9.0, 3)
    run = dict(kw, region_labels=region)
    if family == "perch-v2":
        run["min_confidence"] = 1e-5
    want = jax_api.analyze([wav], **run)
    got = torch_api.analyze([wav], **run)
    assert got.exit_code == want.exit_code == 0
    top = max(d.confidence for d in want.detections)
    _assert_same_detections(_rows(got), _rows(want),
                            CONF_BOUND * (1.0 if family == "birdnet-v24"
                                          else top))
    kept = {lab.split("_")[0] for lab in labels[::8]}
    assert all(d.scientific_name in kept for d in got.detections)
    assert got.precision is None


# -- the species list ------------------------------------------------------------

@pytest.mark.parametrize("sort", ["freq", "alpha"])
def test_species_matches_jax(home, sort):
    """api.species on the fixture geomodel: the same entries in the same
    order, scores within SCORE_BOUND; and the species command writes the
    same species_list.txt, byte for byte, as ``birda species``."""
    from click.testing import CliRunner

    import birda_tpu.api as jax_api
    from birda_tpu.cli.main import cli

    import birda_tpu_torch.api as torch_api
    from birda_tpu_torch.cli.main import main

    geo, geo_labels, _ = _geomodel(home, synthetic_labels(300), 200)
    kw = dict(week=QUERY[2], threshold=0.05, sort=sort, geomodel_path=geo,
              geomodel_labels_path=geo_labels)
    want = jax_api.species(*QUERY[:2], **kw)
    got = torch_api.species(*QUERY[:2], **kw, device="cpu")
    assert 0 < len(want) < 200
    assert [(e.scientific_name, e.common_name, e.label) for e in got] == \
        [(e.scientific_name, e.common_name, e.label) for e in want]
    assert max(abs(a.score - b.score) for a, b in zip(got, want)) \
        <= SCORE_BOUND

    args = ["species", "--lat", "-1.3", "--lon", "0.7", "--month", "1",
            "--day", "14", "--threshold", "0.05", "--sort", sort,
            "--geomodel-path", str(geo), "--geomodel-labels-path",
            str(geo_labels)]
    jax_out, port_out = home / "jax.txt", home / "port.txt"
    r = CliRunner().invoke(cli, args + ["-o", str(jax_out)])
    assert r.exit_code == 0, r.output
    assert main(args + ["-o", str(port_out), "--cpu"]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert port_out.read_text().count("\n") > 0


def test_species_requires_a_date_and_the_card(home):
    import birda_tpu_torch.api as torch_api
    from birda_tpu_torch.errors import ConfigValidation, RuntimeInitialization

    geo, geo_labels, _ = _geomodel(home, synthetic_labels(100), 64)
    with pytest.raises(ConfigValidation, match="provide week"):
        torch_api.species(60.2, 24.9, geomodel_path=geo,
                          geomodel_labels_path=geo_labels, device="cpu")
    with pytest.raises(ConfigValidation, match="device must be"):
        torch_api.species(60.2, 24.9, week=3, device="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeInitialization):
            torch_api.species(60.2, 24.9, week=3, geomodel_path=geo,
                              geomodel_labels_path=geo_labels)


def test_species_json_output_mode(home, capsys):
    """``--output-mode json`` reports the list inline and writes no file."""
    import json

    from birda_tpu_torch.cli.main import main

    geo, geo_labels, _ = _geomodel(home, synthetic_labels(100), 64)
    out = home / "never.txt"
    assert main(["species", "--lat", "1", "--lon", "2", "--week", "7",
                 "--geomodel-path", str(geo), "--geomodel-labels-path",
                 str(geo_labels), "--output-mode", "json", "--cpu",
                 "-o", str(out)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert not out.exists()
    assert json.dumps(doc).count("scientific_name") > 0
