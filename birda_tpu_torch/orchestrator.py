"""Analysis orchestration: the port of ``birda_tpu/orchestrator.py``.

The same analyze flow — model resolution (named > ad-hoc > default),
device resolution, species-list precedence, smart batch-size defaults,
warm-up, the per-file loop with skip/lock/stale-reclaim/error-isolation
semantics, output combining and the run summary — on the PyTorch
classifier. The JAX module imports jax at load, so its flow is ported here
with the same names; the host code it calls is the port's own copy of the
JAX package's modules (same subpackage and module names).

All four precisions run: fp32, bf16, and the calibrated ``mixed`` and
``int8`` (:mod:`birda_tpu_torch.onnx.quantize`), whose non-quantized ops
compute in bf16 on the card and, as the card's test double, on the CPU too.
So do the secondary heads: the geomodel range filter (queried once on the
run's device), the bat two-stage head (``--bat``) and regional slicing
(``--region-labels``); the native model family behind ``synthetic:tiny``
and ``synthetic:full`` model paths (float32 whatever the precision, as in
the JAX package); ``--jobs N`` per-file worker threads over one shared
classifier; and ``--devices N`` replicas over the local CUDA devices
(:func:`resolve_mesh`). A pod joined through the ``BIRDA_COORDINATOR``
contract divides files through the lock files, each host on its own
devices.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from . import constants
from .config import geomodel as geomodel_cfg
from .config import range_filter as rf_cfg
from .config.types import Config, InferenceDevice, ModelConfig, ModelType
from .config.validate import get_model, validate_model_config
from .errors import (
    BirdaError,
    ClassifierBuild,
    ConfigValidation,
    FileLocked,
)
from .inference.geomodel import GeomodelScores, MappingSummary, SpeciesMapping
from .inference.geomodel_filter import FilterSettings
from .inference.range_filter import RangeFilter, read_geomodel_labels
from .locking.file_lock import FileLock
from .models import contracts
from .output import json_envelope as env
from .output.json_envelope import FileStatus, PipelineStatus
from .pipeline.config import ProcessingConfig
from .pipeline.coordinator import (
    OutputFormat,
    ProcessCheck,
    collect_input_files,
    output_dir_for,
    should_process,
)

from .inference.classifier import BirdClassifier, RangeFilterData
from .models.zoo import LoadedModel, native_model, onnx_model, tiny_model
from .pipeline.processor import process_file

logger = logging.getLogger(__name__)

ADHOC_MODEL_NAME = "ad-hoc"
PROCESSING_ERROR_CODE = "processing_error"

_MODEL_TYPE_TO_FAMILY = {
    ModelType.BIRDNET_V24: contracts.ModelFamily.BIRDNET_V24,
    ModelType.BIRDNET_V30: contracts.ModelFamily.BIRDNET_V30,
    ModelType.PERCH_V2: contracts.ModelFamily.PERCH_V2,
    ModelType.BSG_FINLAND: contracts.ModelFamily.BSG_FI_V44,
}

#: Precisions this port runs, the JAX package's four.
PRECISIONS = ("fp32", "bf16", "mixed", "int8")


@dataclass
class AnalyzeOptions:
    """Parsed analyze inputs (the fields of the JAX package's
    ``AnalyzeOptions``; see there for each one's meaning)."""

    inputs: list[Path] = field(default_factory=list)
    model: Optional[str] = None
    model_path: Optional[Path] = None
    labels_path: Optional[Path] = None
    model_type: Optional[ModelType] = None
    bat: Optional[str] = None
    formats: Optional[list[OutputFormat]] = None
    output_dir: Optional[Path] = None
    min_confidence: Optional[float] = None
    overlap: Optional[float] = None
    batch_size: Optional[int] = None
    combine: bool = False
    force: bool = False
    fail_fast: bool = False
    no_csv_bom: bool = False
    device_flags: dict = field(default_factory=dict)  # {"cpu": bool, ...}
    lat: Optional[float] = None
    lon: Optional[float] = None
    week: Optional[int] = None
    month: Optional[int] = None
    day: Optional[int] = None
    day_of_year: Optional[int] = None
    range_threshold: Optional[float] = None
    rerank: bool = False
    range_unmatched: Optional[str] = None
    slist: Optional[Path] = None
    stale_lock_timeout: Optional[float] = None
    stdout_mode: bool = False
    #: Concurrent per-file workers over one classifier: one file's decode
    #: and host work overlap another's steps on the card.
    jobs: int = 1
    dual_output_mode: bool = False
    top_k: int = constants.DEFAULT_TOP_K
    geomodel_path: Optional[Path] = None
    geomodel_labels_path: Optional[Path] = None
    allow_download: bool = False
    region_labels: Optional[Path] = None
    decode_workers: int = 0
    #: "fp32" (TF32 off), "bf16" (bf16 matmuls/convs with fp32
    #: accumulation and the fused front-end kernel), "mixed" (bf16 with
    #: calibrated int8 storage of the large streams) or "int8" (calibrated
    #: int8 convs/matmuls with exact int32 sums).
    precision: str = "fp32"
    calibration_audio: Optional[Path] = None
    stream_detections: bool = False
    #: Replicas to shard each batch over (data parallelism): None = every
    #: local CUDA device (the CPU only on an explicit N), 1 = no sharding.
    #: ``BIRDA_NO_SHARD`` is the environment kill switch.
    devices: Optional[int] = None
    interactive: bool = False


@dataclass
class RunStats:
    files_processed: int = 0
    files_failed: int = 0
    files_skipped: int = 0
    total_detections: int = 0
    total_segments: int = 0
    total_audio_secs: float = 0.0
    started: float = field(default_factory=time.monotonic)

    @property
    def duration_secs(self) -> float:
        return time.monotonic() - self.started

    @property
    def realtime_factor(self) -> float:
        d = self.duration_secs
        return self.total_audio_secs / d if d > 0 else 0.0

    @property
    def segments_per_sec(self) -> float:
        d = self.duration_secs
        return self.total_segments / d if d > 0 else 0.0


# ---------------------------------------------------------------------------
# Resolution helpers
# ---------------------------------------------------------------------------

def _apply_model_overrides(mc: ModelConfig,
                           options: AnalyzeOptions) -> ModelConfig:
    """``--model-path``/``--labels-path`` patch a named/default model;
    returns a copy."""
    if options.model_path is None and options.labels_path is None:
        return mc
    import dataclasses

    return dataclasses.replace(
        mc,
        path=options.model_path if options.model_path is not None else mc.path,
        labels=(options.labels_path if options.labels_path is not None
                else mc.labels),
    )


def resolve_model_config(options: AnalyzeOptions, config: Config
                         ) -> tuple[ModelConfig, str]:
    """Priority: -m name > ad-hoc (--model-path + --model-type) > config
    default."""
    if options.model is not None:
        mc = get_model(config, options.model)
        if options.model_type is not None:
            logger.warning("--model-type is ignored when -m is provided "
                           "(using model type from config)")
        return _apply_model_overrides(mc, options), options.model

    if options.model_type is not None and options.model_path is not None:
        if options.labels_path is None:
            raise ConfigValidation(
                "--labels-path required when using --model-path with "
                "--model-type")
        return (
            ModelConfig(path=options.model_path, labels=options.labels_path,
                        model_type=options.model_type),
            ADHOC_MODEL_NAME,
        )

    if config.defaults.model is not None:
        mc = get_model(config, config.defaults.model)
        if options.model_type is not None:
            logger.warning(
                "--model-type is ignored when using default model '%s' "
                "(provide both --model-path and --model-type to use "
                "ad-hoc mode)", config.defaults.model)
        return _apply_model_overrides(mc, options), config.defaults.model

    if options.model_path is not None:
        raise ConfigValidation(
            "--model-type required when using --model-path without -m")
    raise ConfigValidation(
        "no model specified (use -m, set defaults.model in config, or "
        "provide --model-path with --labels-path and --model-type)")


def resolve_decode_workers(options: AnalyzeOptions) -> int:
    """0 = auto: split one file's decode across up to 4 cores, unless
    ``--jobs`` already uses them for cross-file parallelism."""
    if options.decode_workers > 0:
        return options.decode_workers
    if options.jobs > 1:
        return 1
    import os

    return max(1, min(4, os.cpu_count() or 1))


def load_model_graph(mc: ModelConfig, name: str,
                     precision: str = "fp32", device: str = "auto",
                     calibration_audio: Optional[Path] = None) -> LoadedModel:
    """Turn a config entry into a runnable graph: an ``.onnx`` file through
    the torch lowering, in any of :data:`PRECISIONS` (on any backend: on the
    CPU the fused front-end takes its plain version). ``device`` is the
    requested backend, on which int8/mixed calibrate. The ``synthetic:``
    scheme builds the native architecture with deterministic weights —
    ``synthetic:tiny`` (or ``synthetic:``) for CI-sized runs,
    ``synthetic:full`` for benchmarking — in float32 at any precision."""
    import torch

    if precision not in PRECISIONS:
        raise ConfigValidation(
            f"precision must be one of {', '.join(PRECISIONS)} "
            f"(got '{precision}')")
    family = _MODEL_TYPE_TO_FAMILY[mc.model_type]
    path_str = str(mc.path)
    if path_str.startswith("synthetic:"):
        flavor = path_str.split(":", 1)[1] or "tiny"
        if flavor == "full":
            return native_model(family)
        return tiny_model(family)
    validate_model_config(name, mc)
    labels = read_geomodel_labels(mc.labels)  # one label per line
    try:
        if precision in ("int8", "mixed"):
            return _load_int8_model(mc, family, labels, calibration_audio,
                                    device=device,
                                    storage_only=precision == "mixed")
        return onnx_model(
            mc.path, contracts.contract_for(family), labels,
            dtype=torch.bfloat16 if precision == "bf16" else None)
    except BirdaError:
        raise
    except Exception as e:  # noqa: BLE001 — parse/lowering errors -> typed
        raise ClassifierBuild(f"cannot load model graph {mc.path}: {e}") \
            from e


def _load_int8_model(mc: ModelConfig, family, labels: list[str],
                     calibration_audio: Optional[Path], device: str = "auto",
                     storage_only: bool = False) -> LoadedModel:
    """Calibrated int8 execution of a float graph (the TensorRT-int8 engine
    analogue; the reference caches those engines,
    ``src/inference/classifier.rs:994-1057``, this caches the calibration
    scales).

    Scales from the built-in synthetic calibration set are cached per graph
    digest under the cache dir, so repeat runs skip the calibration pass.
    Explicit ``--calibration-audio`` always recalibrates. Calibration runs
    fp32 on the requested backend's device.

    The non-quantized ops compute in bf16 on every backend: the CPU route
    is the card route's test double (the JAX package computes them in fp32
    on the CPU, where XLA lacks a bf16 dot). ``storage_only=True`` is
    ``--precision mixed``: no node quantizes; the calibration scales only
    back int8 *storage* of the large boundary streams.
    """
    import torch

    from .inference.backend import select_backend
    from .models.zoo import onnx_model_int8
    from .onnx.quantize import cached_calibration, calibrate

    contract = contracts.contract_for(family)
    data = Path(mc.path).read_bytes()
    calib_device = select_backend(device)[0][0]
    t0 = time.monotonic()
    if calibration_audio is not None:
        batches = _calibration_batches_from_audio(
            calibration_audio, contract.sample_rate, contract.sample_count)
        logger.info("calibrating int8 activation scales on %s...",
                    calibration_audio)
        calib = calibrate(data, batches, device=calib_device)
        from_cache = False
    else:
        calib, from_cache = cached_calibration(
            data, contract.sample_count, device=calib_device)
    logger.info("int8 calibration scales %s in %.2fs",
                "loaded from cache" if from_cache else "computed",
                time.monotonic() - t0)
    return onnx_model_int8(data, contract, labels, calib,
                           compute_dtype=torch.bfloat16,
                           storage_only=storage_only)


def _calibration_batches_from_audio(path: Path, sample_rate: int,
                                    sample_count: int,
                                    batch: int = 8, max_batches: int = 4):
    """Segment representative audio into calibration batches through the
    same decode + resample stack the analysis itself uses."""
    from .audio.decode import StreamingDecoder
    from .ops.resample import resample_numpy

    files = collect_input_files([Path(path)])
    if not files:
        raise ConfigValidation(
            f"--calibration-audio {path}: no audio files found"
        )
    rows: list[np.ndarray] = []
    batches: list[np.ndarray] = []
    for f in files:
        with StreamingDecoder(f) as dec:
            src_rate = dec.sample_rate
            src_seg = int(round(sample_count * src_rate / sample_rate))
            while len(batches) < max_batches:
                seg = dec.next_segment(src_seg, 0)
                if seg is None:
                    break
                x = seg.samples
                if src_rate != sample_rate:
                    x = resample_numpy(x, src_rate, sample_rate)
                if x.shape[0] < sample_count:
                    x = np.pad(x, (0, sample_count - x.shape[0]))
                rows.append(x[:sample_count].astype(np.float32))
                if len(rows) == batch:
                    batches.append(np.stack(rows))
                    rows = []
        if len(batches) >= max_batches:
            break
    if rows and not batches:
        # Short clip: cycle its segments to fill one batch rather than fail.
        orig = list(rows)
        while len(rows) < batch:
            rows.append(orig[(len(rows) - len(orig)) % len(orig)])
        batches.append(np.stack(rows[:batch]))
    if not batches:
        raise ConfigValidation(
            f"--calibration-audio {path}: could not decode any segments"
        )
    return batches


def resolve_mesh(options: AnalyzeOptions, devices: list,
                 actual_backend: str) -> Optional[list]:
    """The replica devices of a data-parallel run, or None for one device.

    Shards the segment batch over every device of the actual backend by
    default (``select_backend`` lists only this process's devices, so in a
    joined pod each host shards over its own and the pod divides files
    through the lock files). ``options.devices=1`` or ``BIRDA_NO_SHARD``
    disables sharding; ``options.devices=N`` caps the replicas at N. The
    CPU shards only on an explicit ``--devices N``.
    """
    import os

    if os.environ.get("BIRDA_NO_SHARD"):
        if options.devices is not None and options.devices > 1:
            logger.warning("BIRDA_NO_SHARD is set; ignoring --devices %d",
                           options.devices)
        logger.info("batch sharding disabled by BIRDA_NO_SHARD")
        return None
    local = list(devices)
    if options.devices is None and actual_backend == "cpu":
        return None
    if options.devices is not None:
        if options.devices < 1:
            raise ConfigValidation(
                f"--devices must be >= 1 (got {options.devices})")
        if options.devices > len(local):
            raise ConfigValidation(
                f"--devices {options.devices} requested but only "
                f"{len(local)} local {actual_backend} device(s) are "
                "available")
        local = local[:options.devices]
    if len(local) <= 1:
        return None
    logger.info(
        "data parallelism: batch sharded over %d %s devices (disable "
        "with --devices 1 or BIRDA_NO_SHARD=1)", len(local), actual_backend)
    return local


def resolve_device(options: AnalyzeOptions, config: Config) -> str:
    """First set device flag wins, else the config. ``gpu`` is an explicit
    CUDA request here (in the JAX package it is an alias for auto)."""
    flags = options.device_flags or {}
    for flag_name, device in (
        ("gpu", "cuda"),
        ("cuda", "cuda"),
        ("tpu", "tpu"),  # refused by select_backend: no TPU in this build
        ("cpu", "cpu"),
    ):
        if flags.get(flag_name):
            return device
    cfg = config.inference.device
    if cfg == InferenceDevice.GPU:
        return "cuda"
    if cfg == InferenceDevice.TPU:
        return "tpu"
    if cfg == InferenceDevice.CPU:
        return "cpu"
    return "auto"


#: Default batch sizes on CUDA, from the reference's code defaults
#: (BASELINE.md: CUDA v2.4 64, v3.0 and Perch 32). Not yet measured on
#: the H100: a batch sweep is an open item of PERF.md.
CUDA_BATCH_BIRDNET_V24 = 64
CUDA_BATCH_OTHER = 32


def determine_default_batch_size(model_type: ModelType,
                                 actual_backend: str) -> int:
    """Smart default keyed on (model family, ACTUAL backend)."""
    bs = constants.batch_size
    if actual_backend == "cpu":
        return bs.CPU
    if actual_backend == "cuda":
        if model_type in (ModelType.BIRDNET_V24, ModelType.BSG_FINLAND):
            return CUDA_BATCH_BIRDNET_V24
        return CUDA_BATCH_OTHER
    return bs.OTHER_ACCEL


def resolve_species_filter(options: AnalyzeOptions, config: Config,
                           has_range_filter: bool) -> Optional[set[str]]:
    """Priority: range filter (dynamic) > species list (static) > none."""
    if has_range_filter:
        if options.slist is not None:
            logger.warning(
                "Ignoring --slist: range filtering takes precedence when "
                "coordinates and a date are given. Drop --lat/--lon to use "
                "the species list instead."
            )
        return None
    slist_path = options.slist or config.defaults.species_list_file
    if slist_path is None:
        return None
    from .utils.species_list import read_species_list

    species = set(read_species_list(slist_path))
    logger.info("Species list filter enabled: %d species loaded",
                len(species))
    return species


def build_range_filter_data(
    request: rf_cfg.RangeFilterRequest,
    installed: geomodel_cfg.InstalledRangeFilter,
    classifier_labels: list[str],
    device: str = "auto",
) -> RangeFilterData:
    """Query the geomodel ONCE, on ``device`` (the run's), and project its
    scores into the classifier's label space."""
    geomodel_labels = read_geomodel_labels(installed.labels_path)
    rf = RangeFilter.from_onnx(
        installed.model_path, geomodel_labels,
        threshold=constants.range_filter.GEOMODEL_QUERY_THRESHOLD,
        device=device,
    )
    location_scores = rf.predict_week(
        request.latitude, request.longitude, request.week
    )
    mapping = SpeciesMapping.build(geomodel_labels, classifier_labels)
    scores = GeomodelScores.project(location_scores, mapping)
    settings = FilterSettings(
        threshold=request.threshold,
        unmatched=request.unmatched,
        rerank=request.rerank,
    )
    return RangeFilterData(
        scores=scores,
        settings=settings,
        summary=MappingSummary.new(mapping, scores, request.threshold),
    )


def _bat_classifier(options: AnalyzeOptions, config: Config):
    """The bat two-stage head of ``--bat``, on the run's device."""
    from .config.bat import BatConfig, BatRegion
    from .models.custom import CustomClassifier
    from .registry.installer import models_dir

    try:
        region = BatRegion(options.bat)
    except ValueError:
        # Typed at this layer too: the library API (bat=...) reaches here
        # without the CLI's choice check.
        raise ConfigValidation(
            f"unknown bat region '{options.bat}' (valid: "
            f"{', '.join(r.value for r in BatRegion)})"
        ) from None
    bat_config = BatConfig.resolve(region, models_dir() / "bat")
    return CustomClassifier.from_onnx(
        bat_config.classifier_path, bat_config.labels_path,
        min_confidence=(
            options.min_confidence if options.min_confidence is not None
            else config.defaults.min_confidence
        ),
        top_k=options.top_k,
        device=resolve_device(options, config),
    )


def _range_filter_request(options: AnalyzeOptions, config: Config,
                          mc: ModelConfig):
    """The range-filter request and its resolved geomodel, or (None, None)
    when no filter applies or, with a warning, when the geomodel is
    unavailable."""
    rf_cfg.validate_threshold(options.range_threshold, config)
    bat_mode = options.bat is not None
    if not rf_cfg.wants_range_filter(
        config, mc.model_type, bat_mode,
        options.lat, options.lon, options.week, options.month, options.day,
    ):
        return None, None
    from .inference.geomodel_filter import UnmatchedPolicy
    from .registry.loader import load_registry

    request = rf_cfg.build_range_filter_request(
        config, mc.model_type, bat_mode,
        options.lat, options.lon, options.week, options.month, options.day,
        options.range_threshold,
        UnmatchedPolicy(options.range_unmatched)
        if options.range_unmatched else None,
        options.rerank,
    )
    cfg_for_geo = geomodel_cfg.config_with_override(
        config, options.geomodel_path, options.geomodel_labels_path
    )
    installed = geomodel_cfg.resolve_geomodel(
        cfg_for_geo, load_registry(),
        allow_download=options.allow_download,
        interactive=options.interactive,
    )
    if isinstance(installed, geomodel_cfg.GeomodelUnavailable):
        # Coordinates in config enable range filtering implicitly, so an
        # error here would break existing pipelines: degrade with the
        # resolver's reason.
        logger.warning("Range filtering disabled: %s", installed.reason)
        return None, None
    return request, installed


# ---------------------------------------------------------------------------
# The analyze run
# ---------------------------------------------------------------------------

def analyze_files(options: AnalyzeOptions, config: Config,
                  reporter=None) -> int:
    """Full analyze flow; returns a process exit code."""
    # Multi-host pod membership (BIRDA_COORDINATOR env contract) comes
    # before any device use; a no-op on a single host.
    from .parallel.mesh import initialize_multihost

    if initialize_multihost():
        logger.info(
            "pod joined: files divide across hosts via lock files; each "
            "host shards batches over its local devices"
        )

    # --stdout streams one file's detections; concurrent workers would
    # interleave the stream, so it also forces jobs=1.
    if options.stdout_mode and len(options.inputs) != 1:
        raise ConfigValidation("--stdout requires exactly one input file")
    if options.stdout_mode and options.jobs > 1:
        logger.warning("--stdout streams sequentially; ignoring --jobs %d",
                       options.jobs)
        options.jobs = 1

    mc, model_name = resolve_model_config(options, config)
    custom_classifier = (_bat_classifier(options, config)
                         if options.bat is not None else None)

    files = collect_input_files(options.inputs)
    if not files:
        from .errors import NoValidAudioFiles

        raise NoValidAudioFiles()

    # Validated before resolution, resolved before the classifier, degraded
    # to unfiltered when the geomodel is unavailable.
    range_request, installed_geomodel = _range_filter_request(
        options, config, mc)

    device = resolve_device(options, config)
    from .inference.backend import select_backend

    backend_devices, backend_status = select_backend(device)
    mesh = resolve_mesh(options, backend_devices, backend_status.actual)
    model = load_model_graph(mc, model_name, precision=options.precision,
                             device=device,
                             calibration_audio=options.calibration_audio)
    if options.region_labels is not None:
        # Regional view of the full graph (gather for sigmoid heads,
        # gather+renormalize for softmax) without a region-sliced asset.
        from .models.regional import slice_to_region

        region_labels = read_geomodel_labels(options.region_labels)
        model = slice_to_region(model, region_labels,
                                region=options.region_labels.stem)
    species_list = resolve_species_filter(
        options, config, has_range_filter=range_request is not None)
    min_confidence = (
        options.min_confidence if options.min_confidence is not None
        else config.defaults.min_confidence
    )

    range_filter_data = None
    if range_request is not None:
        range_filter_data = build_range_filter_data(
            range_request, installed_geomodel, model.labels, device=device)

    # BSG post-processing: calibration always, SDM when (lat, lon, day)
    # resolve. Coordinates follow the range filter's when one is active,
    # else the bare --lat/--lon; the day comes from the flag/config or
    # per-file mtime.
    bsg_processor = None
    bsg_params = None
    if mc.bsg_calibration is not None:
        from .inference.bsg import BsgPostProcessor

        bsg_processor = BsgPostProcessor.from_paths(
            mc.bsg_calibration, mc.bsg_migration, mc.bsg_distribution_maps)
        doy = (options.day_of_year if options.day_of_year is not None
               else config.defaults.day_of_year)
        if range_request is not None:
            bsg_params = (range_request.latitude, range_request.longitude,
                          doy)
        elif options.lat is not None and options.lon is not None:
            bsg_params = (options.lat, options.lon, doy)

    classifier = BirdClassifier(
        model,
        device=device,
        min_confidence=min_confidence,
        top_k=options.top_k,
        range_filter_data=range_filter_data,
        species_list=species_list,
        want_embeddings=custom_classifier is not None,
        mesh=mesh,
    )

    batch_size = (
        options.batch_size if options.batch_size is not None
        else config.defaults.batch_size
        if config.defaults.batch_size is not None
        else determine_default_batch_size(
            mc.model_type, classifier.backend_status.actual)
    )
    if mesh is not None:
        from .parallel.mesh import pad_to_multiple

        padded = pad_to_multiple(batch_size, mesh)
        if padded != batch_size:
            logger.info(
                "batch size %d padded to %d (multiple of the %d-device mesh)",
                batch_size, padded, len(mesh))
            batch_size = padded
    overlap = (options.overlap if options.overlap is not None
               else config.defaults.overlap)
    formats = options.formats or config.defaults.formats

    if reporter is not None:
        sharding_info = None
        if mesh is not None:
            sharding_info = {"devices": len(mesh), "axis": "data",
                             "backend": backend_status.actual}
        reporter.pipeline_started(
            len(files), model_name, min_confidence,
            classifier.backend_status.to_json_dict(),
            classifier.range_filter_info(),
            precision=model.precision_info,
            sharding=sharding_info,
        )

    # Warm the steady-state runner up front so the first real file does not
    # absorb the kernel build and autotuning. Bat mode skips this: its
    # window contract (constants.bat) differs from the bird geometry, so the
    # bird-shaped runner would never be used.
    if options.bat is None:
        step_model = max(1, classifier.sample_count
                         - int(round(overlap * classifier.sample_rate)))
        try:
            report = classifier.chunk_runner(batch_size,
                                             step_model).ensure_warm()
        except BirdaError:
            raise
        except Exception as e:  # noqa: BLE001 — a graph the card rejects
            raise ClassifierBuild(str(e)) from e
        if report is not None:
            logger.info("warmup batch %d in %.2fs", batch_size,
                        report.seconds)

    stats = process_all_files(
        classifier, files, options, config, batch_size, overlap, formats,
        model_name, min_confidence, custom_classifier, reporter,
        range_request, bsg_processor, bsg_params,
    )
    if options.combine and not options.stdout_mode:
        _combine_outputs(files, options, formats)
    _report_summary(stats, reporter)
    if stats.files_failed > 0 and stats.files_processed == 0:
        return 1
    return 0


def _emit_file_started(reporter, classifier, input_path, index, overlap,
                       bat_mode: bool) -> None:
    """The protocol's file_started event with a duration-based segment
    estimate; bat mode uses its own window contract (constants.bat)."""
    if reporter is None:
        return
    est_segments = 0
    duration = None
    try:
        from .audio.decode import get_audio_duration

        duration = get_audio_duration(input_path)
        if bat_mode:
            seg = constants.bat.SEGMENT_DURATION
            step = max(seg - constants.bat.OVERLAP, 1e-9)
        else:
            seg = classifier.segment_duration
            step = max(seg - overlap, 1e-9)
        import math

        est_segments = (
            1 if duration <= seg
            else math.ceil((duration - seg) / step) + 1
        ) if duration > 0 else 0
    except BirdaError:
        pass
    reporter.file_started(str(input_path), index, est_segments, duration)


def process_all_files(
    classifier, files, options, config, batch_size, overlap, formats,
    model_name, min_confidence, custom_classifier, reporter,
    range_request=None, bsg_processor=None, bsg_params=None,
) -> RunStats:
    """The per-file loop: in order, or with ``--jobs N`` (more than one
    file, no ``--fail-fast``) on N worker threads over the one classifier.

    Per-file semantics (stale-lock reclaim, skip check, lock, outputs,
    error isolation) are the same either way: the lock layer arbitrates
    concurrent workers exactly as it does between processes on a shared
    filesystem. Under ``--jobs`` reporter events may interleave across
    files (each carries its path) and no progress bars are drawn.
    """
    import threading
    from concurrent.futures import ThreadPoolExecutor

    stats = RunStats()
    stats_lock = threading.Lock()
    range_filter_params = None
    if range_request is not None:
        range_filter_params = (range_request.latitude,
                               range_request.longitude, range_request.week)
    streamed = (options.stdout_mode or options.dual_output_mode
                or options.stream_detections)
    parallel = options.jobs > 1 and len(files) > 1 and not options.fail_fast

    def count(**deltas):
        with stats_lock:
            for name, delta in deltas.items():
                setattr(stats, name, getattr(stats, name) + delta)

    def skipped(input_path, status):
        count(files_skipped=1)
        if reporter is not None:
            reporter.file_skipped(str(input_path), status)

    def failed(input_path, code_message):
        count(files_failed=1)
        if reporter is not None:
            reporter.file_completed_failure(
                str(input_path), PROCESSING_ERROR_CODE, code_message)

    def work(item):
        index, input_path = item
        output_dir = output_dir_for(input_path, options.output_dir)

        # Stale-lock reclamation before the skip check.
        if (
            options.stale_lock_timeout is not None
            and FileLock.is_locked(input_path, output_dir)
            and FileLock.is_stale(input_path, output_dir,
                                  options.stale_lock_timeout)
        ):
            logger.info("Reclaiming stale lock for %s", input_path)
            try:
                FileLock.remove_stale(input_path, output_dir)
            except BirdaError as e:
                logger.warning("could not reclaim stale lock: %s", e)

        check = should_process(
            input_path, output_dir, formats,
            force=options.force,
            stdout_mode=options.stdout_mode or options.stream_detections,
        )
        if check != ProcessCheck.PROCESS:
            skipped(input_path,
                    FileStatus.LOCKED if check == ProcessCheck.SKIP_LOCKED
                    else FileStatus.SKIPPED)
            return

        pcfg = ProcessingConfig(
            input_path=input_path,
            output_dir=output_dir,
            formats=formats,
            min_confidence=min_confidence,
            overlap=overlap,
            batch_size=batch_size,
            csv_columns=list(config.defaults.csv_columns.include),
            csv_bom_enabled=not options.no_csv_bom,
            model_name=model_name,
            range_filter_params=range_filter_params,
            reporter=reporter if streamed else None,
            # Interleaved progress bars are worse than none.
            progress_reporter=None if parallel else reporter,
            dual_output_mode=options.dual_output_mode,
            custom_classifier=custom_classifier,
            bat_mode=options.bat is not None,
            decode_workers=resolve_decode_workers(options),
            bsg_processor=bsg_processor,
            bsg_params=bsg_params,
        )
        _emit_file_started(reporter, classifier, input_path, index, overlap,
                           options.bat is not None)
        start = time.monotonic()
        try:
            result = process_file(classifier, pcfg)
        except FileLocked:
            # Another worker took the file between the check and the lock.
            skipped(input_path, FileStatus.LOCKED)
            return
        except BirdaError as e:
            logger.error("Failed to process %s: %s", input_path, e)
            failed(input_path, str(e))
            if options.fail_fast:
                raise
            return
        except Exception as e:  # noqa: BLE001 — per-file isolation
            logger.error("Failed to process %s: %s: %s", input_path,
                         type(e).__name__, e)
            logger.debug("unhandled per-file exception", exc_info=True)
            failed(input_path, f"{type(e).__name__}: {e}")
            if options.fail_fast:
                raise
            return

        count(files_processed=1, total_detections=result.detections,
              total_segments=result.segments,
              total_audio_secs=result.audio_duration_secs)
        if reporter is not None:
            reporter.file_completed_success(
                str(input_path), result.detections,
                int((time.monotonic() - start) * 1000))

    if not parallel:
        for item in enumerate(files):
            work(item)
        return stats
    # Not `with pool: pool.map(...)`: that submits every file up front and
    # shuts down without cancelling, so a Ctrl+C (SystemExit from the SIGINT
    # handler, which has already released the live locks) would go on
    # through the whole queue — now-unlocked files a second process may
    # pick up. cancel_futures drops the files not yet started; those in
    # flight finish.
    pool = ThreadPoolExecutor(max_workers=options.jobs)
    try:
        futures = [pool.submit(work, item) for item in enumerate(files)]
        for f in futures:
            f.result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return stats


def _combine_outputs(files, options, formats):
    """Combine per-file outputs into single tables (``--combine``)."""
    from .constants import UTF8_BOM, combined_filenames
    from .pipeline.coordinator import output_path_for

    out_root = options.output_dir or output_dir_for(files[0], None)

    def parts_of(fmt):
        return [
            p for f in files
            if (p := output_path_for(
                f, output_dir_for(f, options.output_dir), fmt)).exists()
        ]

    if OutputFormat.PARQUET in formats:
        from .output.parquet import combine_parquet_files

        parts = parts_of(OutputFormat.PARQUET)
        if parts:
            combine_parquet_files(
                parts, Path(out_root) / combined_filenames.PARQUET)
    for fmt, combined_name in (
        (OutputFormat.CSV, combined_filenames.CSV),
        (OutputFormat.RAVEN, combined_filenames.RAVEN),
        (OutputFormat.KALEIDOSCOPE, combined_filenames.KALEIDOSCOPE),
    ):
        parts = parts_of(fmt) if fmt in formats else []
        if not parts:
            continue
        selection_id = 0
        with open(Path(out_root) / combined_name, "w",
                  encoding="utf-8") as out:
            if fmt == OutputFormat.CSV and not options.no_csv_bom:
                out.write(UTF8_BOM.decode("utf-8"))
            for i, part in enumerate(parts):
                lines = part.read_text(encoding="utf-8-sig").splitlines(
                    keepends=True)
                if i > 0 and lines:
                    lines = lines[1:]  # every combined format has a header
                if fmt == OutputFormat.RAVEN:
                    # Selection ids restart at 1 per file; renumber.
                    renumbered = []
                    for j, line in enumerate(lines):
                        if (i == 0 and j == 0) or "\t" not in line:
                            renumbered.append(line)
                            continue
                        selection_id += 1
                        _, rest = line.split("\t", 1)
                        renumbered.append(f"{selection_id}\t{rest}")
                    lines = renumbered
                out.writelines(lines)


def _report_summary(stats: RunStats, reporter=None):
    status = (
        PipelineStatus.SUCCESS if stats.files_failed == 0
        else PipelineStatus.PARTIAL_SUCCESS if stats.files_processed > 0
        else PipelineStatus.FAILED
    )
    logger.info(
        "Complete: %d processed, %d skipped, %d errors, %d total "
        "detections in %.2fs",
        stats.files_processed, stats.files_skipped, stats.files_failed,
        stats.total_detections, stats.duration_secs,
    )
    if stats.files_processed > 0:
        logger.info(
            "Performance: %.1f segments/sec overall, %.1fx realtime "
            "(%.1fs total audio)",
            stats.segments_per_sec, stats.realtime_factor,
            stats.total_audio_secs,
        )
    if stats.files_failed > 0:
        logger.warning("%d file(s) had errors", stats.files_failed)
    if reporter is not None:
        reporter.pipeline_completed(
            env.pipeline_completed_payload(
                status,
                stats.files_processed,
                stats.files_failed,
                stats.files_skipped,
                stats.total_detections,
                stats.total_segments,
                int(stats.duration_secs * 1000),
                stats.realtime_factor,
            )
        )
