"""Programmatic analysis API: the port of ``birda_tpu/api.py::analyze``.

    from birda_tpu_torch.api import analyze

    result = analyze(["meadow.wav"], model="birdnet-v24", device="gpu",
                     precision="int8")
    for f in result:
        for d in f.detections:
            print(d.start_time, d.scientific_name, d.confidence)

The same keywords as the JAX package's ``analyze``, the same result types
(:class:`AnalyzeResult`, which here also carries what the run reported, and
:class:`FileResult`) and the same bounds checks, over the port's
orchestrator; :func:`species` is the JAX package's ``species`` with its
:class:`SpeciesEntry`. ``device`` is ``auto``/``cpu``/``cuda``/``gpu``:
``auto`` (the default) and ``gpu`` run on the CUDA card and fail without
one; only ``cpu`` runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

from .output.reporter import ProgressReporter
from .output.types import Detection

__all__ = ["analyze", "species", "clip", "AnalyzeResult", "FileResult",
           "Detection", "SpeciesEntry"]


@dataclass
class FileResult:
    """Per-file outcome: detections on success, an error string on failure,
    a skip reason when the file was skipped (lock/resume semantics)."""

    path: Path
    detections: list[Detection] = field(default_factory=list)
    error: Optional[str] = None
    skipped: Optional[str] = None

    @property
    def ok(self) -> bool:
        """Analyzed successfully: no error AND not skipped — a locked or
        resume-skipped file was never analyzed, which must not read as a
        successful zero-detection result."""
        return self.error is None and self.skipped is None


@dataclass
class AnalyzeResult:
    """Whole-run outcome."""

    files: list[FileResult]
    exit_code: int
    #: The backend status (``requested``/``actual``/``fallback_reason``),
    #: the model's precision report (None for fp32; the int8/mixed
    #: selection counts), the geomodel coverage record of a range-filtered
    #: run (None without one) and the run summary the pipeline reported.
    backend: Optional[dict] = None
    summary: Optional[dict] = None
    precision: Optional[dict] = None
    range_filter: Optional[dict] = None

    @property
    def detections(self) -> list[Detection]:
        """All detections across files, in processing order."""
        return [d for f in self.files for d in f.detections]

    def __iter__(self):
        return iter(self.files)


class _Collector(ProgressReporter):
    """Reporter that captures the detection stream in memory."""

    def __init__(self):
        self.by_file: dict[str, FileResult] = {}

    def _entry(self, file) -> FileResult:
        key = str(file)
        if key not in self.by_file:
            self.by_file[key] = FileResult(path=Path(key))
        return self.by_file[key]

    def detections(self, file, detections, bsg_metadata=None):
        self._entry(file).detections.extend(detections)

    def file_completed_failure(self, file, error_code, error_message):
        self._entry(file).error = f"{error_code}: {error_message}"

    def file_skipped(self, file, reason):
        entry = self._entry(file)
        entry.skipped = getattr(reason, "value", str(reason))


def _validate_bounds(**values) -> None:
    """Apply the CLI validators to whichever bounded values are set,
    raising the typed ConfigValidation the library contract documents."""
    from .cli import validators as v
    from .errors import ConfigValidation

    parsers = {
        "min_confidence": v.parse_confidence,
        "overlap": v.parse_overlap,
        "batch_size": v.parse_batch_size,
        "lat": v.parse_latitude,
        "lon": v.parse_longitude,
        "week": v.parse_week,
        "month": v.parse_month,
        "day": v.parse_day,
        "day_of_year": v.parse_day_of_year,
        "range_threshold": v.parse_confidence,
        "threshold": v.parse_confidence,
    }
    for name, value in values.items():
        if value is None:
            continue
        try:
            parsers[name](value)
        except v.ValidationFailure as e:
            raise ConfigValidation(f"{name}: {e}") from e


class _RunCollector(_Collector):
    """The detection collector, also keeping the run's status events."""

    def __init__(self):
        super().__init__()
        self.backend = None
        self.summary = None
        self.precision = None
        self.range_filter = None

    def pipeline_started(self, total_files, model, min_confidence,
                         execution_provider, range_filter=None,
                         precision=None, sharding=None):
        self.backend = execution_provider
        self.precision = precision
        self.range_filter = range_filter

    def pipeline_completed(self, summary):
        self.summary = summary


_DEVICES = ("auto", "cpu", "cuda", "gpu")


def _check_device(device: str) -> None:
    from .errors import ConfigValidation

    if device not in _DEVICES:
        raise ConfigValidation(
            f"device must be one of {', '.join(_DEVICES)} (got '{device}')")


def analyze(
    inputs: Sequence[Path | str],
    *,
    model: Optional[str] = None,
    model_path: Optional[Path | str] = None,
    labels_path: Optional[Path | str] = None,
    model_type: Optional[str] = None,
    bat: Optional[str] = None,
    min_confidence: Optional[float] = None,
    overlap: Optional[float] = None,
    batch_size: Optional[int] = None,
    top_k: Optional[int] = None,
    device: str = "auto",
    precision: str = "fp32",
    lat: Optional[float] = None,
    lon: Optional[float] = None,
    week: Optional[int] = None,
    month: Optional[int] = None,
    day: Optional[int] = None,
    day_of_year: Optional[int] = None,
    range_threshold: Optional[float] = None,
    rerank: bool = False,
    range_unmatched: Optional[str] = None,
    slist: Optional[Path | str] = None,
    region_labels: Optional[Path | str] = None,
    jobs: int = 1,
    decode_workers: int = 0,
    devices: Optional[int] = None,
    fail_fast: bool = False,
    force: bool = True,
    config=None,
) -> AnalyzeResult:
    """Analyze audio files and return detections in memory (no output
    files). Model selection, bounds and error semantics follow the JAX
    package's ``birda_tpu.api.analyze``: ``jobs`` runs per-file workers,
    ``devices`` shards each batch over N replicas (None = every local CUDA
    device, 1 = no sharding — the CLI's ``--devices``)."""
    from . import constants
    from .config import file as config_file
    from .config.types import Config, ModelType
    from .errors import BirdaError, ConfigValidation
    from .orchestrator import AnalyzeOptions, analyze_files

    if isinstance(inputs, (str, Path)):
        inputs = [inputs]
    _check_device(device)
    if precision not in ("fp32", "bf16", "mixed", "int8"):
        raise ConfigValidation(
            "precision must be fp32, bf16, mixed or int8 "
            f"(got '{precision}')")
    if range_unmatched not in (None, "keep", "drop"):
        raise ConfigValidation(
            f"range_unmatched must be keep or drop (got '{range_unmatched}')")
    _validate_bounds(
        min_confidence=min_confidence, overlap=overlap,
        batch_size=batch_size, lat=lat, lon=lon, week=week, month=month,
        day=day, day_of_year=day_of_year, range_threshold=range_threshold)

    if config is None:
        try:
            config = config_file.load_default_config()
        except BirdaError:
            config = Config()

    options = AnalyzeOptions(
        inputs=[Path(p) for p in inputs],
        model=model,
        model_path=Path(model_path) if model_path else None,
        labels_path=Path(labels_path) if labels_path else None,
        model_type=ModelType(model_type) if model_type else None,
        bat=bat,
        formats=[],
        output_dir=None,
        min_confidence=min_confidence,
        overlap=overlap,
        batch_size=batch_size,
        force=force,
        fail_fast=fail_fast,
        device_flags={} if device == "auto" else {device: True},
        lat=lat,
        lon=lon,
        week=week,
        month=month,
        day=day,
        day_of_year=day_of_year,
        range_threshold=range_threshold,
        rerank=rerank,
        range_unmatched=range_unmatched,
        slist=Path(slist) if slist else None,
        region_labels=Path(region_labels) if region_labels else None,
        jobs=jobs,
        decode_workers=decode_workers,
        devices=devices,
        top_k=top_k if top_k is not None else constants.DEFAULT_TOP_K,
        precision=precision,
        stream_detections=True,
    )

    collector = _RunCollector()
    exit_code = analyze_files(options, config, reporter=collector)

    # Inputs the collector never heard about were dropped before the
    # pipeline (missing path, unsupported extension).
    files = list(collector.by_file.values())
    for p in options.inputs:
        if str(p) in collector.by_file or p.is_dir():
            continue
        if not p.exists():
            files.append(FileResult(path=p, error="input path does not exist"))
        elif p.is_file():
            files.append(FileResult(path=p,
                                    error="not a supported audio file"))
    return AnalyzeResult(files=files, exit_code=exit_code,
                         backend=collector.backend,
                         summary=collector.summary,
                         precision=collector.precision,
                         range_filter=collector.range_filter)


@dataclass
class SpeciesEntry:
    """One geomodel range-list entry."""

    scientific_name: str
    common_name: str
    score: float

    @property
    def label(self) -> str:
        if not self.common_name:
            return self.scientific_name
        return f"{self.scientific_name}_{self.common_name}"


def species(
    lat: float,
    lon: float,
    *,
    week: Optional[int] = None,
    month: Optional[int] = None,
    day: Optional[int] = None,
    threshold: Optional[float] = None,
    sort: str = "freq",
    model: Optional[str] = None,
    geomodel_path: Optional[Path | str] = None,
    geomodel_labels_path: Optional[Path | str] = None,
    device: str = "auto",
) -> list[SpeciesEntry]:
    """Species expected at a location/time per the geomodel, the
    programmatic face of the ``species`` command (entries in memory, no file
    written). Provide ``week`` (48-week BirdNET calendar) or ``month`` +
    ``day``. The geomodel runs on ``device``: ``auto`` (the card, failing
    without one), ``cuda``/``gpu`` or ``cpu``."""
    from .cli.species import compute_species_list, split_species_label
    from .errors import ConfigValidation
    from .inference.range_filter import query_device

    _check_device(device)
    if week is None and (month is None or day is None):
        raise ConfigValidation("provide week, or month with day")
    if (geomodel_path is None) != (geomodel_labels_path is None):
        raise ConfigValidation(
            "geomodel_path and geomodel_labels_path must be given together")
    _validate_bounds(lat=lat, lon=lon, week=week, month=month, day=day,
                     threshold=threshold)
    with query_device(device):
        result = compute_species_list(
            lat=lat, lon=lon, week=week, month=month, day=day,
            threshold=threshold, sort=sort, model_name=model,
            geomodel_path=Path(geomodel_path) if geomodel_path else None,
            geomodel_labels_path=(
                Path(geomodel_labels_path) if geomodel_labels_path else None),
        )
    out = []
    for label, score in result.entries:
        sci, common = split_species_label(label)
        out.append(SpeciesEntry(sci, common, float(score)))
    return out


def clip(
    files: Sequence[Path | str],
    output: Path | str,
    *,
    audio_dir: Optional[Path | str] = None,
    base_dir: Optional[Path | str] = None,
    pre: Optional[float] = None,
    post: Optional[float] = None,
    min_confidence: float = 0.0,
    species: Optional[str] = None,
    start: Optional[float] = None,
    end: Optional[float] = None,
):
    """Extract audio clips from detection CSVs (or directly from audio
    files with ``start``/``end``) — the programmatic face of
    ``birda clip``. Returns the :class:`~birda_tpu_torch.clipper.command.ClipSummary`
    (total_clips, processed_files, per-clip entries, failures)."""
    from .clipper.command import ClipArgs, execute
    from .constants import clipper as clip_consts

    args = ClipArgs(
        files=[Path(f) for f in files],
        output=Path(output),
        audio=Path(audio_dir) if audio_dir else None,
        base_dir=Path(base_dir) if base_dir else None,
        pre=pre if pre is not None else clip_consts.DEFAULT_PRE_PADDING,
        post=post if post is not None else clip_consts.DEFAULT_POST_PADDING,
        confidence=min_confidence,
        species=species,
        start=start,
        end=end,
    )
    return execute(args)
