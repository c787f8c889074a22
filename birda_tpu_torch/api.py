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
orchestrator. ``device`` is ``auto``/``cpu``/``cuda``/``gpu``: ``auto``
(the default) and ``gpu`` run on the CUDA card and fail without one; only
``cpu`` runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

from .output.reporter import ProgressReporter
from .output.types import Detection

__all__ = ["analyze", "AnalyzeResult", "FileResult", "Detection"]


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
    #: selection counts) and the run summary the pipeline reported.
    backend: Optional[dict] = None
    summary: Optional[dict] = None
    precision: Optional[dict] = None

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

    def pipeline_started(self, total_files, model, min_confidence,
                         execution_provider, range_filter=None,
                         precision=None, sharding=None):
        self.backend = execution_provider
        self.precision = precision

    def pipeline_completed(self, summary):
        self.summary = summary


_DEVICES = ("auto", "cpu", "cuda", "gpu")


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
    package's ``birda_tpu.api.analyze``; options this port does not run yet
    raise a typed ``ClassifierBuild`` error."""
    from . import constants
    from .config import file as config_file
    from .config.types import Config, ModelType
    from .errors import BirdaError, ConfigValidation
    from .orchestrator import AnalyzeOptions, analyze_files

    if isinstance(inputs, (str, Path)):
        inputs = [inputs]
    if device not in _DEVICES:
        raise ConfigValidation(
            f"device must be one of {', '.join(_DEVICES)} (got '{device}')")
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
                         precision=collector.precision)
