"""NDJSON event envelope, spec version 1.1.

GUI-compatible port of the reference protocol
(``src/output/json_envelope.rs``): every CLI output event is wrapped in
``{spec_version, timestamp, event, payload}``, with snake_case event names,
a ``result_type`` discriminator for command results, and Option fields
omitted (never null). Field names and shapes follow the reference exactly —
the envelope is part of the public API surface.
"""

from __future__ import annotations

import datetime
import json
from enum import Enum
from typing import Optional

SPEC_VERSION = "1.1"


class EventType(str, Enum):
    PIPELINE_STARTED = "pipeline_started"
    FILE_STARTED = "file_started"
    PROGRESS = "progress"
    FILE_COMPLETED = "file_completed"
    PIPELINE_COMPLETED = "pipeline_completed"
    RESULT = "result"
    ERROR = "error"
    CANCELLED = "cancelled"
    DETECTIONS = "detections"


class ResultType(str, Enum):
    ANALYSIS = "analysis"
    MODEL_LIST = "model_list"
    MODEL_INFO = "model_info"
    CLIP_EXTRACTION = "clip_extraction"
    SPECIES_LIST = "species_list"
    CONFIG = "config"
    PROVIDERS = "providers"
    VERSION = "version"
    AVAILABLE_MODELS = "available_models"
    MODEL_CHECK = "model_check"
    CONFIG_PATH = "config_path"
    MODEL_REMOVED = "model_removed"
    MODEL_INSTALLED = "model_installed"


class ErrorSeverity(str, Enum):
    FATAL = "fatal"
    WARNING = "warning"


class FileStatus(str, Enum):
    PROCESSED = "processed"
    FAILED = "failed"
    SKIPPED = "skipped"
    LOCKED = "locked"


class PipelineStatus(str, Enum):
    SUCCESS = "success"
    PARTIAL_SUCCESS = "partial_success"
    FAILED = "failed"


class CancelReason(str, Enum):
    USER_INTERRUPT = "user_interrupt"
    TIMEOUT = "timeout"


def _clean(d: dict) -> dict:
    """Drop None values (serde ``skip_serializing_if = Option::is_none``)."""
    return {k: v for k, v in d.items() if v is not None}


def envelope(event: EventType, payload: dict) -> dict:
    return {
        "spec_version": SPEC_VERSION,
        "timestamp": datetime.datetime.now(datetime.timezone.utc)
        .isoformat()
        .replace("+00:00", "Z"),
        "event": event.value,
        "payload": payload,
    }


def envelope_line(event: EventType, payload: dict) -> str:
    """One NDJSON line."""
    return json.dumps(envelope(event, payload), separators=(",", ":"))


# ---------------------------------------------------------------------------
# Payload builders (field names match the reference structs)
# ---------------------------------------------------------------------------

def pipeline_started_payload(
    total_files: int,
    model: str,
    min_confidence: float,
    execution_provider: dict,
    range_filter: Optional[dict] = None,
    precision: Optional[dict] = None,
    sharding: Optional[dict] = None,
) -> dict:
    # ``precision`` and ``sharding`` are additive extension fields (absent
    # on the default fp32/single-device path, so the spec-1.1 wire format
    # golden is unchanged): reduced-precision runs report their mode and,
    # for int8, the quantization counts the way execution_provider reports
    # requested/actual; sharded runs report the data-parallel mesh geometry
    # (device count + axis) the batch is split over.
    return _clean({
        "total_files": total_files,
        "model": model,
        "min_confidence": min_confidence,
        "execution_provider": execution_provider,
        "range_filter": range_filter,
        "precision": precision,
        "sharding": sharding,
    })


def file_started_payload(
    file: str, index: int, estimated_segments: int,
    duration_seconds: Optional[float] = None,
) -> dict:
    return _clean({
        "file": file,
        "index": index,
        "estimated_segments": estimated_segments,
        "duration_seconds": duration_seconds,
    })


def batch_progress(current: int, total: int) -> dict:
    return {
        "current": current,
        "total": total,
        "percent": 100.0 * current / total if total else 0.0,
    }


def file_progress(path: str, segments_done: int, segments_total: int) -> dict:
    return {
        "path": path,
        "segments_done": segments_done,
        "segments_total": segments_total,
        "percent": 100.0 * segments_done / segments_total if segments_total else 0.0,
    }


def progress_payload(
    batch: Optional[dict] = None,
    file: Optional[dict] = None,
    download: Optional[dict] = None,
) -> dict:
    return _clean({"batch": batch, "file": file, "download": download})


def download_progress(operation: str, model: str, file: str,
                      downloaded_bytes: int, total_bytes: int) -> dict:
    return {
        "operation": operation,
        "model": model,
        "file": file,
        "downloaded_bytes": downloaded_bytes,
        "total_bytes": total_bytes,
        "percent": 100.0 * downloaded_bytes / total_bytes if total_bytes else 0.0,
    }


def file_completed_payload(
    file: str,
    status: FileStatus,
    detections: Optional[int] = None,
    duration_ms: Optional[int] = None,
    error: Optional[dict] = None,
) -> dict:
    return _clean({
        "file": file,
        "status": status.value,
        "detections": detections,
        "duration_ms": duration_ms,
        "error": error,
    })


def pipeline_completed_payload(
    status: PipelineStatus,
    files_processed: int,
    files_failed: int,
    files_skipped: int,
    total_detections: int,
    total_segments: int,
    duration_ms: int,
    realtime_factor: float,
) -> dict:
    return {
        "status": status.value,
        "files_processed": files_processed,
        "files_failed": files_failed,
        "files_skipped": files_skipped,
        "total_detections": total_detections,
        "total_segments": total_segments,
        "duration_ms": duration_ms,
        "realtime_factor": realtime_factor,
    }


def error_payload(code: str, severity: ErrorSeverity, message: str,
                  suggestion: Optional[str] = None) -> dict:
    return _clean({
        "code": code,
        "severity": severity.value,
        "message": message,
        "suggestion": suggestion,
    })


def cancelled_payload(reason: CancelReason, files_completed: int,
                      files_total: int) -> dict:
    return {
        "reason": reason.value,
        "files_completed": files_completed,
        "files_total": files_total,
    }


def detection_info(d) -> dict:
    """DetectionInfo from a Detection (full label + split names)."""
    return {
        # Reference-faithful reconstruction (json_envelope.rs:418) — for an
        # underscore-less label both halves are the label, so "Dog" emits
        # as "Dog_Dog" there too; consumers key on the reference format.
        "species": f"{d.scientific_name}_{d.common_name}",
        "common_name": d.common_name,
        "scientific_name": d.scientific_name,
        "confidence": d.confidence,
        "start_time": d.start_time,
        "end_time": d.end_time,
    }


def detections_payload(file: str, detections: list,
                       bsg: Optional[dict] = None) -> dict:
    return _clean({
        "file": file,
        "detections": [detection_info(d) for d in detections],
        "bsg": bsg,
    })


def bsg_metadata(calibration_applied: bool, sdm_applied: bool,
                 latitude: Optional[float] = None,
                 longitude: Optional[float] = None,
                 day_of_year: Optional[int] = None) -> dict:
    return _clean({
        "calibration_applied": calibration_applied,
        "sdm_applied": sdm_applied,
        "latitude": latitude,
        "longitude": longitude,
        "day_of_year": day_of_year,
    })


def result_payload(result_type: ResultType, **fields) -> dict:
    return {"result_type": result_type.value, **_clean(fields)}


# ---------------------------------------------------------------------------
# Typed result payload builders — one per ResultType the reference emits
# (``json_envelope.rs:163-742``: 12 payload structs; ``analysis`` is an
# enum-only discriminator there too). CLI commands MUST build their result
# envelopes through these, so the golden pin in
# ``tests/golden/results.ndjson`` catches any GUI-facing drift.
# ---------------------------------------------------------------------------

def model_entry(id: str, model_type: str, is_default: bool,
                path: Optional[str] = None,
                labels_path: Optional[str] = None) -> dict:
    return _clean({
        "id": id, "model_type": model_type, "is_default": is_default,
        "path": path, "labels_path": labels_path,
    })


def model_list_payload(models: list[dict]) -> dict:
    """``ModelListPayload`` (json_envelope.rs:402); entries sorted by id
    for deterministic output (lib.rs:1624)."""
    return result_payload(
        ResultType.MODEL_LIST, models=sorted(models, key=lambda m: m["id"])
    )


def model_details(id: str, model_type: str, source: str,
                  path: Optional[str] = None,
                  labels_path: Optional[str] = None) -> dict:
    """``ModelDetails``: source is "configured" or "registry"."""
    return _clean({
        "id": id, "model_type": model_type, "path": path,
        "labels_path": labels_path, "source": source,
    })


def model_info_payload(model: dict) -> dict:
    return result_payload(ResultType.MODEL_INFO, model=model)


def provider_info(id: str, name: str, description: str) -> dict:
    return {"id": id, "name": name, "description": description}


def providers_payload(providers: list[dict]) -> dict:
    return result_payload(ResultType.PROVIDERS, providers=providers)


def config_payload(config_path: str, config: dict) -> dict:
    """``ConfigPayload``: the file path plus its parsed contents."""
    return result_payload(
        ResultType.CONFIG, config_path=config_path, config=config
    )


def config_path_payload(config_path: str, exists: bool) -> dict:
    return result_payload(
        ResultType.CONFIG_PATH, config_path=config_path, exists=exists
    )


def available_model_entry(id: str, name: str, description: str, vendor: str,
                          version: str, model_type: str, recommended: bool,
                          license: str, commercial_use: bool) -> dict:
    return {
        "id": id, "name": name, "description": description,
        "vendor": vendor, "version": version, "model_type": model_type,
        "recommended": recommended, "license": license,
        "commercial_use": commercial_use,
    }


def available_models_payload(
    models: list[dict], available_range_filter: Optional[dict] = None,
) -> dict:
    """``AvailableModelsPayload``: the geomodel rides its own field — it is
    not ``-m``-selectable, so folding it into ``models`` would offer a
    picker entry that fails on use (json_envelope.rs:488-511)."""
    return result_payload(
        ResultType.AVAILABLE_MODELS, models=models,
        available_range_filter=available_range_filter,
    )


def available_range_filter_entry(id: str, name: str, version: str,
                                 vendor: str, license: str,
                                 commercial_use: bool, share_alike: bool,
                                 species_count: int,
                                 size_bytes: Optional[int] = None) -> dict:
    return _clean({
        "id": id, "name": name, "version": version, "vendor": vendor,
        "license": license, "commercial_use": commercial_use,
        "share_alike": share_alike, "species_count": species_count,
        "size_bytes": size_bytes,
    })


def model_check_entry(id: str, valid: bool, error: Optional[str] = None,
                      unsupported: Optional[list[str]] = None) -> dict:
    """``ModelCheckEntry`` plus the additive ``unsupported`` list (our
    whole-graph ONNX preflight findings; absent when not applicable)."""
    return _clean({
        "id": id, "valid": valid, "error": error,
        "unsupported": unsupported or None,
    })


def geomodel_info(version: str, installed: bool, species_count: int,
                  model_path: Optional[str] = None,
                  labels_path: Optional[str] = None,
                  obsolete_files: Optional[list[str]] = None) -> dict:
    return _clean({
        "version": version, "installed": installed,
        "species_count": species_count, "model_path": model_path,
        "labels_path": labels_path,
        "obsolete_files": obsolete_files or None,
    })


def model_check_payload(models: list[dict], geomodel: Optional[dict] = None,
                        leftover_downloads: Optional[list[str]] = None) -> dict:
    return result_payload(
        ResultType.MODEL_CHECK, models=models, geomodel=geomodel,
        leftover_downloads=leftover_downloads or None,
    )


def model_removed_payload(id: str, purge_requested: bool,
                          new_default: Optional[str] = None) -> dict:
    # new_default carries no skip_serializing_if in the reference struct
    # (json_envelope.rs:633-643): it serializes as null when absent.
    return {
        "result_type": ResultType.MODEL_REMOVED.value,
        "id": id, "purge_requested": purge_requested,
        "new_default": new_default,
    }


def model_installed_payload(id: str, set_as_default: bool, model_path: str,
                            labels_path: str) -> dict:
    return result_payload(
        ResultType.MODEL_INSTALLED, id=id, set_as_default=set_as_default,
        model_path=model_path, labels_path=labels_path,
    )


def species_entry(scientific_name: str, common_name: str,
                  frequency: float) -> dict:
    return {"scientific_name": scientific_name, "common_name": common_name,
            "frequency": frequency}


def species_list_payload(lat: float, lon: float, week: int, threshold: float,
                         species: list[dict],
                         output_file: Optional[str] = None) -> dict:
    """``SpeciesListPayload``: entries inline; ``output_file`` omitted in
    pure-JSON mode where no file is written (species.rs:177-186)."""
    return result_payload(
        ResultType.SPECIES_LIST, lat=lat, lon=lon, week=week,
        threshold=threshold, species_count=len(species),
        output_file=output_file, species=species,
    )


def version_payload(version: str) -> dict:
    return result_payload(ResultType.VERSION, version=version)


def clip_extraction_entry(source_audio: str, scientific_name: str,
                          confidence: float, start_time: float,
                          end_time: float, output_file: str) -> dict:
    return {
        "source_audio": source_audio, "scientific_name": scientific_name,
        "confidence": confidence, "start_time": start_time,
        "end_time": end_time, "output_file": output_file,
    }


def clip_extraction_failure(file: str, error: str) -> dict:
    """``ClipExtractionFailure`` (json_envelope.rs:742-747)."""
    return {"file": file, "error": error}


def clip_extraction_payload(output_dir: str, total_clips: int,
                            total_files: int, clips: list[dict],
                            failed_files: Optional[list[dict]] = None) -> dict:
    """``ClipExtractionPayload``: ``failed_files`` omitted when empty so a
    consumer that never sees failures reads the pre-#319 shape."""
    return result_payload(
        ResultType.CLIP_EXTRACTION, output_dir=output_dir,
        total_clips=total_clips, total_files=total_files, clips=clips,
        failed_files=failed_files or None,
    )
