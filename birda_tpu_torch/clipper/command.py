"""Clip command execution (reference ``src/clipper/command.rs``).

Two modes: direct extraction (``--start/--end``) and CSV mode over detection
files. Per-file failures are warnings and the batch keeps going; the batch
fails only when *no* file produced anything (the #319 distinction between
"some recordings had no detections" and "every file was rejected"). Float
arguments are re-checked at this library boundary because NaN fails quietly
at every later stage.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..constants import clipper as clip_consts
from ..constants import confidence as conf_consts
from ..constants import output_extensions
from ..errors import (
    BirdaError,
    ClipBatchAllFailed,
    InvalidConfidence,
    InvalidPadding,
    SourceAudioNotFound,
)
from .extractor import ClipExtractor, validate_time_range
from .grouper import DetectionGroup, group_detections
from .parser import parse_detection_file
from .writer import WavWriter

logger = logging.getLogger(__name__)

CLIP_FILE_FAILED_CODE = "clip_file_failed"

_OUTPUT_SUFFIXES = (
    output_extensions.CSV,
    output_extensions.RAVEN,
    output_extensions.AUDACITY,
    output_extensions.KALEIDOSCOPE,
    output_extensions.JSON,
    output_extensions.PARQUET,
)


@dataclass
class ClipArgs:
    files: list[Path]
    output: Path = Path(clip_consts.DEFAULT_OUTPUT_DIR)
    audio: Optional[Path] = None
    base_dir: Optional[Path] = None
    pre: float = clip_consts.DEFAULT_PRE_PADDING
    post: float = clip_consts.DEFAULT_POST_PADDING
    confidence: float = 0.0
    species: Optional[str] = None
    start: Optional[float] = None
    end: Optional[float] = None


@dataclass
class ClipSummary:
    total_clips: int = 0
    processed_files: int = 0
    clips: list[dict] = field(default_factory=list)
    failures: list[dict] = field(default_factory=list)


def validate_float_args(args: ClipArgs) -> None:
    """NaN/∞ re-checks at the library boundary (reference ``command.rs:41``).
    Negated-range spelling so NaN is rejected on both halves."""
    for value in (args.pre, args.post):
        if not (0.0 <= value <= clip_consts.MAX_PADDING):
            raise InvalidPadding(value)
    if not (conf_consts.MIN <= args.confidence <= conf_consts.MAX):
        raise InvalidConfidence(args.confidence)


def find_source_audio(
    detection_file: Path,
    explicit_audio: Optional[Path] = None,
    base_dir: Optional[Path] = None,
) -> Path:
    """Resolution order: explicit --audio > inferred name in --base-dir >
    inferred name beside the detection file (reference ``command.rs:390``)."""
    if explicit_audio is not None:
        if explicit_audio.exists():
            return explicit_audio
        # Name the path that is actually missing — pointing at the
        # detection file (which exists) sends the user the wrong way.
        raise SourceAudioNotFound(str(explicit_audio))

    file_name = detection_file.name
    search_dir = base_dir if base_dir is not None else (
        detection_file.parent if str(detection_file.parent) else Path(".")
    )

    for suffix in _OUTPUT_SUFFIXES:
        if file_name.endswith(suffix):
            base = file_name[: -len(suffix)]
            candidate = search_dir / base
            if candidate.exists():
                return candidate

    stem = detection_file.stem
    for s in (clip_consts.BIRDNET_RESULTS_SUFFIX, clip_consts.BIRDNET_SUFFIX):
        if stem.endswith(s):
            stem = stem[: -len(s)]
            break
    for ext in clip_consts.AUDIO_EXTENSIONS:
        if stem.endswith(f".{ext}"):
            stem = stem[: -(len(ext) + 1)]
            break

    if ".." in stem or "/" in stem or "\\" in stem:
        raise SourceAudioNotFound(str(detection_file))

    for ext in clip_consts.AUDIO_EXTENSIONS:
        candidate = search_dir / f"{stem}.{ext}"
        if candidate.exists():
            return candidate
    raise SourceAudioNotFound(str(detection_file))


def execute(args: ClipArgs, reporter=None) -> ClipSummary:
    """Run the batch and return its summary.

    ``reporter`` streams one ``error`` event per failed file AS IT
    HAPPENS — pass it only in ndjson mode (reference command.rs:110-125:
    plain ``json`` output is a single document, and a stream of error
    objects ahead of it would make stdout N+1 top-level objects; there
    the same failures ride the result's ``failed_files`` instead).

    A total failure raises :class:`ClipBatchAllFailed` with the summary
    attached as ``.summary``, so structured modes can still emit the one
    result document (with every failure listed) before exiting non-zero.
    """
    validate_float_args(args)
    if args.start is not None and args.end is not None:
        return _execute_direct(args, reporter)
    return _execute_csv_mode(args, reporter)


def _report_failure(reporter, file, message) -> None:
    if reporter is not None:
        from ..output.json_envelope import ErrorSeverity

        reporter.error(CLIP_FILE_FAILED_CODE, ErrorSeverity.WARNING,
                       f"failed to process {file}: {message}")


def _execute_direct(args: ClipArgs, reporter=None) -> ClipSummary:
    validate_time_range(args.start, args.end)
    extractor = ClipExtractor()
    writer = WavWriter(args.output)
    summary = ClipSummary()
    # Padding applies in direct mode too, and the generic clip is named
    # after the RAW requested range (reference command.rs:190-198:
    # "detection_5-10" even when the padded extraction is 4..11).
    padded_start = max(args.start - args.pre, 0.0)
    padded_end = args.end + args.post
    default_name = f"detection_{args.start:.0f}-{args.end:.0f}"
    for audio_file in args.files:
        group = DetectionGroup(
            scientific_name=args.species or default_name,
            common_name=args.species or "",
            start=padded_start, end=padded_end,
            max_confidence=1.0, detection_count=1,
        )
        # Per-file isolation, same as CSV mode (the module contract: one
        # bad file is a warning, the batch keeps going and fails only if
        # ALL fail). The reference's direct mode takes a single --audio
        # and errors hard; multi-file direct extraction is our extension,
        # so it follows the batch semantics.
        try:
            clip = extractor.extract_clip(audio_file, group)
            path = writer.write_clip(
                clip.samples, clip.sample_rate, group.scientific_name,
                group.max_confidence, group.start, group.end,
            )
        except BirdaError as e:
            logger.warning("Failed to clip %s: %s", audio_file, e)
            _report_failure(reporter, audio_file, e)
            summary.failures.append({
                "file": str(audio_file),
                "code": CLIP_FILE_FAILED_CODE,
                "message": str(e),
            })
            continue
        summary.total_clips += 1
        summary.processed_files += 1
        summary.clips.append({
            "species": group.scientific_name,
            "path": str(path),
            "start": group.start,
            "end": group.end,
            "source_audio": str(audio_file),
            "confidence": group.max_confidence,
        })
    _raise_if_total_failure(summary)
    return summary


def _raise_if_total_failure(summary: ClipSummary) -> None:
    """A total failure is a batch that had files and NONE produced
    anything; an empty batch or an all-below-threshold run is a
    legitimate zero-clip run (reference command.rs:134-139). The summary
    rides the exception so structured modes can still emit the single
    result document listing every failure before exiting non-zero."""
    if summary.processed_files == 0 and summary.failures:
        e = ClipBatchAllFailed()
        e.summary = summary
        raise e


def _execute_csv_mode(args: ClipArgs, reporter=None) -> ClipSummary:
    extractor = ClipExtractor()
    writer = WavWriter(args.output)
    summary = ClipSummary()

    for detection_file in args.files:
        try:
            count, clips = _process_detection_file(
                detection_file, args, extractor, writer
            )
            summary.total_clips += count
            summary.processed_files += 1
            summary.clips.extend(clips)
        except BirdaError as e:
            logger.warning("Failed to process %s: %s", detection_file, e)
            _report_failure(reporter, detection_file, e)
            summary.failures.append({
                "file": str(detection_file),
                "code": CLIP_FILE_FAILED_CODE,
                "message": str(e),
            })

    _raise_if_total_failure(summary)
    return summary


def _process_detection_file(
    detection_file: Path, args: ClipArgs, extractor: ClipExtractor,
    writer: WavWriter,
) -> tuple[int, list[dict]]:
    detections = parse_detection_file(detection_file)
    detections = [d for d in detections if d.confidence >= args.confidence]
    if args.species is not None:
        want = args.species.lower()
        detections = [
            d for d in detections
            if want in d.scientific_name.lower() or want in d.common_name.lower()
        ]
    if not detections:
        return 0, []

    audio_path = find_source_audio(detection_file, args.audio, args.base_dir)
    groups = group_detections(detections, args.pre, args.post)

    clips = []
    for group in groups:
        try:
            clip = extractor.extract_clip(audio_path, group)
            path = writer.write_clip(
                clip.samples, clip.sample_rate, group.scientific_name,
                group.max_confidence, group.start, group.end,
            )
            clips.append({
                "species": group.scientific_name,
                "path": str(path),
                "start": group.start,
                "end": group.end,
                "source_audio": str(audio_path),
                "confidence": group.max_confidence,
            })
        except BirdaError as e:
            logger.warning("clip %s %.1f-%.1f failed: %s",
                           group.scientific_name, group.start, group.end, e)
    # The file HAD detections to extract but every one failed: that is a
    # failed file, not the legitimate zero-clip result of an
    # all-below-threshold file (which returned early above). Reporting it
    # as a failure is what lets the batch exit non-zero when nothing was
    # produced (#319, reference command.rs:367-379).
    if groups and not clips:
        from ..errors import ClipFileProducedNothing

        raise ClipFileProducedNothing(str(detection_file), len(groups))
    return len(clips), clips
