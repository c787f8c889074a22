"""Detection file parsing (reference ``src/clipper/parser.rs``).

Parses birda CSV detection files. Rows with non-finite start/end/confidence
are *skipped* with capped warnings (failing the file would cost every good
row beside the bad one); ``end <= start`` keeps its hard-error contract.
"""

from __future__ import annotations

import csv
import logging
import math
from dataclasses import dataclass
from pathlib import Path

from ..constants import clipper as clip_consts
from ..errors import DetectionParseFailed, InvalidDetectionFormat, InvalidTimeRange

logger = logging.getLogger(__name__)

_REQUIRED = ("Start (s)", "End (s)", "Scientific name", "Common name", "Confidence")

# Largest finite f32; confidences past this overflow the reference's f32
# field to infinity and are skipped (parser.rs:41 + its 1e40 overflow test).
_F32_MAX = 3.4028235e38


@dataclass
class ParsedDetection:
    start: float
    end: float
    scientific_name: str
    common_name: str
    confidence: float


def parse_detection_file(path: Path | str) -> list[ParsedDetection]:
    path = Path(path)
    try:
        f = open(path, newline="", encoding="utf-8-sig")
    except OSError as e:
        raise DetectionParseFailed(str(path), str(e)) from e

    detections: list[ParsedDetection] = []
    skipped = 0
    with f:
        reader = csv.DictReader(f, skipinitialspace=True)
        if reader.fieldnames is None:
            # A fully empty file is a legitimate zero-detection input, not a
            # format error (reference parser.rs test_empty_file_returns_empty_vec:
            # the csv crate yields no headers and no records).
            return []
        if not set(_REQUIRED) <= {n.strip() for n in reader.fieldnames}:
            raise InvalidDetectionFormat(
                f"{path}: missing required columns {_REQUIRED}"
            )
        field_map = {n.strip(): n for n in reader.fieldnames}
        for line_num, row in enumerate(reader, start=2):
            try:
                start = float(row[field_map["Start (s)"]])
                end = float(row[field_map["End (s)"]])
                confidence = float(row[field_map["Confidence"]])
                scientific = (row[field_map["Scientific name"]] or "").strip()
                common = (row[field_map["Common name"]] or "").strip()
            except (TypeError, ValueError, KeyError) as e:
                raise InvalidDetectionFormat(f"line {line_num}: {e}") from e

            if not (math.isfinite(start) and math.isfinite(end)):
                skipped += 1
                if skipped <= clip_consts.MAX_SKIPPED_ROW_WARNINGS:
                    logger.warning(
                        "line %d: skipping detection, start (%s) and end (%s) "
                        "must both be finite", line_num, start, end,
                    )
                continue
            # The reference stores confidence as f32 (parser.rs:41): an
            # ordinary decimal like 1e40 overflows f32 to +inf on the way in
            # and the row is skipped — kept in f64 it would compare greater
            # than every threshold downstream.
            if math.isfinite(confidence) and abs(confidence) > _F32_MAX:
                confidence = math.inf if confidence > 0 else -math.inf
            if not math.isfinite(confidence):
                skipped += 1
                if skipped <= clip_consts.MAX_SKIPPED_ROW_WARNINGS:
                    logger.warning(
                        "line %d: skipping detection, confidence (%s) must be "
                        "finite", line_num, confidence,
                    )
                continue
            if end <= start:
                raise InvalidTimeRange(
                    f"line {line_num}: end ({end}) must be greater than "
                    f"start ({start})"
                )
            detections.append(
                ParsedDetection(start, end, scientific, common, confidence)
            )
    if skipped > clip_consts.MAX_SKIPPED_ROW_WARNINGS:
        logger.warning("%d further malformed rows skipped",
                       skipped - clip_consts.MAX_SKIPPED_ROW_WARNINGS)
    return detections
