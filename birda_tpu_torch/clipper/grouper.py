"""Detection grouping (reference ``src/clipper/grouper.rs``).

Detections of the same species whose padded ranges overlap merge into one
clip region; a NaN-start defensive ``max(0.0)`` clamps the padded start to
the file; groups come back sorted by start time.
"""

from __future__ import annotations

from dataclasses import dataclass

from .parser import ParsedDetection


@dataclass
class DetectionGroup:
    scientific_name: str
    common_name: str
    start: float
    end: float
    max_confidence: float
    detection_count: int


def group_detections(
    detections: list[ParsedDetection],
    pre_padding: float,
    post_padding: float,
) -> list[DetectionGroup]:
    by_species: dict[str, list[ParsedDetection]] = {}
    for d in detections:
        by_species.setdefault(d.scientific_name, []).append(d)

    groups: list[DetectionGroup] = []
    for scientific_name, dets in by_species.items():
        dets.sort(key=lambda d: d.start)
        common_name = dets[0].common_name

        merged: list[list] = []  # [start, end, max_conf, count]
        for d in dets:
            start = max(d.start - pre_padding, 0.0)
            end = d.end + post_padding
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
                merged[-1][2] = max(merged[-1][2], d.confidence)
                merged[-1][3] += 1
            else:
                merged.append([start, end, d.confidence, 1])

        for start, end, conf, count in merged:
            groups.append(
                DetectionGroup(
                    scientific_name=scientific_name,
                    common_name=common_name,
                    start=start,
                    end=end,
                    max_confidence=conf,
                    detection_count=count,
                )
            )

    groups.sort(key=lambda g: g.start)
    return groups
