"""JSON result file writer (reference ``src/output/json.rs``).

One JSON document per audio file: source, timestamp, model, settings,
detections, and a summary (total detections, unique species by scientific
name, audio duration).
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Optional

from .types import Detection
from .writer import OutputWriter


class JsonResultWriter(OutputWriter):
    def __init__(
        self,
        path: Path | str,
        source_file: str,
        model: str,
        min_confidence: float,
        overlap: float,
        audio_duration: float,
        lat: Optional[float] = None,
        lon: Optional[float] = None,
        week: Optional[int] = None,
    ):
        self._path = Path(path)
        self._detections: list[Detection] = []
        self.source_file = source_file
        self.model = model
        self.min_confidence = min_confidence
        self.overlap = overlap
        self.audio_duration = audio_duration
        self.lat, self.lon, self.week = lat, lon, week

    def write_detection(self, d: Detection) -> None:
        self._detections.append(d)

    def finalize(self) -> None:
        settings = {
            "min_confidence": self.min_confidence,
            "overlap": self.overlap,
        }
        if self.lat is not None:
            settings["lat"] = self.lat
        if self.lon is not None:
            settings["lon"] = self.lon
        if self.week is not None:
            settings["week"] = self.week

        doc = {
            "source_file": self.source_file,
            "analysis_date": datetime.datetime.now(datetime.timezone.utc)
            .isoformat()
            .replace("+00:00", "Z"),
            "model": self.model,
            "settings": settings,
            "detections": [
                {
                    "start_time": d.start_time,
                    "end_time": d.end_time,
                    "scientific_name": d.scientific_name,
                    "common_name": d.common_name,
                    "confidence": d.confidence,
                }
                for d in self._detections
            ],
            "summary": {
                "total_detections": len(self._detections),
                "unique_species": len(
                    {d.scientific_name for d in self._detections}
                ),
                "audio_duration_seconds": self.audio_duration,
            },
        }
        with open(self._path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
