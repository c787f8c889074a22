"""Output type definitions (reference ``src/output/types.rs``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class DetectionMetadata:
    """Optional per-detection metadata carried into the writers."""

    lat: Optional[float] = None
    lon: Optional[float] = None
    week: Optional[int] = None
    model: Optional[str] = None
    overlap: Optional[float] = None
    sensitivity: Optional[float] = None
    min_conf: Optional[float] = None
    species_list: Optional[str] = None

    def to_json_dict(self) -> dict:
        """Serde-style dict: None fields are skipped."""
        return {k: v for k, v in self.__dict__.items() if v is not None}


@dataclass
class Detection:
    """A single detection (reference ``src/output/types.rs:8``)."""

    file_path: Path
    start_time: float
    end_time: float
    scientific_name: str
    common_name: str
    confidence: float
    metadata: DetectionMetadata = field(default_factory=DetectionMetadata)

    @classmethod
    def from_label(
        cls,
        label: str,
        confidence: float,
        start_time: float,
        end_time: float,
        file_path: Path | str,
    ) -> "Detection":
        """Parse a ``ScientificName_CommonName`` BirdNET label.

        A label with no underscore uses the whole string for both names
        (reference ``src/output/types.rs:58``).
        """
        idx = label.find("_")
        if idx < 0:
            scientific, common = label, label
        else:
            scientific, common = label[:idx], label[idx + 1 :]
        return cls(
            file_path=Path(file_path),
            start_time=start_time,
            end_time=end_time,
            scientific_name=scientific,
            common_name=common,
            confidence=confidence,
        )

    def sort_key(self) -> tuple:
        """Reference ordering: start time ascending, confidence descending
        (``src/pipeline/processor.rs:176-187``)."""
        return (self.start_time, -self.confidence)

    def to_json_dict(self) -> dict:
        d = {
            "file_path": str(self.file_path),
            "start_time": self.start_time,
            "end_time": self.end_time,
            "scientific_name": self.scientific_name,
            "common_name": self.common_name,
            "confidence": self.confidence,
            "metadata": self.metadata.to_json_dict(),
        }
        return d
