"""Bat detection configuration (reference ``src/config/bat.rs``).

Eleven regional BattyBirdNET heads over BirdNET v2.4 embeddings; filename
scheme ``BattyBirdNET-<Region>-256kHz_fp32.onnx`` + ``..._Labels.txt``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from pathlib import Path

from ..errors import LabelsFileNotFound, ModelFileNotFound


class BatRegion(str, Enum):
    BAVARIA = "bavaria"
    BAVARIA_HIGH = "bavaria-high"
    EU = "eu"
    SCOTLAND = "scotland"
    SOUTH_WALES = "south-wales"
    SWEDEN = "sweden"
    UK = "uk"
    USA = "usa"
    USA_EAST = "usa-east"
    USA_EAST_HIGH = "usa-east-high"
    USA_WEST = "usa-west"

    @property
    def model_stem(self) -> str:
        return _STEMS[self]

    @property
    def model_filename(self) -> str:
        return f"{self.model_stem}_fp32.onnx"

    @property
    def labels_filename(self) -> str:
        return f"{self.model_stem}_Labels.txt"


_STEMS = {
    BatRegion.BAVARIA: "BattyBirdNET-Bavaria-256kHz",
    BatRegion.BAVARIA_HIGH: "BattyBirdNET-Bavaria-256kHz-high",
    BatRegion.EU: "BattyBirdNET-EU-256kHz",
    BatRegion.SCOTLAND: "BattyBirdNET-Scotland-256kHz",
    BatRegion.SOUTH_WALES: "BattyBirdNET-SouthWales-256kHz",
    BatRegion.SWEDEN: "BattyBirdNET-Sweden-256kHz",
    BatRegion.UK: "BattyBirdNET-UK-256kHz",
    BatRegion.USA: "BattyBirdNET-USA-256kHz",
    BatRegion.USA_EAST: "BattyBirdNET-USA-EAST-256kHz",
    BatRegion.USA_EAST_HIGH: "BattyBirdNET-USA-EAST-256kHz-high",
    BatRegion.USA_WEST: "BattyBirdNET-USA-WEST-256kHz",
}


@dataclass
class BatConfig:
    """Resolved bat detection configuration."""

    region: BatRegion
    classifier_path: Path
    labels_path: Path

    @classmethod
    def resolve(cls, region: BatRegion, bat_models_dir: Path | str) -> "BatConfig":
        bat_models_dir = Path(bat_models_dir)
        classifier_path = bat_models_dir / region.model_filename
        labels_path = bat_models_dir / region.labels_filename
        if not classifier_path.exists():
            raise ModelFileNotFound(str(classifier_path))
        if not labels_path.exists():
            raise LabelsFileNotFound(str(labels_path))
        return cls(region=region, classifier_path=classifier_path,
                   labels_path=labels_path)
