"""Configuration type definitions (reference ``src/config/types.rs``).

TOML document model with serde-default semantics: every section and field is
optional in the file; deprecated keys (``meta_model``, ``combined_prefix``)
are parsed so a stale key can be *reported*, but never serialized back.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Optional

from ..constants import DEFAULT_MIN_CONFIDENCE, DEFAULT_OVERLAP, range_filter
from ..inference.geomodel_filter import UnmatchedPolicy
from ..pipeline.coordinator import OutputFormat


class ModelType(str, Enum):
    BIRDNET_V24 = "birdnet-v24"
    BIRDNET_V30 = "birdnet-v30"
    PERCH_V2 = "perch-v2"
    BSG_FINLAND = "bsg-finland"


class InferenceDevice(str, Enum):
    """Accelerator request. The reference's 13 GPU provider names collapse to
    the TPU backend set; ``gpu`` is kept as a compatibility alias for the
    accelerator-preferring mode (warn on CPU fallback)."""

    AUTO = "auto"
    CPU = "cpu"
    TPU = "tpu"
    GPU = "gpu"  # compatibility alias: accelerator preferred, warn on fallback


class OutputMode(str, Enum):
    HUMAN = "human"
    JSON = "json"
    NDJSON = "ndjson"

    @property
    def is_structured(self) -> bool:
        return self in (OutputMode.JSON, OutputMode.NDJSON)


@dataclass
class ModelConfig:
    path: Path
    labels: Path
    model_type: ModelType
    #: Deprecated (parsed, reported, never written back).
    meta_model: Optional[Path] = None
    bsg_calibration: Optional[Path] = None
    bsg_migration: Optional[Path] = None
    bsg_distribution_maps: Optional[Path] = None
    registry_id: Optional[str] = None
    installed_version: Optional[str] = None
    installed_build: Optional[int] = None
    region: Optional[str] = None
    variant: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        return cls(
            path=Path(d.get("path", "")),
            labels=Path(d.get("labels", "")),
            model_type=ModelType(d.get("type", "birdnet-v24")),
            meta_model=Path(d["meta_model"]) if "meta_model" in d else None,
            bsg_calibration=Path(d["bsg_calibration"]) if d.get("bsg_calibration") else None,
            bsg_migration=Path(d["bsg_migration"]) if d.get("bsg_migration") else None,
            bsg_distribution_maps=(
                Path(d["bsg_distribution_maps"]) if d.get("bsg_distribution_maps") else None
            ),
            registry_id=d.get("registry_id"),
            installed_version=d.get("installed_version"),
            installed_build=d.get("installed_build"),
            region=d.get("region"),
            variant=d.get("variant"),
        )

    def to_dict(self) -> dict:
        d = {
            "path": str(self.path),
            "labels": str(self.labels),
            "type": self.model_type.value,
        }
        # meta_model deliberately never re-serialized.
        for key in ("bsg_calibration", "bsg_migration", "bsg_distribution_maps"):
            v = getattr(self, key)
            if v is not None:
                d[key] = str(v)
        for key in ("registry_id", "installed_version", "installed_build",
                    "region", "variant"):
            v = getattr(self, key)
            if v is not None:
                d[key] = v
        return d


@dataclass
class CsvColumnsConfig:
    include: list[str] = field(default_factory=list)


@dataclass
class DefaultsConfig:
    model: Optional[str] = None
    min_confidence: float = DEFAULT_MIN_CONFIDENCE
    overlap: float = DEFAULT_OVERLAP
    formats: list[OutputFormat] = field(
        default_factory=lambda: [OutputFormat.CSV]
    )
    batch_size: Optional[int] = None  # None = smart default per model/backend
    latitude: Optional[float] = None
    longitude: Optional[float] = None
    range_threshold: float = range_filter.DEFAULT_THRESHOLD
    geomodel: Optional[Path] = None
    geomodel_labels: Optional[Path] = None
    range_unmatched: UnmatchedPolicy = UnmatchedPolicy.KEEP
    #: Deprecated (parsed, reported, never written back).
    meta_model: Optional[Path] = None
    species_list_file: Optional[Path] = None
    day_of_year: Optional[int] = None
    csv_columns: CsvColumnsConfig = field(default_factory=CsvColumnsConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "DefaultsConfig":
        self = cls()
        self.model = d.get("model")
        self.min_confidence = float(d.get("min_confidence", DEFAULT_MIN_CONFIDENCE))
        self.overlap = float(d.get("overlap", DEFAULT_OVERLAP))
        if "formats" in d:
            self.formats = [OutputFormat(f) for f in d["formats"]]
        if d.get("batch_size") is not None:
            self.batch_size = int(d["batch_size"])
        if d.get("latitude") is not None:
            self.latitude = float(d["latitude"])
        if d.get("longitude") is not None:
            self.longitude = float(d["longitude"])
        self.range_threshold = float(
            d.get("range_threshold", range_filter.DEFAULT_THRESHOLD)
        )
        if d.get("geomodel"):
            self.geomodel = Path(d["geomodel"])
        if d.get("geomodel_labels"):
            self.geomodel_labels = Path(d["geomodel_labels"])
        self.range_unmatched = UnmatchedPolicy(d.get("range_unmatched", "keep"))
        if "meta_model" in d:
            self.meta_model = Path(d["meta_model"])
        if d.get("species_list_file"):
            self.species_list_file = Path(d["species_list_file"])
        if d.get("day_of_year") is not None:
            self.day_of_year = int(d["day_of_year"])
        cc = d.get("csv_columns", {})
        self.csv_columns = CsvColumnsConfig(include=list(cc.get("include", [])))
        return self

    def to_dict(self) -> dict:
        d = {
            "min_confidence": self.min_confidence,
            "overlap": self.overlap,
            "formats": [f.value for f in self.formats],
            "range_threshold": self.range_threshold,
            "range_unmatched": self.range_unmatched.value,
        }
        if self.model is not None:
            d["model"] = self.model
        if self.batch_size is not None:
            d["batch_size"] = self.batch_size
        if self.latitude is not None:
            d["latitude"] = self.latitude
        if self.longitude is not None:
            d["longitude"] = self.longitude
        if self.geomodel is not None:
            d["geomodel"] = str(self.geomodel)
        if self.geomodel_labels is not None:
            d["geomodel_labels"] = str(self.geomodel_labels)
        if self.species_list_file is not None:
            d["species_list_file"] = str(self.species_list_file)
        if self.day_of_year is not None:
            d["day_of_year"] = self.day_of_year
        d["csv_columns"] = {"include": list(self.csv_columns.include)}
        return d


@dataclass
class InferenceConfig:
    device: InferenceDevice = InferenceDevice.AUTO

    @classmethod
    def from_dict(cls, d: dict) -> "InferenceConfig":
        return cls(device=InferenceDevice(d.get("device", "auto")))

    def to_dict(self) -> dict:
        return {"device": self.device.value}


@dataclass
class OutputConfig:
    #: Deprecated (parsed, reported, never written back).
    combined_prefix: Optional[str] = None
    default_format: OutputMode = OutputMode.HUMAN

    @classmethod
    def from_dict(cls, d: dict) -> "OutputConfig":
        return cls(
            combined_prefix=d.get("combined_prefix"),
            default_format=OutputMode(d.get("default_format", "human")),
        )

    def to_dict(self) -> dict:
        return {"default_format": self.default_format.value}


@dataclass
class Config:
    models: dict[str, ModelConfig] = field(default_factory=dict)
    defaults: DefaultsConfig = field(default_factory=DefaultsConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    output: OutputConfig = field(default_factory=OutputConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            models={
                name: ModelConfig.from_dict(md)
                for name, md in d.get("models", {}).items()
            },
            defaults=DefaultsConfig.from_dict(d.get("defaults", {})),
            inference=InferenceConfig.from_dict(d.get("inference", {})),
            output=OutputConfig.from_dict(d.get("output", {})),
        )

    def to_dict(self) -> dict:
        return {
            "models": {n: m.to_dict() for n, m in self.models.items()},
            "defaults": self.defaults.to_dict(),
            "inference": self.inference.to_dict(),
            "output": self.output.to_dict(),
        }

    def deprecated_keys(self) -> list[str]:
        """Stale keys present in the loaded file, for warning messages."""
        found = []
        if self.defaults.meta_model is not None:
            found.append("defaults.meta_model")
        if self.output.combined_prefix is not None:
            found.append("output.combined_prefix")
        for name, m in self.models.items():
            if m.meta_model is not None:
                found.append(f"models.{name}.meta_model")
        return found
