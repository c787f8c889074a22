"""Registry document model (reference ``src/registry/`` types).

The registry describes installable model assets: per-model files or a
variant matrix (precision x region), license terms, and the shared geomodel
range-filter entry, all sha256-pinned.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..errors import ModelNotFoundInRegistry, RegistryParse


@dataclass
class FileRef:
    url: str
    filename: str
    sha256: Optional[str] = None
    size_bytes: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "FileRef":
        return cls(
            url=d["url"], filename=d["filename"],
            sha256=d.get("sha256"), size_bytes=d.get("size_bytes"),
        )


@dataclass
class LanguageRef:
    code: str
    name: str
    url: str
    filename: str

    @classmethod
    def from_dict(cls, d: dict) -> "LanguageRef":
        return cls(d["code"], d.get("name", d["code"]), d["url"], d["filename"])


@dataclass
class LicenseInfo:
    type: str = ""
    url: str = ""
    commercial_use: bool = True
    attribution_required: bool = False
    share_alike: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "LicenseInfo":
        return cls(
            type=d.get("type", ""), url=d.get("url", ""),
            commercial_use=d.get("commercial_use", True),
            attribution_required=d.get("attribution_required", False),
            share_alike=d.get("share_alike", False),
        )


@dataclass
class Variant:
    """One installable variant: precision id + optional region."""

    id: str
    model: FileRef
    labels: Optional[FileRef] = None
    region: Optional[str] = None
    region_name: Optional[str] = None
    group: Optional[str] = None
    group_name: Optional[str] = None
    group_order: int = 0
    classes: Optional[int] = None

    @property
    def key(self) -> str:
        return f"{self.region}/{self.id}" if self.region else self.id

    @classmethod
    def from_dict(cls, d: dict) -> "Variant":
        return cls(
            id=d["id"],
            model=FileRef.from_dict(d["model"]),
            labels=FileRef.from_dict(d["labels"]) if d.get("labels") else None,
            region=d.get("region"),
            region_name=d.get("region_name"),
            group=d.get("group"),
            group_name=d.get("group_name"),
            group_order=d.get("group_order", 0),
            classes=d.get("classes"),
        )


@dataclass
class ModelFiles:
    """Simple (non-variant) model: one graph + multilingual labels."""

    model: FileRef
    languages: list[LanguageRef] = field(default_factory=list)
    default_language: str = "en"
    extra: dict[str, FileRef] = field(default_factory=dict)  # bsg csvs etc.

    @classmethod
    def from_dict(cls, d: dict) -> "ModelFiles":
        labels = d.get("labels", {})
        extra = {}
        for key, val in d.items():
            if key in ("model", "labels"):
                continue
            if isinstance(val, dict) and "url" in val:
                extra[key] = FileRef.from_dict(val)
        return cls(
            model=FileRef.from_dict(d["model"]),
            languages=[LanguageRef.from_dict(x) for x in labels.get("languages", [])],
            default_language=labels.get("default_language", "en"),
            extra=extra,
        )


@dataclass
class RegistryModel:
    id: str
    name: str
    description: str
    vendor: str
    version: str
    model_type: str
    license: LicenseInfo
    recommended: bool = False
    files: Optional[ModelFiles] = None
    variants: list[Variant] = field(default_factory=list)
    default_variant: Optional[str] = None
    #: Our conversion revision of the upstream weights. The version is the
    #: exact upstream identity (preview status included); showing only it
    #: would let two different files answer to one version string
    #: (reference registry/mod.rs show_info).
    build: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "RegistryModel":
        return cls(
            id=d["id"],
            name=d.get("name", d["id"]),
            description=d.get("description", ""),
            vendor=d.get("vendor", ""),
            version=d.get("version", ""),
            model_type=d.get("model_type", d["id"]),
            license=LicenseInfo.from_dict(d.get("license", {})),
            recommended=bool(d.get("recommended", False)),
            files=ModelFiles.from_dict(d["files"]) if d.get("files") else None,
            variants=[Variant.from_dict(v) for v in d.get("variants", [])],
            default_variant=d.get("default_variant"),
            build=d.get("build"),
        )

    @property
    def has_variants(self) -> bool:
        return bool(self.variants)

    def language(self, code: str) -> Optional[LanguageRef]:
        if self.files is None:
            return None
        for lang in self.files.languages:
            if lang.code == code:
                return lang
        return None


@dataclass
class RangeFilterEntry:
    id: str
    version: str
    species_count: int
    model: FileRef
    labels: FileRef
    license: LicenseInfo = field(default_factory=LicenseInfo)
    name: str = ""
    vendor: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "RangeFilterEntry":
        return cls(
            id=d["id"], version=d.get("version", ""),
            species_count=d.get("species_count", 0),
            model=FileRef.from_dict(d["model"]),
            labels=FileRef.from_dict(d["labels"]),
            license=LicenseInfo.from_dict(d.get("license", {})),
            name=d.get("name", ""), vendor=d.get("vendor", ""),
        )


@dataclass
class Registry:
    schema_version: str
    registry_version: int
    models: list[RegistryModel]
    range_filter: Optional[RangeFilterEntry] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Registry":
        try:
            return cls(
                schema_version=d.get("schema_version", ""),
                registry_version=int(d.get("registry_version", 0)),
                models=[RegistryModel.from_dict(m) for m in d.get("models", [])],
                range_filter=(
                    RangeFilterEntry.from_dict(d["range_filter"])
                    if d.get("range_filter") else None
                ),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise RegistryParse(str(e)) from e

    def find_model(self, model_id: str) -> RegistryModel:
        for m in self.models:
            if m.id == model_id:
                return m
        raise ModelNotFoundInRegistry(model_id)
