"""Species-list generation (reference ``src/cli/species.rs:38``).

One geomodel forward pass at (lat, lon, week), scores projected into the
classifier's label space, thresholded (default 0.03 — deliberately higher
than the live-filter 0.01), sorted by occurrence probability or
alphabetically, written one label per line.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .. import constants
from ..config import file as config_file
from ..config import geomodel as geomodel_cfg
from ..config.validate import get_model
from ..errors import SpeciesListWrite
from ..inference.geomodel import GeomodelScores, SpeciesMapping
from ..inference.range_filter import RangeFilter, read_geomodel_labels
from ..registry.loader import load_registry
from ..utils.date import date_to_week
from ..utils.fs import write_atomic

DEFAULT_OUTPUT = "species_list.txt"


@dataclass
class SpeciesListResult:
    """Computed list plus the resolved week/threshold, so callers can report
    the values actually used (flags leave both optional)."""

    entries: list[tuple[str, float]]  # (label, occurrence score), sorted
    week: int
    threshold: float


def compute_species_list(
    lat: float,
    lon: float,
    week: Optional[int] = None,
    month: Optional[int] = None,
    day: Optional[int] = None,
    threshold: Optional[float] = None,
    sort: str = "freq",
    model_name: Optional[str] = None,
    geomodel_path: Optional[Path] = None,
    geomodel_labels_path: Optional[Path] = None,
    allow_download: bool = False,
    interactive: bool = False,
) -> SpeciesListResult:
    """One geomodel pass at (lat, lon, week) → thresholded, sorted entries.
    Writes nothing: structured output modes report the list inline without
    touching the filesystem (reference ``species.rs:150-188``).

    Geomodel unavailability is FATAL here — unlike the analyze path, the
    geomodel IS the feature (reference ``species.rs:66-75``).
    ``geomodel_path`` / ``geomodel_labels_path`` override the configured
    copy (the reference's global --geomodel-path flags reach this command
    too, args.rs notes)."""
    config = geomodel_cfg.config_with_override(
        config_file.load_default_config(), geomodel_path,
        geomodel_labels_path,
    )
    registry = load_registry()

    installed = geomodel_cfg.require_geomodel(
        config, registry, allow_download=allow_download,
        interactive=interactive,
    )
    geomodel_labels = read_geomodel_labels(installed.labels_path)

    # Classifier labels define the output label space when a model is
    # configured; otherwise the geomodel's own labels are used directly.
    classifier_labels = None
    name = model_name or config.defaults.model
    if name is not None and name in config.models:
        mc = get_model(config, name)
        if mc.labels.exists():
            classifier_labels = read_geomodel_labels(mc.labels)

    if week is None:
        week = date_to_week(month, day)
    if threshold is None:
        threshold = constants.species_list_cmd.DEFAULT_THRESHOLD

    rf = RangeFilter.from_onnx(installed.model_path, geomodel_labels,
                               threshold=0.0)
    scores = rf.predict_week(lat, lon, week)

    if classifier_labels is not None:
        mapping = SpeciesMapping.build(geomodel_labels, classifier_labels)
        projected = GeomodelScores.project(scores, mapping)
        entries = [
            (label, projected.score_of(label))
            for label in mapping.mapped_classifier_labels()
        ]
        entries = [(l, s) for l, s in entries if s is not None and s >= threshold]
    else:
        entries = [(s.species, s.score) for s in scores if s.score >= threshold]

    if sort == "alpha":
        entries.sort(key=lambda e: e[0].lower())
    else:
        entries.sort(key=lambda e: (-e[1], e[0].lower()))

    return SpeciesListResult(entries=entries, week=week, threshold=threshold)


def split_species_label(label: str) -> tuple[str, str]:
    """``"Genus species_Common Name"`` → (scientific, common); labels with
    no separator keep the whole string as the scientific name
    (reference ``species.rs:160-168``)."""
    if "_" in label:
        sci, common = label.split("_", 1)
        return sci, common
    return label, ""


def generate_species_list(
    output: Optional[Path],
    lat: float,
    lon: float,
    week: Optional[int] = None,
    month: Optional[int] = None,
    day: Optional[int] = None,
    threshold: Optional[float] = None,
    sort: str = "freq",
    model_name: Optional[str] = None,
    geomodel_path: Optional[Path] = None,
    geomodel_labels_path: Optional[Path] = None,
    allow_download: bool = False,
    interactive: bool = False,
) -> tuple[Path, int]:
    """Compute the list and write it one label per line (human mode).
    Returns (output path, species count)."""
    result = compute_species_list(
        lat=lat, lon=lon, week=week, month=month, day=day,
        threshold=threshold, sort=sort, model_name=model_name,
        geomodel_path=geomodel_path,
        geomodel_labels_path=geomodel_labels_path,
        interactive=interactive,
        allow_download=allow_download,
    )
    out_path = output if output is not None else Path(DEFAULT_OUTPUT)
    text = "".join(f"{label}\n" for label, _ in result.entries)
    try:
        write_atomic(out_path, text.encode("utf-8"))
    except OSError as e:
        raise SpeciesListWrite(str(out_path), str(e)) from e
    return out_path, len(result.entries)
