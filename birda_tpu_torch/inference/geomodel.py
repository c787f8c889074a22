"""Geomodel species mapping and score projection.

Pure module (no I/O, no model execution) — port of the reference's
``src/inference/geomodel.rs``. The geomodel scores 12,012 species; every
classifier has its own label set (BirdNET v2.4: 6,522; Perch v2: 14,795),
localized into 37 languages, so both sides key on the lowercased scientific
name.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

logger = logging.getLogger(__name__)


@dataclass
class LocationScore:
    """One geomodel occurrence score."""

    species: str
    score: float
    index: int


def scientific_name(label: str) -> str:
    """Scientific-name half of a label.

    The part before the first underscore counts as a scientific name only
    when it contains a space: every geomodel key is a binomial, while Perch
    carries FSD50K sound classes like ``Accelerating_and_revving_and_vroom``
    that splitting would truncate (reference ``geomodel.rs:17-32``).
    """
    idx = label.find("_")
    if idx > 0 and " " in label[:idx]:
        return label[:idx]
    return label


def species_key(label: str) -> str:
    return scientific_name(label).lower()


class SpeciesMapping:
    """Mapping from geomodel species keys to classifier labels."""

    def __init__(self, by_species_key: dict[str, str], total: int):
        self._by_species_key = by_species_key
        self._total = total

    @classmethod
    def build(cls, geomodel_labels: list[str], classifier_labels: list[str]):
        """First classifier label wins on scientific-name collisions (logged,
        so filtering never silently depends on label file order)."""
        classifier_by_key: dict[str, str] = {}
        for label in classifier_labels:
            key = species_key(label)
            if key in classifier_by_key:
                logger.warning(
                    "Classifier labels '%s' and '%s' share the scientific name "
                    "'%s'; range filtering will use the first",
                    classifier_by_key[key], label, key,
                )
            else:
                classifier_by_key[key] = label

        by_species_key = {}
        for glabel in geomodel_labels:
            key = species_key(glabel)
            if key in classifier_by_key:
                by_species_key[key] = classifier_by_key[key]
        return cls(by_species_key, len(classifier_labels))

    def classifier_label_for(self, geomodel_label: str) -> str | None:
        return self._by_species_key.get(species_key(geomodel_label))

    def mapped_count(self) -> int:
        return len(self._by_species_key)

    def unmatched_count(self) -> int:
        return max(0, self._total - self.mapped_count())

    def total_classifier_species(self) -> int:
        return self._total

    def mapped_classifier_labels(self):
        return self._by_species_key.values()


class GeomodelScores:
    """Geomodel scores projected into a classifier's label space.

    A label is absent exactly when the classifier species has no geomodel
    entry; a mapped species the geomodel omitted reads 0.0 ("out of range"),
    never "no range data".
    """

    def __init__(self, by_classifier_label: dict[str, float] | None = None):
        self._by_label = by_classifier_label or {}

    @classmethod
    def project(cls, scores: list[LocationScore], mapping: SpeciesMapping):
        by_label = {label: 0.0 for label in mapping.mapped_classifier_labels()}
        for s in scores:
            label = mapping.classifier_label_for(s.species)
            if label is not None:
                by_label[label] = s.score
        return cls(by_label)

    def score_of(self, classifier_label: str) -> float | None:
        return self._by_label.get(classifier_label)

    def in_range_count(self, threshold: float) -> int:
        return sum(1 for s in self._by_label.values() if s >= threshold)

    def is_empty(self) -> bool:
        return not self._by_label


@dataclass(frozen=True)
class MappingSummary:
    """Coverage of the classifier's label set (for the JSON protocol)."""

    mapped: int
    unmatched: int
    total: int
    in_range: int

    @classmethod
    def new(cls, mapping: SpeciesMapping, scores: GeomodelScores, threshold: float):
        return cls(
            mapped=mapping.mapped_count(),
            unmatched=mapping.unmatched_count(),
            total=mapping.total_classifier_species(),
            in_range=scores.in_range_count(threshold),
        )
