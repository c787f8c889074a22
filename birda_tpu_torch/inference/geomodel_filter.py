"""Applying geomodel occurrence scores to predictions.

Port of the reference's policy matrix (``src/inference/geomodel_filter.rs``):

| | score >= threshold | score < threshold | no geomodel entry |
|---|---|---|---|
| rerank off, keep | keep | drop | keep, confidence untouched |
| rerank off, drop | keep | drop | drop |
| rerank on | keep, scaled | drop | drop |

Reranking always drops unmatched species: it computes
``confidence * P(present)`` and a species with no geomodel entry has no such
term — substituting 1.0 would hand the species we know least about the
maximum possible prior.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from .geomodel import GeomodelScores


class UnmatchedPolicy(str, Enum):
    """What happens to species that have no geomodel entry."""

    KEEP = "keep"
    DROP = "drop"


@dataclass(frozen=True)
class Prediction:
    """One (species, confidence) prediction from the classifier."""

    species: str
    confidence: float
    index: int


@dataclass(frozen=True)
class FilterSettings:
    threshold: float
    unmatched: UnmatchedPolicy
    rerank: bool

    @property
    def keeps_unmatched(self) -> bool:
        return self.unmatched == UnmatchedPolicy.KEEP and not self.rerank


def filter_predictions(
    predictions: list[Prediction],
    scores: GeomodelScores,
    settings: FilterSettings,
) -> list[Prediction]:
    keeps_unmatched = settings.keeps_unmatched
    filtered: list[Prediction] = []
    for p in predictions:
        score = scores.score_of(p.species)
        if score is None:
            if keeps_unmatched:
                filtered.append(p)
        elif score >= settings.threshold:
            conf = p.confidence * score if settings.rerank else p.confidence
            filtered.append(Prediction(p.species, conf, p.index))
        # else: in range data, but not expected here at this time of year.

    if settings.rerank:
        filtered.sort(key=lambda p: -p.confidence)
    return filtered
