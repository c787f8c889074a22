"""Range filter activation rules (reference ``src/config/range_filter.rs``).

Single authority on which models range filter: BSG has its own species
distribution mechanism, and bat detections cannot be range filtered by this
geomodel at all (v3.0.2 scores resident bats ~0.002-0.016 against >=0.85 for
birds, so every bat detection would fall below any useful threshold). Do not
re-derive this at the point of use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..constants import confidence
from ..errors import InvalidRangeThreshold
from ..inference.geomodel_filter import UnmatchedPolicy
from ..utils.date import date_to_week
from .types import Config, ModelType


@dataclass
class RangeFilterRequest:
    """Resolved parameters for building the range filter."""

    latitude: float
    longitude: float
    week: int
    threshold: float
    unmatched: UnmatchedPolicy
    rerank: bool


def supports_range_filter(bat_mode: bool, model_type: ModelType) -> bool:
    if bat_mode:
        return False
    return model_type in (
        ModelType.BIRDNET_V24, ModelType.BIRDNET_V30, ModelType.PERCH_V2
    )


def validate_threshold(cli_threshold: Optional[float], config: Config) -> None:
    """Runs BEFORE geomodel resolution, so a bad threshold is reported
    without first downloading 15 MB."""
    threshold = (
        cli_threshold if cli_threshold is not None
        else config.defaults.range_threshold
    )
    if not (confidence.MIN <= threshold <= confidence.MAX):
        raise InvalidRangeThreshold(threshold)


def wants_range_filter(
    config: Config,
    model_type: ModelType,
    bat_mode: bool = False,
    lat: Optional[float] = None,
    lon: Optional[float] = None,
    week: Optional[int] = None,
    month: Optional[int] = None,
    day: Optional[int] = None,
) -> bool:
    """Checked ahead of acquisition so birda never downloads a geomodel it
    will then discard. Coordinates alone are not enough — a time parameter
    is also required."""
    has_coords = (
        (lat if lat is not None else config.defaults.latitude) is not None
        and (lon if lon is not None else config.defaults.longitude) is not None
    )
    has_time = week is not None or (month is not None and day is not None)
    return has_coords and has_time and supports_range_filter(bat_mode, model_type)


def build_range_filter_request(
    config: Config,
    model_type: ModelType,
    bat_mode: bool = False,
    lat: Optional[float] = None,
    lon: Optional[float] = None,
    week: Optional[int] = None,
    month: Optional[int] = None,
    day: Optional[int] = None,
    threshold: Optional[float] = None,
    unmatched: Optional[UnmatchedPolicy] = None,
    rerank: bool = False,
) -> Optional[RangeFilterRequest]:
    """CLI overrides config; returns None when any activation condition is
    unmet (reference ``build_range_filter_config``)."""
    latitude = lat if lat is not None else config.defaults.latitude
    longitude = lon if lon is not None else config.defaults.longitude
    if latitude is None or longitude is None:
        return None
    if week is None:
        if month is not None and day is not None:
            week = date_to_week(month, day)
        else:
            return None
    # The reference round-trips week -> (month, day) -> week: its
    # range_filter.rs:106-123 re-encodes the week as the week's START date
    # and birdnet-onnx re-derives a week from that date internally. We feed
    # the user's week straight to the geomodel — the same linear
    # floor((doy-1)/7.6)+1 calendar as the reference's date.rs — rather
    # than reproduce a lossy round-trip through an opaque third-party
    # re-encoding (observable only with the real crate; at most a one-week
    # shift on boundary dates).
    if not supports_range_filter(bat_mode, model_type):
        return None
    return RangeFilterRequest(
        latitude=latitude,
        longitude=longitude,
        week=week,
        threshold=(
            threshold if threshold is not None else config.defaults.range_threshold
        ),
        unmatched=(
            unmatched if unmatched is not None else config.defaults.range_unmatched
        ),
        rerank=rerank,
    )
