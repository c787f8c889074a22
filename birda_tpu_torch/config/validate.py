"""Whole-document config validation (reference ``src/config/validate.rs``).

The same bounds used by the CLI validators (shared through ``constants``) are
enforced on the file route, so a hand-edited config.toml cannot smuggle a
value past the checks the flags go through (#295/#306/#312/#340 lineage):

- ``min_confidence`` in [0, 1]
- ``overlap`` finite and non-negative (NaN would silently become 0 through
  the overlap*rate cast — the reported bug's signature)
- ``batch_size`` in [1, 512] when set
- ``day_of_year`` in [1, 366] when set
- ``formats`` non-empty (empty made every file "already processed")
- default ``model`` must name a configured model
- latitude/longitude within bounds
- ``range_threshold`` in [0, 1] — range checks reject NaN naturally
- ``csv_columns.include`` entries must be recognised
"""

from __future__ import annotations

import math

from ..constants import (
    MAX_BATCH_SIZE,
    MIN_BATCH_SIZE,
    confidence,
    coordinates,
    csv_columns,
    day_of_year,
)
from ..errors import (
    BsgConfig,
    ConfigValidation,
    InvalidLatitude,
    InvalidLongitude,
    InvalidRangeThreshold,
    LabelsFileNotFound,
    ModelFileNotFound,
    ModelNotFound,
)
from .types import Config, ModelConfig, ModelType


def validate_config(config: Config) -> None:
    _validate_defaults(config)
    _validate_range_filter(config)


def _validate_defaults(config: Config) -> None:
    d = config.defaults

    if not (confidence.MIN <= d.min_confidence <= confidence.MAX):
        raise ConfigValidation(
            f"min_confidence must be between {confidence.MIN} and "
            f"{confidence.MAX}, got {d.min_confidence}"
        )

    if not math.isfinite(d.overlap) or d.overlap < 0.0:
        raise ConfigValidation(
            f"overlap must be a finite non-negative number, got {d.overlap}"
        )

    if d.batch_size is not None and not (
        MIN_BATCH_SIZE <= d.batch_size <= MAX_BATCH_SIZE
    ):
        raise ConfigValidation(
            f"batch_size must be between {MIN_BATCH_SIZE} and "
            f"{MAX_BATCH_SIZE}, got {d.batch_size}"
        )

    if d.day_of_year is not None and not (
        day_of_year.MIN <= d.day_of_year <= day_of_year.MAX
    ):
        raise ConfigValidation(
            f"day_of_year must be between {day_of_year.MIN} and "
            f"{day_of_year.MAX}, got {d.day_of_year}"
        )

    if not d.formats:
        # Reference validate.rs:176 wording — the message is the only route
        # out of this state (no CLI flag writes an empty list), so it must
        # say what to do.
        raise ConfigValidation(
            "defaults.formats must list at least one output format; with an "
            "empty list a run writes no output at all"
        )

    if d.model is not None and d.model not in config.models:
        raise ConfigValidation(
            f"default model '{d.model}' is not a configured model"
        )

    for col in d.csv_columns.include:
        if col not in csv_columns.RECOGNISED:
            raise ConfigValidation(
                f"unrecognised csv column '{col}'; valid columns: "
                f"{', '.join(csv_columns.RECOGNISED)}"
            )


def _validate_range_filter(config: Config) -> None:
    d = config.defaults
    if d.latitude is not None and not (
        coordinates.LATITUDE_MIN <= d.latitude <= coordinates.LATITUDE_MAX
    ):
        raise InvalidLatitude(d.latitude)
    if d.longitude is not None and not (
        coordinates.LONGITUDE_MIN <= d.longitude <= coordinates.LONGITUDE_MAX
    ):
        raise InvalidLongitude(d.longitude)
    # Range comparison rejects NaN naturally (NaN fails both bounds).
    if not (confidence.MIN <= d.range_threshold <= confidence.MAX):
        raise InvalidRangeThreshold(d.range_threshold)


def validate_model_config(name: str, model: ModelConfig) -> None:
    """Checks deferred to the point of use: file existence + BSG extras.

    ``synthetic:`` paths are the framework's built-in-architecture scheme
    (no file on disk to check); they validate as present."""
    synthetic = str(model.path).startswith("synthetic:")
    if not synthetic and not model.path.exists():
        raise ModelFileNotFound(str(model.path))
    if not synthetic and not model.labels.exists():
        raise LabelsFileNotFound(str(model.labels))
    if model.model_type == ModelType.BSG_FINLAND:
        for attr, what in (
            ("bsg_calibration", "calibration"),
            ("bsg_migration", "migration"),
            ("bsg_distribution_maps", "distribution maps"),
        ):
            if getattr(model, attr) is None:
                raise BsgConfig(
                    f"BSG model '{name}' requires {what} file. Run "
                    f"'birda models install {name}' to download required files"
                )


def get_model(config: Config, name: str) -> ModelConfig:
    try:
        return config.models[name]
    except KeyError:
        raise ModelNotFound(name) from None
