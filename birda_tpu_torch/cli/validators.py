"""CLI argument validators (reference ``src/cli/validators.rs``).

Every rule reads the same ``constants`` bounds the config-file validation
reads, so the three routes to a setting (flag, ``BIRDA_*`` env var, file)
cannot drift (#306/#312/#340 lineage). Values are trimmed because each is
reachable through an environment variable that may have picked up whitespace
in a shell profile. Range checks use the negated-``contains`` spelling so
NaN is rejected on both halves.
"""

from __future__ import annotations

import math

from ..constants import (
    MAX_BATCH_SIZE,
    MIN_BATCH_SIZE,
    confidence,
    coordinates,
    day_of_year,
    range_filter,
    calendar,
    time as time_consts,
)


class ValidationFailure(ValueError):
    """Raised with the user-facing message."""


def _number(s: str, kind=float):
    try:
        return kind(str(s).strip())
    except (TypeError, ValueError):
        raise ValidationFailure(f"'{s}' is not a valid number") from None


def parse_confidence(s) -> float:
    value = _number(s)
    if not (confidence.MIN <= value <= confidence.MAX):
        raise ValidationFailure(
            f"confidence must be between {confidence.MIN:.1f} and "
            f"{confidence.MAX:.1f}, got {value}"
        )
    return value


def parse_latitude(s) -> float:
    value = _number(s)
    if not (coordinates.LATITUDE_MIN <= value <= coordinates.LATITUDE_MAX):
        raise ValidationFailure(
            f"latitude must be between {coordinates.LATITUDE_MIN} and "
            f"{coordinates.LATITUDE_MAX}, got {value}"
        )
    return value


def parse_longitude(s) -> float:
    value = _number(s)
    if not (coordinates.LONGITUDE_MIN <= value <= coordinates.LONGITUDE_MAX):
        raise ValidationFailure(
            f"longitude must be between {coordinates.LONGITUDE_MIN} and "
            f"{coordinates.LONGITUDE_MAX}, got {value}"
        )
    return value


def parse_overlap(s) -> float:
    """Finite and non-negative; no upper bound (only the decoder knows the
    segment length to compare against). Wording matches the config rule."""
    value = _number(s)
    if not math.isfinite(value) or value < 0.0:
        raise ValidationFailure(
            f"overlap must be a finite non-negative number, got {value}"
        )
    return value


def parse_padding(s) -> float:
    """Clip padding: finite, non-negative, capped (reference
    ``src/cli/clip.rs::parse_padding``). NaN must fail here: ``--pre nan``
    used to be laundered by ``max(start - pre, 0.0)`` into clipping from
    the start of the file, and ``--post nan`` turned the end bound into a
    NaN that the seconds-to-samples cast made 0."""
    from ..constants import clipper as clip_consts

    value = _number(s)
    if not math.isfinite(value) or value < 0.0:
        raise ValidationFailure(
            f"padding must be a finite non-negative number, got {value}"
        )
    if value > clip_consts.MAX_PADDING:
        raise ValidationFailure(
            f"padding cannot exceed {clip_consts.MAX_PADDING:g} seconds, "
            f"got {value}"
        )
    return value


def parse_time(s) -> float:
    """Clip --start/--end: finite and non-negative (reference
    ``src/cli/clip.rs::parse_time``). ``--end inf`` used to saturate the
    seconds-to-samples cast; ``--start nan`` wrote a clip named after a
    NaN over a range nobody asked for, exit 0."""
    value = _number(s)
    if not math.isfinite(value) or value < 0.0:
        raise ValidationFailure(
            f"time must be a finite non-negative number, got {value}"
        )
    return value


def parse_batch_size(s) -> int:
    value = _number(s, int)
    if value < MIN_BATCH_SIZE:
        raise ValidationFailure(f"batch size must be at least {MIN_BATCH_SIZE}")
    if value > MAX_BATCH_SIZE:
        raise ValidationFailure(
            f"batch size must be at most {MAX_BATCH_SIZE}; reduce it or use --cpu"
        )
    return value


def parse_day_of_year(s) -> int:
    value = _number(s, int)
    if not (day_of_year.MIN <= value <= day_of_year.MAX):
        raise ValidationFailure(
            f"day of year must be between {day_of_year.MIN} and "
            f"{day_of_year.MAX}, got {value}"
        )
    return value


def parse_week(s) -> int:
    value = _number(s, int)
    if not (range_filter.WEEK_MIN <= value <= range_filter.WEEKS_PER_YEAR):
        raise ValidationFailure(
            f"week must be between {range_filter.WEEK_MIN} and "
            f"{range_filter.WEEKS_PER_YEAR}, got {value}"
        )
    return value


def parse_month(s) -> int:
    value = _number(s, int)
    if not (calendar.MONTH_MIN <= value <= calendar.MONTH_MAX):
        raise ValidationFailure(
            f"month must be between {calendar.MONTH_MIN} and "
            f"{calendar.MONTH_MAX}, got {value}"
        )
    return value


def parse_day(s) -> int:
    value = _number(s, int)
    if not (calendar.DAY_MIN <= value <= calendar.DAY_MAX):
        raise ValidationFailure(
            f"day must be between {calendar.DAY_MIN} and "
            f"{calendar.DAY_MAX}, got {value}"
        )
    return value


def parse_stale_lock_timeout(s) -> float:
    """Duration with s/m/h/d suffix (bare number = seconds). Returns secs."""
    s = str(s).strip().lower()
    if not s:
        raise ValidationFailure("empty duration")
    multiplier = 1
    if s[-1] in "smhd":
        multiplier = {
            "s": 1,
            "m": time_consts.SECONDS_PER_MINUTE,
            "h": time_consts.SECONDS_PER_HOUR,
            "d": time_consts.SECONDS_PER_DAY,
        }[s[-1]]
        s = s[:-1]
    value = _number(s)
    if value <= 0:
        raise ValidationFailure("stale lock timeout must be positive")
    total = value * multiplier
    # The reference's u64 checked_mul guard (validators.rs:228): an absurd
    # duration is a typo, not a request — and total seconds past the u64
    # bound (2**64 - 1) cannot mean anything to a staleness clock.
    if total >= 2**64:
        raise ValidationFailure("stale lock timeout is too large")
    return total


#: Constant-derived range strings for CLI help text. The range a flag's
#: help states and the range its validator enforces must come from the
#: same constant (reference #312/#341: help said one bound, the parser
#: enforced another); tests pin each flag's own help block to these.
HELP_RANGES = {
    "confidence": f"({confidence.MIN:.1f}-{confidence.MAX:.1f})",
    "latitude": f"({coordinates.LATITUDE_MIN:.1f} to "
                f"{coordinates.LATITUDE_MAX:.1f})",
    "longitude": f"({coordinates.LONGITUDE_MIN:.1f} to "
                 f"{coordinates.LONGITUDE_MAX:.1f})",
    "batch_size": f"({MIN_BATCH_SIZE}-{MAX_BATCH_SIZE})",
    "week": f"({range_filter.WEEK_MIN}-{range_filter.WEEKS_PER_YEAR})",
    "month": f"({calendar.MONTH_MIN}-{calendar.MONTH_MAX})",
    "day": f"({calendar.DAY_MIN}-{calendar.DAY_MAX})",
    "day_of_year": f"({day_of_year.MIN}-{day_of_year.MAX})",
}
