"""BirdNET 48-week calendar math (reference ``src/utils/date.rs:21-110``).

BirdNET divides the year into 48 weeks of ~7.6 days. The math deliberately
assumes a non-leap calendar — post-February dates in leap years are off by one
day (~0.13 week), acceptable for the approximate 48-week system.
"""

from __future__ import annotations

import datetime
import math
from pathlib import Path

from ..constants import calendar, range_filter
from ..errors import DayOfYearAutoDetect


def date_to_week(month: int, day: int) -> int:
    """Convert month/day to BirdNET week (1-48).

    ``week = floor((day_of_year - 1) / 7.6) + 1``, clamped to 48.
    Month/day combinations are not validated (Feb 31 gives a wrong answer,
    not an error) — matching the reference contract.
    """
    day_of_year = sum(calendar.DAYS_IN_MONTH[: month - 1]) + day
    week = math.floor((day_of_year - 1) / range_filter.DAYS_PER_WEEK) + 1
    return min(week, range_filter.WEEKS_PER_YEAR)


def day_of_year_to_date(day_of_year: int) -> tuple[int, int]:
    """Convert a day-of-year to (month, day) on a non-leap calendar.

    Saturates past the table to Dec 31 (where day 366 lands); 0 returns
    (1, 0), which is not a date — unbounded at both ends like the reference.
    """
    remaining = day_of_year
    for month_idx, days_in_month in enumerate(calendar.DAYS_IN_MONTH):
        if remaining <= days_in_month:
            return (month_idx + 1, remaining)
        remaining -= days_in_month
    return (12, 31)


def week_to_start_day(week: int) -> int:
    """First day-of-year of a BirdNET week: ``(week-1) * 7.6 + 1``."""
    return int((week - 1) * range_filter.DAYS_PER_WEEK + range_filter.YEAR_START_DAY)


def auto_detect_day_of_year(file_path: Path | str) -> int:
    """Day-of-year (1-366) from the file's modification time, local timezone.

    Used by BSG SDM when ``--day-of-year`` is not given; each file in a batch
    can carry a different day.
    """
    try:
        mtime = Path(file_path).stat().st_mtime
    except OSError as e:
        raise DayOfYearAutoDetect(f"failed to read file metadata for {file_path}: {e}") from e
    dt = datetime.datetime.fromtimestamp(mtime)
    return dt.timetuple().tm_yday
