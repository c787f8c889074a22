"""BSG Finnish Birds post-processing (calibration + SDM).

Mirrors the processing pipeline the reference drives through the
``birdnet-onnx`` crate's ``BsgPostProcessor`` (reference
``src/inference/classifier.rs:315-346``, README "BSG Finnish Birds v4.4"):

1. **Calibration (always applied)**: per-species logistic regression (Platt
   scaling) over the backbone scores — ``calibrated = sigmoid(a * logit(s) + b)``.
2. **SDM (optional)**: Species Distribution Model adjustment from
   (latitude, longitude, day-of-year): a per-species presence grid over
   Finland plus seasonal presence windows from migration data. Species not
   predicted present at the location/season are suppressed.

File formats (documented here because the upstream crate's loaders are not
part of the reference tree; version markers keep them evolvable):

- calibration CSV: header ``species,coef,intercept``; species is the full
  ``Scientific_Common`` label or bare scientific name.
- migration CSV: header ``species,start_day,end_day`` (day-of-year window,
  inclusive, wrapping allowed e.g. 300-60 for winter presence).
- distribution maps: binary, magic ``BSGM1``, then little-endian: u32 rows,
  u32 cols, f64 lat_min, lat_max, lon_min, lon_max, u32 species count, then
  per species a NUL-terminated utf-8 name and rows*cols u8 presence grid.
"""

from __future__ import annotations

import csv
import math
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..errors import BsgCalibration, BsgDistributionMaps, BsgMigration
from .geomodel import species_key
from .geomodel_filter import Prediction

_EPS = 1e-7


@dataclass
class CalibrationEntry:
    coef: float
    intercept: float


def _logit(p: float) -> float:
    p = min(max(p, _EPS), 1.0 - _EPS)
    return math.log(p / (1.0 - p))


def _sigmoid(x: float) -> float:
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-x))
    e = math.exp(x)
    return e / (1.0 + e)


def load_calibration(path: Path | str) -> dict[str, CalibrationEntry]:
    try:
        with open(path, newline="", encoding="utf-8-sig") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None or not {
                "species", "coef", "intercept"
            } <= set(reader.fieldnames):
                raise BsgCalibration(
                    f"{path}: expected columns species,coef,intercept"
                )
            out = {}
            for row in reader:
                out[species_key(row["species"])] = CalibrationEntry(
                    coef=float(row["coef"]), intercept=float(row["intercept"])
                )
    except OSError as e:
        raise BsgCalibration(f"{path}: {e}") from e
    except (ValueError, KeyError) as e:
        raise BsgCalibration(f"{path}: {e}") from e
    if not out:
        raise BsgCalibration(f"{path}: no calibration rows")
    return out


@dataclass
class MigrationWindow:
    start_day: int
    end_day: int

    def contains(self, day: int) -> bool:
        if self.start_day <= self.end_day:
            return self.start_day <= day <= self.end_day
        return day >= self.start_day or day <= self.end_day  # wraps new year


def load_migration(path: Path | str) -> dict[str, MigrationWindow]:
    try:
        with open(path, newline="", encoding="utf-8-sig") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None or not {
                "species", "start_day", "end_day"
            } <= set(reader.fieldnames):
                raise BsgMigration(
                    f"{path}: expected columns species,start_day,end_day"
                )
            out = {}
            for row in reader:
                out[species_key(row["species"])] = MigrationWindow(
                    start_day=int(row["start_day"]),
                    end_day=int(row["end_day"]),
                )
    except OSError as e:
        raise BsgMigration(f"{path}: {e}") from e
    except (ValueError, KeyError) as e:
        raise BsgMigration(f"{path}: {e}") from e
    return out


_MAPS_MAGIC = b"BSGM1"


class DistributionMaps:
    """Per-species presence grids over a lat/lon bounding box."""

    def __init__(self, rows: int, cols: int, lat_min: float, lat_max: float,
                 lon_min: float, lon_max: float,
                 grids: dict[str, bytes]):
        self.rows = rows
        self.cols = cols
        self.lat_min, self.lat_max = lat_min, lat_max
        self.lon_min, self.lon_max = lon_min, lon_max
        self._grids = grids

    @classmethod
    def load(cls, path: Path | str) -> "DistributionMaps":
        try:
            data = Path(path).read_bytes()
        except OSError as e:
            raise BsgDistributionMaps(f"{path}: {e}") from e
        if not data.startswith(_MAPS_MAGIC):
            raise BsgDistributionMaps(f"{path}: bad magic")
        off = len(_MAPS_MAGIC)
        try:
            rows, cols = struct.unpack_from("<II", data, off)
            off += 8
            lat_min, lat_max, lon_min, lon_max = struct.unpack_from(
                "<dddd", data, off
            )
            off += 32
            (count,) = struct.unpack_from("<I", data, off)
            off += 4
            grids: dict[str, bytes] = {}
            cell_count = rows * cols
            for _ in range(count):
                end = data.index(b"\x00", off)
                name = data[off:end].decode("utf-8")
                off = end + 1
                grid = data[off : off + cell_count]
                # Slicing never raises: a truncated final grid arrives
                # short here and would IndexError much later in present().
                if len(grid) < cell_count:
                    raise ValueError(
                        f"grid for {name!r}: {len(grid)} of "
                        f"{cell_count} cells"
                    )
                grids[species_key(name)] = grid
                off += cell_count
        except (struct.error, ValueError) as e:
            raise BsgDistributionMaps(f"{path}: truncated ({e})") from e
        return cls(rows, cols, lat_min, lat_max, lon_min, lon_max, grids)

    @classmethod
    def write(cls, path: Path | str, rows: int, cols: int,
              lat_min: float, lat_max: float, lon_min: float, lon_max: float,
              grids: dict[str, bytes]) -> None:
        """Serializer (used by tooling and tests)."""
        out = bytearray(_MAPS_MAGIC)
        out += struct.pack("<II", rows, cols)
        out += struct.pack("<dddd", lat_min, lat_max, lon_min, lon_max)
        out += struct.pack("<I", len(grids))
        for name, grid in grids.items():
            assert len(grid) == rows * cols
            out += name.encode("utf-8") + b"\x00" + grid
        Path(path).write_bytes(bytes(out))

    def present(self, species: str, lat: float, lon: float) -> Optional[bool]:
        """None when the species has no map; presence bool otherwise."""
        grid = self._grids.get(species_key(species))
        if grid is None:
            return None
        if not (self.lat_min <= lat <= self.lat_max
                and self.lon_min <= lon <= self.lon_max):
            return False
        r = min(
            int((self.lat_max - lat) / (self.lat_max - self.lat_min + 1e-12)
                * self.rows),
            self.rows - 1,
        )
        c = min(
            int((lon - self.lon_min) / (self.lon_max - self.lon_min + 1e-12)
                * self.cols),
            self.cols - 1,
        )
        return grid[r * self.cols + c] != 0


class BsgPostProcessor:
    """Calibration (always) + SDM (when location and day are known)."""

    def __init__(
        self,
        calibration: dict[str, CalibrationEntry],
        migration: Optional[dict[str, MigrationWindow]] = None,
        maps: Optional[DistributionMaps] = None,
    ):
        self.calibration = calibration
        self.migration = migration
        self.maps = maps

    @classmethod
    def from_paths(cls, calibration_path, migration_path=None,
                   maps_path=None) -> "BsgPostProcessor":
        return cls(
            calibration=load_calibration(calibration_path),
            migration=(load_migration(migration_path)
                       if migration_path else None),
            maps=DistributionMaps.load(maps_path) if maps_path else None,
        )

    @property
    def has_sdm(self) -> bool:
        return self.maps is not None or self.migration is not None

    def calibrate(self, predictions: list[Prediction]) -> list[Prediction]:
        out = []
        for p in predictions:
            entry = self.calibration.get(species_key(p.species))
            if entry is None:
                out.append(p)
                continue
            conf = _sigmoid(entry.coef * _logit(p.confidence) + entry.intercept)
            out.append(Prediction(p.species, conf, p.index))
        return out

    def process(self, predictions: list[Prediction], lat: float, lon: float,
                day_of_year: int) -> list[Prediction]:
        """Calibration then SDM: a species mapped absent at this location or
        outside its seasonal window is dropped; unmapped species pass."""
        calibrated = self.calibrate(predictions)
        out = []
        for p in calibrated:
            if self.maps is not None:
                present = self.maps.present(p.species, lat, lon)
                if present is False:
                    continue
            if self.migration is not None:
                window = self.migration.get(species_key(p.species))
                if window is not None and not window.contains(day_of_year):
                    continue
            out.append(p)
        return out
