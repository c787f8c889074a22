"""Species-list file reading (reference ``src/utils/species_list.rs:19``).

A species list is a text file with one label per line. Lines may be full
BirdNET labels (``Scientific_Common``) or bare scientific names; blank lines
and ``#`` comments are skipped. Matching against classifier labels is done on
the scientific-name half, case-insensitively.
"""

from __future__ import annotations

from pathlib import Path

from ..errors import SpeciesListRead


def read_species_list(path: Path | str) -> list[str]:
    """Read a species list file into a list of entries (order preserved)."""
    path = Path(path)
    try:
        text = path.read_text(encoding="utf-8-sig")
    except OSError as e:
        raise SpeciesListRead(str(path), str(e)) from e
    entries: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        entries.append(line)
    return entries


def scientific_name(label: str) -> str:
    """The scientific-name half of a BirdNET label (everything before '_')."""
    idx = label.find("_")
    return label if idx < 0 else label[:idx]


def species_set(entries: list[str]) -> set[str]:
    """Lowercased scientific-name set for membership checks."""
    return {scientific_name(e).lower() for e in entries}


def label_matches(label: str, allowed: set[str]) -> bool:
    """True if the label's scientific name is in the allowed set."""
    return scientific_name(label).lower() in allowed
