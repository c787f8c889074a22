"""Label files of the range filter (``birda_tpu/inference/range_filter.py``).

Only the label reader is ported: the classifier's labels use the same
one-per-line format. The geomodel range filter itself is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

from ..errors import LabelLoad


def read_geomodel_labels(path: Path | str) -> list[str]:
    """One ``Scientific name_Common name`` per line; blank lines dropped."""
    try:
        content = Path(path).read_text(encoding="utf-8-sig")
    except OSError as e:
        raise LabelLoad(str(path), str(e)) from e
    labels = [line.strip() for line in content.splitlines() if line.strip()]
    if not labels:
        raise LabelLoad(str(path), "file contains no labels")
    return labels
