"""Geomodel range filter: the port of ``birda_tpu/inference/range_filter.py``
(reference ``src/inference/range_filter.rs``).

Wraps a geomodel graph and answers "which species occur at (lat, lon) in
this week". The graph is lowered by the port's ONNX evaluator at fp32 and
bound to one ``torch.device``: the run's device, which is the card unless
the caller asked for the CPU. It is queried once per run at threshold 0 so
every class gets a score; thresholding and the unmatched policy are applied
afterwards in the classifier's own label space.

Input contract: ``[batch, 3]`` float32 = (latitude, longitude, week 1-48),
12,012 sigmoid occurrence scores out (``constants.range_filter``).
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from ..errors import GeomodelLabelCount, LabelLoad, RangeFilterBuild, RangeFilterPredict
from ..utils.date import date_to_week
from .geomodel import LocationScore

#: The device a :meth:`RangeFilter.from_onnx` without an explicit one binds
#: to: ``auto`` (the card, raising without one) unless a caller's
#: :func:`query_device` block says otherwise. The ``species`` command's host
#: code (a copy of the JAX package's) builds its filter this way.
_QUERY_DEVICE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "birda_range_filter_device", default="auto")


@contextmanager
def query_device(device: str):
    """Build range filters on ``device`` (``auto``/``cuda``/``gpu``/``cpu``)
    inside the block."""
    token = _QUERY_DEVICE.set(device)
    try:
        yield
    finally:
        _QUERY_DEVICE.reset(token)


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


def validate_geomodel_labels(labels: list[str], expected: int) -> None:
    """A count mismatch means labels and graph are from different versions."""
    if len(labels) != expected:
        raise GeomodelLabelCount(expected, len(labels))


class RangeFilter:
    """Occurrence-score model over (lat, lon, week)."""

    def __init__(self, predict_fn, labels: list[str], threshold: float = 0.0):
        """``predict_fn``: [batch,3] float32 -> [batch,N] sigmoid scores."""
        self._fn = predict_fn
        self.labels = labels
        self.threshold = threshold
        #: The device the lowered geomodel runs on (set by from_onnx).
        self.device: torch.device | None = None

    @classmethod
    def from_onnx(cls, geomodel_path: Path | str, labels: list[str],
                  threshold: float = 0.0,
                  device: torch.device | str | None = None) -> "RangeFilter":
        """Lower the geomodel at fp32 with its weights on ``device`` (a
        ``torch.device``, or a backend name for ``select_backend``; None
        takes the :func:`query_device` in force)."""
        from ..models.zoo import params_from_numpy
        from ..onnx.lowering import lower
        from .backend import select_backend

        if not isinstance(device, torch.device):
            device = select_backend(device or _QUERY_DEVICE.get())[0][0]
        try:
            fn = lower(str(geomodel_path))
        except Exception as e:
            raise RangeFilterBuild(str(e)) from e

        out_dim = None
        for vi in fn.graph.outputs:
            dims = [d for d in vi.shape if isinstance(d, int)]
            if dims:
                out_dim = dims[-1]
        if out_dim is not None:
            validate_geomodel_labels(labels, out_dim)
        params = params_from_numpy(fn.params, device)

        def predict(x: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                out = fn(torch.from_numpy(x).to(device), params=params)
            out = out[0] if isinstance(out, tuple) else out
            return out.float().cpu().numpy()

        rf = cls(predict, labels, threshold)
        rf.device = device
        return rf

    def predict(self, latitude: float, longitude: float, month: int, day: int
                ) -> list[LocationScore]:
        """Scores for every species at/above the threshold."""
        week = date_to_week(month, day)
        return self.predict_week(latitude, longitude, week)

    def predict_week(self, latitude: float, longitude: float, week: int
                     ) -> list[LocationScore]:
        x = np.asarray([[latitude, longitude, float(week)]], np.float32)
        try:
            scores = np.asarray(self._fn(x))[0]
        except Exception as e:
            raise RangeFilterPredict(str(e)) from e
        if scores.shape[-1] != len(self.labels):
            raise RangeFilterPredict(
                f"geomodel produced {scores.shape[-1]} scores for "
                f"{len(self.labels)} labels"
            )
        return [
            LocationScore(species=label, score=float(s), index=i)
            for i, (label, s) in enumerate(zip(self.labels, scores))
            if s >= self.threshold
        ]
