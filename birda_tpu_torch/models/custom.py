"""Custom embedding-head classifiers (bat two-stage): the port of
``birda_tpu/models/custom.py`` (reference ``CustomClassifier`` from
birdnet-onnx, driven at ``src/lib.rs:883`` and
``src/pipeline/processor.rs:323-360``).

The backbone's 1,024-d embeddings feed a small regional head (11-38 bat
species). The head is the lowered ONNX graph
(``BattyBirdNET-<Region>-256kHz_fp32.onnx``) at fp32 on the classifier's
device, followed by ``torch.topk``: one small product per chunk, so there is
nothing to compile.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..errors import LabelLoad
from ..inference.geomodel_filter import Prediction


def read_labels(path: Path | str) -> list[str]:
    try:
        text = Path(path).read_text(encoding="utf-8-sig")
    except OSError as e:
        raise LabelLoad(str(path), str(e)) from e
    labels = [line.strip() for line in text.splitlines() if line.strip()]
    if not labels:
        raise LabelLoad(str(path), "file contains no labels")
    return labels


class CustomClassifier:
    """Embedding -> species head with top-k + threshold semantics."""

    def __init__(
        self,
        head_fn: Callable,
        labels: list[str],
        min_confidence: float = 0.1,
        top_k: int = 5,
        device: torch.device | str = "cpu",
    ):
        """``head_fn``: [batch, emb_dim] -> [batch, n_classes] scores, both
        tensors on ``device``."""
        self.labels = labels
        self.min_confidence = min_confidence
        self.top_k = min(top_k, len(labels))
        self.device = torch.device(device)
        self._head = head_fn

    @classmethod
    def from_onnx(cls, model_path: Path | str, labels_path: Path | str,
                  min_confidence: float = 0.1, top_k: int = 5,
                  device: torch.device | str | None = None,
                  ) -> "CustomClassifier":
        """The head graph lowered at fp32 with its weights on ``device`` (a
        ``torch.device`` or a backend name; None is ``auto``, the card)."""
        from ..inference.backend import select_backend
        from ..onnx.lowering import lower
        from .zoo import params_from_numpy

        if not isinstance(device, torch.device):
            device = select_backend(device or "auto")[0][0]
        fn = lower(str(model_path))
        labels = read_labels(labels_path)
        params = params_from_numpy(fn.params, device)

        def head(emb):
            out = fn(emb, params=params)
            return out[0] if isinstance(out, tuple) else out

        return cls(head, labels, min_confidence, top_k, device)

    def scores(self, embeddings: np.ndarray) -> torch.Tensor:
        """The head's scores ``[batch, n_classes]`` on the head's device."""
        x = torch.from_numpy(np.ascontiguousarray(embeddings, np.float32))
        with torch.inference_mode():
            return self._head(x.to(self.device)).float()

    def predict_batch(self, embeddings: np.ndarray) -> list[list[Prediction]]:
        vals, idx = torch.topk(self.scores(embeddings), self.top_k, dim=-1)
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        out = []
        for row in range(vals.shape[0]):
            out.append([
                Prediction(self.labels[int(i)], float(v), int(i))
                for v, i in zip(vals[row], idx[row])
                if v >= self.min_confidence
            ])
        return out

    def reclassify(self, results) -> list:
        """Replace each PredictionResult's predictions using its embeddings
        (the bat two-stage hop). Results without embeddings pass through."""
        embs = [r.embeddings for r in results]
        if not embs or any(e is None for e in embs):
            return results
        new_preds = self.predict_batch(np.stack(embs))
        for r, preds in zip(results, new_preds):
            r.predictions = preds
        return results
