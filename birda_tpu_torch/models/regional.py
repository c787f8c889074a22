"""Regional slicing of a full classifier graph: the port of
``birda_tpu/models/regional.py``.

The upstream registries publish region-sliced graphs (39 regions each for
Perch v2 and BirdNET v3.0): "Regional slices are bit-exact to the full model
on the species they keep. Perch confidence is a softmax, so slicing shifts
scores." This module reproduces those semantics from the *full* graph:

- The backbone and logits of kept species are unchanged.
- Sigmoid heads (BirdNET) score each class independently, so slicing is an
  ``index_select`` of the kept columns.
- Softmax heads (Perch) renormalize over the kept set:
  ``softmax(l[keep])_i = scores_i / sum_keep scores_j`` exactly, so the
  slice is a gather and a renormalization of the full-graph scores, on the
  device.

The gather indices come from label matching: regional label files are exact
subsets of the full label set (same ``Scientific_Common`` strings).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..errors import ClassifierBuild
from .contracts import ScoreActivation
from .zoo import LoadedModel


def match_labels(full_labels: list[str], region_labels: list[str]) -> np.ndarray:
    """Indices of each regional label in the full label list.

    Exact string match first; scientific-name (text before ``_``) fallback
    for label files that localize the common name.
    """
    index = {lab: i for i, lab in enumerate(full_labels)}
    sci_index: dict[str, int] = {}
    for i, lab in enumerate(full_labels):
        sci_index.setdefault(lab.split("_", 1)[0].strip().lower(), i)

    out = []
    missing = []
    for lab in region_labels:
        i = index.get(lab)
        if i is None:
            i = sci_index.get(lab.split("_", 1)[0].strip().lower())
        if i is None:
            missing.append(lab)
        else:
            out.append(i)
    if missing:
        raise ClassifierBuild(
            f"{len(missing)} regional labels not present in the full model "
            f"(first: {missing[0]!r})"
        )
    return np.asarray(out, np.int32)


def slice_to_region(
    model: LoadedModel, region_labels: list[str], region: str = ""
) -> LoadedModel:
    """A regional view of ``model``: kept-species scores, exact upstream
    regional-graph semantics (gather for sigmoid, gather+renormalize for
    softmax). Embeddings pass through unchanged (the backbone is shared).
    As in the JAX package, the view carries no ``precision_info``."""
    idx = torch.from_numpy(match_labels(model.labels, region_labels)
                           .astype(np.int64))
    on_device: dict[torch.device, torch.Tensor] = {}
    softmax = model.config.activation == ScoreActivation.SOFTMAX
    base_apply = model.apply

    def apply(waveform):
        out = base_apply(waveform)
        dev = out["scores"].device
        keep = on_device.get(dev)
        if keep is None:
            keep = on_device[dev] = idx.to(dev)
        scores = out["scores"].index_select(-1, keep)
        logits = out["logits"].index_select(-1, keep)
        if softmax:
            scores = scores / scores.sum(-1, keepdim=True)
        return {**out, "scores": scores, "logits": logits}

    cfg = replace(model.config, num_classes=len(idx))
    return LoadedModel(
        config=cfg,
        labels=list(region_labels),
        apply=apply,
        source=f"{model.source}+region:{region or 'custom'}",
        mel_config=model.mel_config,
        bind_device=model.bind_device,
    )
