"""Model zoo: the port of ``birda_tpu/models/zoo.py`` for ONNX graphs.

A :class:`LoadedModel` is what the classifier consumes: ``apply(waveform
[B, sample_count]) -> {"scores", "logits", "embeddings"}`` (float32 tensors
on the waveform's device) plus its contract and labels. The JAX module
imports jax and flax at load, so its ONNX path is ported here with the same
fields and names; the native flax backbone is not part of this port.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from .contracts import ModelConfig


@dataclass
class LoadedModel:
    """A ready-to-run classifier graph."""

    config: ModelConfig
    labels: list[str]
    #: waveform [batch, sample_count] -> {"scores", "logits", "embeddings"}
    apply: Callable[[Any], dict]
    #: human-readable source ("onnx")
    source: str = "onnx"
    #: mel front-end config for precomputed-mel models; None for ONNX graphs.
    mel_config: object = None
    #: move the model's weights to a ``torch.device`` once (one copy shared
    #: by every batch shape). The classifier calls this after backend
    #: selection.
    bind_device: Callable[[torch.device], None] | None = None
    #: reduced-precision observability: {"mode": "bf16"} or None for fp32.
    precision_info: dict | None = None

    @property
    def num_classes(self) -> int:
        return self.config.num_classes


def synthetic_labels(n: int, prefix: str = "Species") -> list[str]:
    """Deterministic placeholder labels, BirdNET `Scientific_Common` shape
    (the same strings as ``birda_tpu.models.zoo.synthetic_labels``)."""
    return [f"{prefix} sp{i:05d}_{prefix} common {i:05d}" for i in range(n)]


def params_from_numpy(params: dict[str, np.ndarray], device,
                      dtype: torch.dtype | None = None
                      ) -> dict[str, torch.Tensor]:
    """Carry a params dict of numpy arrays (an ``OnnxFunction.params`` of
    either package) onto ``device``; float arrays become ``dtype`` when it
    is given, integer arrays keep theirs."""
    out = {}
    for name, arr in params.items():
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(device)
    return out


def onnx_model(
    path: Path | str | bytes,
    config: ModelConfig,
    labels: list[str],
    dtype: torch.dtype | None = None,
) -> LoadedModel:
    """Load an exported ONNX classifier graph.

    The graph takes ``[batch, sample_count]`` float32 and produces scores
    (first output) and optionally embeddings (second output).
    ``dtype=None`` runs the fp32 route; ``dtype=torch.bfloat16`` runs
    matmuls/convs in bf16 with fp32 accumulation, the spectrogram front-end
    through the fused kernel, and stores the lifted weights in bf16.
    """
    from ..onnx.lowering import lower

    fn = lower(path if isinstance(path, bytes) else str(path),
               compute_dtype=dtype)
    model = _loaded_from_onnx_fn(fn, config, labels,
                                 cast_float=dtype is not None)
    if dtype is not None:
        model.precision_info = {"mode": "bf16"}
    return model


def _loaded_from_onnx_fn(
    fn, config: ModelConfig, labels: list[str],
    cast_float: bool, source: str = "onnx",
) -> LoadedModel:
    """Wrap a lowered :class:`OnnxFunction` as a :class:`LoadedModel`.

    ``cast_float=True`` stores lifted float params in bfloat16; integer
    params keep their dtype. The params start on the CPU and move to the
    card once, in ``bind_device``.
    """
    holder = {"params": params_from_numpy(
        fn.params, torch.device("cpu"),
        torch.bfloat16 if cast_float else None)}

    def bind_device(device):
        holder["params"] = {k: v.to(device)
                            for k, v in holder["params"].items()}
        fn.prepare(holder["params"])

    def apply(waveform):
        out = fn(waveform, params=holder["params"])
        if isinstance(out, tuple):
            scores, embeddings = out[0], out[1] if len(out) > 1 else None
        else:
            scores, embeddings = out, None
        scores = scores.float()
        result = {"scores": scores, "logits": scores}
        if embeddings is not None:
            result["embeddings"] = embeddings.float()
        else:
            result["embeddings"] = torch.zeros(
                (scores.shape[0], config.embedding_dim or 1),
                dtype=torch.float32, device=scores.device)
        return result

    return LoadedModel(config=config, labels=labels, apply=apply,
                       source=source, bind_device=bind_device)
