"""Model zoo: the port of ``birda_tpu/models/zoo.py`` for ONNX graphs.

A :class:`LoadedModel` is what the classifier consumes: ``apply(waveform
[B, sample_count]) -> {"scores", "logits", "embeddings"}`` (float32 tensors
on the waveform's device) plus its contract and labels. The JAX module
imports jax and flax at load, so its ONNX path is ported here with the same
fields and names; the native flax backbone is not part of this port.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from .contracts import ModelConfig

logger = logging.getLogger(__name__)

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
    #: reduced-precision observability: {"mode": "bf16"}, the int8/mixed
    #: selection counts (:func:`onnx_model_int8`), or None for fp32.
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


def onnx_model_int8(
    path: Path | str | bytes,
    config: ModelConfig,
    labels: list[str],
    calibration,
    compute_dtype: torch.dtype | None = None,
    storage_only: bool = False,
) -> LoadedModel:
    """Load an ONNX graph with calibrated int8 execution (the TensorRT-int8
    analogue; see :mod:`birda_tpu_torch.onnx.quantize` for the scheme and
    the selection rules).

    ``calibration`` is a
    :class:`~birda_tpu_torch.onnx.quantize.CalibrationResult`.
    ``compute_dtype`` governs the non-quantized ops (``torch.bfloat16``, or
    None for fp32); quantized weights live as int8.

    ``storage_only=True`` is ``--precision mixed``: no node quantizes —
    compute (and weights) stay at ``compute_dtype`` and the calibration
    scales only back int8 *storage* of the large boundary streams
    (``boundary_store="storage"``).
    """
    from ..onnx.quantize import int8_throughput_advisory, lower_int8

    # The boundary-storage policy can be re-tuned for a real export
    # without a code change (the JAX package's knob); mixed mode IS a
    # storage policy, so the knob does not apply there.
    if storage_only:
        boundary = "storage"
    else:
        boundary = os.environ.get("BIRDA_INT8_BOUNDARY", "all")
    fn = lower_int8(path if isinstance(path, bytes) else str(path),
                    calibration, compute_dtype=compute_dtype,
                    boundary_store=boundary)
    model = _loaded_from_onnx_fn(fn, config, labels,
                                 cast_float=compute_dtype == torch.bfloat16,
                                 source="onnx-mixed" if storage_only
                                 else "onnx-int8")
    model.precision_info = {
        "mode": "mixed" if storage_only else "int8",
        "quantized_nodes": len(fn.quantized_nodes),
        "int8_boundary_tensors": len(fn.int8_boundary_tensors),
        "boundary_store": boundary,
        "skipped_nodes": len(fn.skipped_nodes),
    }
    if storage_only:
        # Mixed mode never attempts node quantization (the selection gates
        # are forced shut), so "skipped" counts would misread as selection
        # failures; and the advisory below is about int8 COMPUTE epilogues,
        # which mixed has none of.
        del model.precision_info["skipped_nodes"]
        return model
    # Static throughput advisory, evaluated at the large-batch shape where
    # the weight savings are fully amortized: it runs the graph on meta
    # tensors (shapes only). As in the JAX package, it never blocks a load.
    try:
        probe = torch.empty((256, config.sample_count), dtype=torch.float32,
                            device="meta")
        advisory = int8_throughput_advisory(fn, probe)
    except Exception:  # noqa: BLE001 — advisory must never block a load
        advisory = None
    if advisory is not None:
        logger.warning("--precision int8: %s", advisory["message"])
        model.precision_info["advisory"] = {
            "compute_shaped": True,
            "intensity_flop_per_byte": round(
                advisory["intensity_flop_per_byte"], 1),
        }
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
