"""Model zoo: the port of ``birda_tpu/models/zoo.py``.

A :class:`LoadedModel` is what the classifier consumes: ``apply(waveform
[B, sample_count]) -> {"scores", "logits", "embeddings"}`` (float32 tensors
on the waveform's device) plus its contract and labels. Two construction
paths, as in the JAX module:

- :func:`native_model` / :func:`tiny_model` — the native architecture
  (:mod:`.backbone`) with deterministic synthetic weights (the
  ``synthetic:`` model paths), the JAX package's weights bit for bit;
- :func:`onnx_model` / :func:`onnx_model_int8` — an exported ONNX graph
  through the torch lowering.

Either keeps one copy of its weights per device it runs on, so replicas on
several devices (``--devices``) each compute with their own.
"""

from __future__ import annotations

import copy
import logging
import os
import threading
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..ops.melspec import MelSpecConfig
from . import contracts
from .backbone import AudioClassifier, flax_leaves, load_flax_leaf
from .contracts import ModelConfig, ModelFamily

logger = logging.getLogger(__name__)

#: Mel front-end defaults per family (native path; the real graphs carry
#: their own front-end in-graph and go through the ONNX path instead).
#: Hops divide the segment length so the chunk runner's hop-grid framing
#: applies at zero overlap (144000 % 576 == 0, 160000 % 640 == 0).
MEL_CONFIGS = {
    ModelFamily.BIRDNET_V24: MelSpecConfig(sample_rate=48_000, n_fft=1024,
                                           hop=576, n_mels=128, fmax=15_000.0),
    ModelFamily.BSG_FI_V44: MelSpecConfig(sample_rate=48_000, n_fft=1024,
                                          hop=576, n_mels=128, fmax=15_000.0),
    ModelFamily.BIRDNET_V30: MelSpecConfig(sample_rate=32_000, n_fft=1024,
                                           hop=640, n_mels=128, fmax=16_000.0),
    ModelFamily.PERCH_V2: MelSpecConfig(sample_rate=32_000, n_fft=1024,
                                        hop=640, n_mels=128, fmax=16_000.0),
}


@dataclass
class LoadedModel:
    """A ready-to-run classifier graph."""

    config: ModelConfig
    labels: list[str]
    #: waveform [batch, sample_count] -> {"scores", "logits", "embeddings"},
    #: on the waveform's device with that device's copy of the weights
    apply: Callable[[Any], dict]
    #: human-readable source ("native-synthetic", "native-weights", "onnx")
    source: str = "onnx"
    #: mel front-end config when apply() also takes precomputed [B, F, M]
    #: mel (native models); None for opaque graphs (ONNX).
    mel_config: object = None
    #: place a copy of the weights on a ``torch.device`` now rather than at
    #: its first ``apply`` there (one copy per device, shared by every batch
    #: shape). The classifier calls this for each of its devices.
    bind_device: Callable[[torch.device], Any] | None = None
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


class _PerDevice:
    """One copy of a model's weights per ``torch.device``, made by
    ``make(device)`` on first use; thread-safe (``--jobs`` workers and
    replicas share it)."""

    def __init__(self, make: Callable[[torch.device], Any]):
        self._make = make
        self._copies: dict[torch.device, Any] = {}
        self._lock = threading.Lock()

    def __call__(self, device: torch.device):
        with self._lock:
            hit = self._copies.get(device)
            if hit is None:
                hit = self._copies[device] = self._make(device)
            return hit


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
    params keep their dtype. The params start on the CPU; each device gets
    its own copy, with the kernels' weight layouts made once for it.
    """
    host = params_from_numpy(fn.params, torch.device("cpu"),
                             torch.bfloat16 if cast_float else None)

    def to_device(device):
        if device.type == "cpu":
            return host
        params = {k: v.to(device) for k, v in host.items()}
        fn.prepare(params)
        return params

    params_on = _PerDevice(to_device)

    def apply(waveform):
        out = fn(waveform, params=params_on(waveform.device))
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
                       source=source, bind_device=params_on)


# ---------------------------------------------------------------------------
# The native family
# ---------------------------------------------------------------------------

def _synthesize_params(module: AudioClassifier, seed: int) -> dict:
    """The JAX package's deterministic weights for ``module``, as its flax
    variables tree (nested dicts of float32 numpy arrays, flax layouts).

    Each leaf is seeded from its flax path, ``zlib.crc32(path) ^ (seed *
    2654435761)`` masked to 32 bits (crc32, not ``hash()``: str hashing is
    salted per process): norm scales and variances are ones, biases and
    means zeros, tensors of rank >= 2 fan-in-scaled normals drawn in flax's
    shape, anything else zeros. The port has no flax: the tree is the one
    :func:`~.backbone.flax_leaves` enumerates from the module itself.
    """
    variables: dict = {}
    for path, shape, _ in flax_leaves(module):
        names = path.split("/")
        leaf_name = names[-1]
        key = zlib.crc32(path.encode()) ^ (seed * 2654435761)
        rng = np.random.default_rng(key & 0xFFFFFFFF)
        if leaf_name in ("scale", "var"):
            arr = np.ones(shape, np.float32)
        elif leaf_name in ("bias", "mean"):
            arr = np.zeros(shape, np.float32)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.normal(0.0, (1.0 / max(fan_in, 1)) ** 0.5, shape)
            arr = arr.astype(np.float32)
        else:
            arr = np.zeros(shape, np.float32)
        node = variables
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[leaf_name] = arr
    return variables


def native_params_from_flax(module: AudioClassifier, variables) -> None:
    """Load a flax variables tree (``{"params": ..., "batch_stats": ...}``
    with numpy leaves in flax layouts, as the JAX package's native model
    holds them) into ``module``, in place."""
    for path, _, t in flax_leaves(module):
        node = variables
        for name in path.split("/"):
            node = node[name]
        load_flax_leaf(t, node)


def native_model(
    family: ModelFamily | str,
    params=None,
    labels: list[str] | None = None,
    dtype: torch.dtype | None = torch.float32,
    seed: int = 0,
    blocks=None,
) -> LoadedModel:
    """The native model of a family, computing in ``dtype`` (float32 by
    default; ``torch.bfloat16`` runs its convs and products in bf16 over
    float32 parameters, as the flax modules' ``dtype`` does).

    With ``params=None`` the weights are synthesized from ``seed`` (the
    ``synthetic:`` path of tests and benchmarks: contract- and
    FLOP-faithful, not score-faithful); else ``params`` is a flax variables
    tree (:func:`native_params_from_flax`).
    """
    family = ModelFamily(family)
    cfg = contracts.contract_for(family)
    kwargs = {} if blocks is None else {"blocks": blocks}
    module = AudioClassifier(
        mel=MEL_CONFIGS[family],
        num_classes=cfg.num_classes,
        embedding_dim=cfg.embedding_dim or 1024,
        activation=cfg.activation.value,
        dtype=dtype or torch.float32,
        **kwargs,
    ).eval()
    if params is None:
        params = _synthesize_params(module, seed)
        source = "native-synthetic"
    else:
        source = "native-weights"
    native_params_from_flax(module, params)

    modules = _PerDevice(lambda device: module if device.type == "cpu"
                         else copy.deepcopy(module).to(device))

    def apply(waveform):
        from ..onnx.lowering import _full_precision

        with _full_precision():  # float32 products, TF32 off
            return modules(waveform.device)(waveform)

    return LoadedModel(
        config=cfg,
        labels=labels or synthetic_labels(cfg.num_classes),
        apply=apply,
        source=source,
        mel_config=MEL_CONFIGS[family],
        bind_device=modules,
    )


# ---------------------------------------------------------------------------
# Tiny variants for tests: same contracts, ~1000x fewer FLOPs.
# ---------------------------------------------------------------------------

TINY_BLOCKS = ((16, 1, 3, 2, 1), (24, 1, 3, 2, 2), (40, 1, 3, 2, 2))


def tiny_model(family: ModelFamily | str = ModelFamily.BIRDNET_V24,
               seed: int = 0, dtype: torch.dtype | None = torch.float32
               ) -> LoadedModel:
    """Contract-exact but tiny — the fixture-model equivalent for CI."""
    return native_model(family, seed=seed, dtype=dtype, blocks=TINY_BLOCKS)
