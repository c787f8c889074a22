"""The classifier: the port of ``birda_tpu/inference/classifier.py``.

Batched inference over one :class:`~birda_tpu_torch.models.zoo.LoadedModel`
with the same per-shape warm-up registry and the same streaming chunk
interface. The device step of a chunk is: int16 dequantization, the
optional device resampler, the windows (the native models' hop-grid mel
front-end, else an ``unfold`` view), the model, and a top-k; only ``[B, K]``
values/indices (and embeddings when a secondary head needs them) come back
to the host.

The host keeps decoding while the card computes: each chunk is copied from
a pinned host buffer with ``non_blocking=True``, the results come back the
same way, and :meth:`PendingChunk.collect` waits on a CUDA event recorded
after them.

With a ``mesh`` (``--devices``: an ordered list of replica devices) every
replica holds its own copy of the weights, every chunk is copied to each,
and replica ``i`` computes windows ``[i·B/N, (i+1)·B/N)``
(:func:`birda_tpu_torch.parallel.sharding.shard_data_parallel`).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..constants import (
    DEFAULT_MIN_CONFIDENCE,
    DEFAULT_TOP_K,
    compile_cache,
)
from ..errors import ClassifierBuild
from ..errors import Inference as InferenceErr
from .geomodel import GeomodelScores, MappingSummary
from .geomodel_filter import FilterSettings, Prediction, filter_predictions

from ..models.zoo import LoadedModel
from ..parallel.sharding import Gather, shard_data_parallel
from .backend import BackendStatus, select_backend

logger = logging.getLogger(__name__)


@dataclass
class InferenceOptions:
    min_confidence: float = DEFAULT_MIN_CONFIDENCE
    top_k: int = DEFAULT_TOP_K


@dataclass
class PredictionResult:
    """Per-segment predictions (+ embeddings when requested)."""

    predictions: list[Prediction]
    embeddings: Optional[np.ndarray] = None


@dataclass
class RangeFilterData:
    """Projected geomodel scores + policy, computed once at startup."""

    scores: GeomodelScores
    settings: FilterSettings
    summary: MappingSummary


@dataclass
class WarmupReport:
    batch_size: int
    seconds: float
    #: True when the first run took long enough to include a build (kernel
    #: compilation, library autotuning) rather than just the run.
    was_build: bool


class _WarmupRegistry:
    """Thread-safe set of already-warmed batch shapes."""

    def __init__(self):
        self._sizes: set[int] = set()
        self._lock = threading.Lock()

    def is_warm(self, batch_size: int) -> bool:
        with self._lock:
            return batch_size in self._sizes

    def mark_warm(self, batch_size: int) -> None:
        with self._lock:
            self._sizes.add(batch_size)


def _oom_error(batch_size: int, e: BaseException) -> InferenceErr:
    return InferenceErr(
        f"out of device memory at batch {batch_size} ({e}); halve the "
        f"batch size (--batch-size {max(1, batch_size // 2)})")


class BirdClassifier:
    """Batched classifier over one model graph."""

    def __init__(
        self,
        model: LoadedModel,
        device: str = "auto",
        min_confidence: float = DEFAULT_MIN_CONFIDENCE,
        top_k: int = DEFAULT_TOP_K,
        range_filter_data: Optional[RangeFilterData] = None,
        species_list: Optional[set[str]] = None,
        want_embeddings: bool = False,
        mesh=None,
    ):
        self.model = model
        if len(model.labels) != model.num_classes:
            raise ClassifierBuild(
                f"label count {len(model.labels)} does not match the model's "
                f"{model.num_classes} classes")
        self.labels = model.labels
        self.min_confidence = min_confidence
        self.top_k = min(top_k, model.num_classes)
        self.range_filter_data = range_filter_data
        self.species_list = species_list
        self.want_embeddings = want_embeddings
        self._warmed = _WarmupRegistry()
        self._warm_lock = threading.Lock()
        self._warmup_reports: list[WarmupReport] = []
        self._chunk_runners: dict[tuple, "ChunkRunner"] = {}
        self._chunk_runner_lock = threading.Lock()

        devices, status = select_backend(device)
        self.backend_status: BackendStatus = status
        #: The replica devices of --devices, or None for one device.
        self.mesh: Optional[list[torch.device]] = \
            list(mesh) if mesh is not None else None
        self.replicas: list[torch.device] = self.mesh or [devices[0]]
        self.device: torch.device = self.replicas[0]
        if getattr(model, "bind_device", None) is not None:
            for replica in dict.fromkeys(self.replicas):
                model.bind_device(replica)

    # -- introspection ------------------------------------------------------

    @property
    def sample_rate(self) -> int:
        return self.model.config.sample_rate

    @property
    def segment_duration(self) -> float:
        return self.model.config.segment_duration

    @property
    def sample_count(self) -> int:
        return self.model.config.sample_count

    def execution_provider_status(self) -> BackendStatus:
        return self.backend_status

    def range_filter_info(self) -> Optional[dict]:
        """Geomodel coverage record for the JSON protocol."""
        if self.range_filter_data is None:
            return None
        from ..constants import range_filter as rf_consts

        d = self.range_filter_data
        return {
            "geomodel_version": rf_consts.GEOMODEL_VERSION,
            "species_in_range": d.summary.in_range,
            "total_species": d.summary.total,
            "mapped_species": d.summary.mapped,
            "unmatched_species": d.summary.unmatched,
            "unmatched_policy": d.settings.unmatched.value,
            "threshold": d.settings.threshold,
        }

    # -- device step ----------------------------------------------------------

    def _step(self, waveform: torch.Tensor) -> tuple:
        """waveform [B, sample_count] -> (top-k values, indices[, emb])."""
        out = self.model.apply(waveform)
        vals, idx = torch.topk(out["scores"], self.top_k, dim=-1)
        if self.want_embeddings:
            return vals, idx, out["embeddings"]
        return vals, idx

    def _run_device(self, batch: np.ndarray) -> tuple[np.ndarray, ...]:
        """The step over a ``[B, sample_count]`` batch, rows sharded over
        the replicas; the outputs on the host."""
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))

        def shard(device, rows):
            with torch.inference_mode():
                return self._step(x[rows].to(device))

        try:
            return shard_data_parallel(shard, self.replicas)(
                x.shape[0]).wait()
        except torch.cuda.OutOfMemoryError as e:
            raise _oom_error(batch.shape[0], e) from e

    # -- warmup --------------------------------------------------------------

    def ensure_warm(self, batch_size: int) -> Optional[WarmupReport]:
        """Run this batch shape once before it carries real audio (kernel
        builds and library autotuning land here, not in the first batch)."""
        with self._warm_lock:
            if self._warmed.is_warm(batch_size):
                return None
            report = self._warmup(batch_size)
            self._warmed.mark_warm(batch_size)
            self._warmup_reports.append(report)
            return report

    def _warmup(self, batch_size: int) -> WarmupReport:
        dummy = np.zeros((batch_size, self.sample_count), np.float32)
        start = time.monotonic()
        try:
            self._run_device(dummy)
        except InferenceErr:
            raise
        except Exception as e:  # noqa: BLE001 — typed at the boundary
            raise InferenceErr(f"warmup inference failed: {e}") from e
        elapsed = time.monotonic() - start
        return WarmupReport(
            batch_size=batch_size, seconds=elapsed,
            was_build=elapsed >= compile_cache.BUILD_THRESHOLD_SECS)

    def warmup_reports(self) -> list[WarmupReport]:
        return list(self._warmup_reports)

    # -- prediction ----------------------------------------------------------

    def predict_batch(
        self,
        segments: np.ndarray,
        options: Optional[InferenceOptions] = None,
    ) -> list[PredictionResult]:
        """Run one padded ``[batch, sample_count]`` float32 batch; returns
        one result per input row."""
        options = options or InferenceOptions(self.min_confidence, self.top_k)
        if segments.ndim != 2 or segments.shape[1] != self.sample_count:
            raise InferenceErr(
                f"batch shape {segments.shape} does not match "
                f"[*, {self.sample_count}]")
        try:
            out = self._run_device(segments)
        except InferenceErr:
            raise
        except Exception as e:  # noqa: BLE001
            raise InferenceErr(str(e)) from e
        return _decode(self.labels, out, segments.shape[0], options)

    def predict(self, segment: np.ndarray,
                options: Optional[InferenceOptions] = None
                ) -> PredictionResult:
        """One ``[sample_count]`` segment through :meth:`predict_batch`."""
        return self.predict_batch(segment[None, :], options)[0]

    # -- chunked streaming path ---------------------------------------------

    def chunk_runner(self, batch_size: int, step_samples: int,
                     transport: str = "int16",
                     src_rate: Optional[int] = None,
                     src_chunk_samples: Optional[int] = None
                     ) -> "ChunkRunner":
        key = (batch_size, step_samples, transport, src_rate,
               src_chunk_samples)
        with self._chunk_runner_lock:
            cached = self._chunk_runners.get(key)
            if cached is None:
                cached = self._chunk_runners[key] = ChunkRunner(
                    self, batch_size, step_samples, transport, src_rate,
                    src_chunk_samples)
            return cached

    # -- post-filters ----------------------------------------------------------

    def apply_range_filter(
        self, results: list[PredictionResult]
    ) -> list[PredictionResult]:
        """Range filter if configured, else species-list retain, else no-op."""
        if self.range_filter_data is not None:
            d = self.range_filter_data
            for r in results:
                r.predictions = filter_predictions(
                    r.predictions, d.scores, d.settings
                )
        elif self.species_list is not None:
            for r in results:
                r.predictions = [
                    p for p in r.predictions if p.species in self.species_list
                ]
        return results


class ChunkRunner:
    """Streaming chunk interface over one classifier.

    The host ships one contiguous chunk of ``(batch-1)*step + sample_count``
    samples as int16 with a reconstruction scale (``src_rate`` set: at the
    source rate, resampled on the card); the card dequantizes, resamples,
    windows and runs the model. ``--jobs`` workers share one runner: the
    slot rotation, the fill of a pinned buffer and the enqueue of its
    copies hold a lock, so no two workers fill one buffer and no buffer is
    refilled while a copy out of it is in flight; the steps themselves are
    enqueued outside it.
    """

    #: Pinned host buffers in rotation: the host fills one while the copy
    #: from the other may still be in flight.
    N_HOST_BUFFERS = 2

    def __init__(self, classifier: BirdClassifier, batch_size: int,
                 step_samples: int, transport: str = "int16",
                 src_rate: Optional[int] = None,
                 src_chunk_samples: Optional[int] = None):
        from ..ops.resample import get_plan

        self.classifier = classifier
        self.batch_size = batch_size
        self.step_samples = step_samples
        self.transport = transport
        seg = classifier.sample_count
        model_rate = classifier.sample_rate
        self.src_rate = src_rate if src_rate is not None else model_rate
        self.resample_on_device = self.src_rate != model_rate
        self.chunk_model = (batch_size - 1) * step_samples + seg
        if self.resample_on_device:
            plan = get_plan(self.src_rate, model_rate)
            # Source chunk sized so its resampled length covers the model
            # chunk, plus one resampler period of slack (the JAX runner's
            # rule, including the producer's exact host chunk length).
            base = math.ceil(self.chunk_model * plan.M / plan.L) + plan.M
            self.chunk_samples = max(base, src_chunk_samples or 0)
        else:
            self.chunk_samples = self.chunk_model
        mel_cfg = classifier.model.mel_config
        # The native models' hop-grid mel front-end needs the window step
        # on the hop grid; otherwise the windows are framed one by one. It
        # runs in float32 on every device: the JAX package computes it in
        # bf16 only on a TPU, in float32 on a GPU and on the CPU.
        self._mel_cfg = (mel_cfg if mel_cfg is not None
                         and step_samples % mel_cfg.hop == 0 else None)

        self._replicas = classifier.replicas
        if batch_size % len(self._replicas) != 0:
            raise ValueError(
                f"chunk runner batch {batch_size} not divisible by mesh "
                f"size {len(self._replicas)}")
        self._on_card = any(d.type == "cuda" for d in self._replicas)
        dtype = torch.int16 if transport == "int16" else torch.float32
        self._host = [torch.empty(self.chunk_samples, dtype=dtype,
                                  pin_memory=self._on_card)
                      for _ in range(self.N_HOST_BUFFERS)]
        #: Per buffer, the events after the last copies out of it.
        self._copied: list[list[torch.cuda.Event]] = \
            [[] for _ in range(self.N_HOST_BUFFERS)]
        self._next = 0
        self._fill_lock = threading.Lock()
        self._warm = False
        self._warm_lock = threading.Lock()

    def _step(self, chunk: torch.Tensor, scale: float, rows: slice) -> tuple:
        """The device step of windows ``rows`` of the chunk: chunk
        [chunk_samples] -> (values, indices[, embeddings]) for those
        overlapped windows."""
        clf = self.classifier
        seg, step = clf.sample_count, self.step_samples
        if self.transport == "int16":
            x = chunk.float() * scale
        else:
            x = chunk * scale
        if self.resample_on_device:
            from ..ops.resample import resample_device

            x = resample_device(x[None, :], self.src_rate,
                                clf.sample_rate)[0]
            x = x[:self.chunk_model]
        n = rows.stop - rows.start
        span = x[rows.start * step:rows.start * step + (n - 1) * step + seg]
        if self._mel_cfg is not None:
            from ..ops.melspec import melspec_from_chunk

            return clf._step(melspec_from_chunk(span, self._mel_cfg, n, step,
                                                seg))
        return clf._step(span.unfold(0, seg, step))

    def _upload(self, payload: np.ndarray) -> dict:
        """The payload on every replica device: ``{device: chunk}``."""
        devices = dict.fromkeys(self._replicas)
        if not self._on_card:
            chunk = torch.from_numpy(np.array(payload))
            return {d: chunk for d in devices}
        with self._fill_lock:
            slot = self._next
            self._next = (slot + 1) % self.N_HOST_BUFFERS
            for event in self._copied[slot]:
                event.synchronize()  # the last copies out of this buffer
            host = self._host[slot]
            host.numpy()[:] = payload
            chunks, events = {}, []
            for device in devices:
                with torch.cuda.device(device):
                    chunks[device] = host.to(device, non_blocking=True)
                    events.append(torch.cuda.Event())
                    events[-1].record()
            self._copied[slot] = events
        return chunks

    def _dispatch(self, payload: np.ndarray, scale: float) -> Gather:
        """Copy the payload to the replicas and enqueue each one's step."""
        chunks = self._upload(payload)

        def shard(device, rows):
            with torch.inference_mode():
                return self._step(chunks[device], scale, rows)

        try:
            return shard_data_parallel(shard, self._replicas)(
                self.batch_size)
        except torch.cuda.OutOfMemoryError as e:
            raise _oom_error(self.batch_size, e) from e

    def ensure_warm(self) -> Optional[WarmupReport]:
        with self._warm_lock:
            if self._warm:
                return None
            start = time.monotonic()
            dtype = np.int16 if self.transport == "int16" else np.float32
            self._dispatch(np.zeros(self.chunk_samples, dtype), 1.0).wait()
            elapsed = time.monotonic() - start
            self._warm = True
            return WarmupReport(
                batch_size=self.batch_size, seconds=elapsed,
                was_build=elapsed >= compile_cache.BUILD_THRESHOLD_SECS)

    def predict_chunk_async(
        self, chunk: np.ndarray, n_real: int,
        options: Optional[InferenceOptions] = None,
    ) -> "PendingChunk":
        """Dispatch a chunk without waiting for its results; the host goes
        on decoding while the card computes. Collect with
        :meth:`PendingChunk.collect`."""
        options = options or InferenceOptions(
            self.classifier.min_confidence, self.classifier.top_k)
        payload, scale = self._quantize(chunk)
        if self.transport == "int16":
            # The JAX step's float32 arithmetic: scale / 32767 in float32.
            scale = np.float32(scale) / np.float32(32767.0)
        try:
            out = self._dispatch(payload, float(scale))
        except InferenceErr:
            raise
        except Exception as e:  # noqa: BLE001
            raise InferenceErr(str(e)) from e
        return PendingChunk(self, out, n_real, options)

    def _quantize(self, chunk: np.ndarray):
        chunk = np.asarray(chunk, np.float32)
        if len(chunk) < self.chunk_samples:
            chunk = np.concatenate(
                [chunk, np.zeros(self.chunk_samples - len(chunk), np.float32)])
        elif len(chunk) > self.chunk_samples:
            raise InferenceErr(
                f"chunk of {len(chunk)} exceeds runner size "
                f"{self.chunk_samples}")
        if self.transport != "int16":
            return chunk, np.float32(1.0)
        from ..native import audio as native_audio

        if native_audio.available():
            payload, amax = native_audio.quantize_int16(chunk)
            return payload, np.float32(amax if amax >= 1e-9 else 0.0)
        # Without the native library: the JAX runner's numpy arithmetic
        # (float32 scale, round half to even, clip), in torch's threaded
        # CPU kernels.
        x = torch.from_numpy(chunk)
        amax = float(x.abs().max())
        if amax < 1e-9:
            return np.zeros(self.chunk_samples, np.int16), np.float32(0.0)
        payload = torch.round(x * (32767.0 / amax)).clamp_(-32767, 32767)
        return payload.to(torch.int16).numpy(), np.float32(amax)

    def predict_chunk(
        self, chunk: np.ndarray, n_real: int,
        options: Optional[InferenceOptions] = None,
    ) -> list[PredictionResult]:
        """Run one chunk of model-rate f32 audio; returns ``n_real``
        results (a chunk shorter than ``chunk_samples`` is zero-padded)."""
        return self.predict_chunk_async(chunk, n_real, options).collect()


def _effective_top_k(options: "InferenceOptions", built_k: int) -> int:
    """Honor a caller-supplied top_k: a smaller request truncates the
    device's top-``built_k``; a larger one is a hard error."""
    k = getattr(options, "top_k", None)
    if k is None or k == built_k:
        return built_k
    if k > built_k:
        raise InferenceErr(
            f"top_k={k} exceeds the compiled top-k of {built_k}; rebuild "
            "the classifier with a larger top_k")
    return max(1, int(k))


def _decode(labels: list[str], out: tuple, n_rows: int,
            options: InferenceOptions) -> list[PredictionResult]:
    vals, idx = out[0], out[1]
    emb = out[2] if len(out) > 2 else None
    k = _effective_top_k(options, vals.shape[1])
    results = []
    for row in range(n_rows):
        preds = [
            Prediction(species=labels[int(i)], confidence=float(v),
                       index=int(i))
            for v, i in zip(vals[row][:k], idx[row][:k])
            if v >= options.min_confidence
        ]
        results.append(PredictionResult(
            predictions=preds,
            embeddings=emb[row] if emb is not None else None))
    return results


class PendingChunk:
    """In-flight device work for one chunk (see ``predict_chunk_async``)."""

    def __init__(self, runner: ChunkRunner, out: Gather, n_real: int,
                 options: InferenceOptions):
        self._runner = runner
        self._out = out
        self._n_real = n_real
        self._options = options

    def collect(self) -> list[PredictionResult]:
        """Wait for the device results and decode them."""
        try:
            out = self._out.wait()
        except torch.cuda.OutOfMemoryError as e:
            raise _oom_error(self._runner.batch_size, e) from e
        except Exception as e:  # noqa: BLE001
            raise InferenceErr(str(e)) from e
        return _decode(self._runner.classifier.labels, out,
                       min(self._n_real, self._runner.batch_size),
                       self._options)
