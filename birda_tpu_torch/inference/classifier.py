"""The classifier: the port of ``birda_tpu/inference/classifier.py``.

Batched inference over one :class:`~birda_tpu_torch.models.zoo.LoadedModel`
on one ``torch.device``, with the same per-shape warm-up registry and the
same streaming chunk interface. The device step of a chunk is: int16
dequantization, the optional device resampler, the overlapped windows as an
``unfold`` view, the model, and a top-k; only ``[B, K]`` values/indices
(and embeddings when a secondary head needs them) come back to the host.

The host keeps decoding while the card computes: each chunk is copied from
a pinned host buffer with ``non_blocking=True`` and :meth:`PendingChunk.collect`
waits on a CUDA event recorded after the step.
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
from .geomodel_filter import Prediction

from ..models.zoo import LoadedModel
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


def _to_host(out: tuple) -> tuple[np.ndarray, ...]:
    return tuple(o.cpu().numpy() for o in out)


class BirdClassifier:
    """Batched classifier over one model graph."""

    def __init__(
        self,
        model: LoadedModel,
        device: str = "auto",
        min_confidence: float = DEFAULT_MIN_CONFIDENCE,
        top_k: int = DEFAULT_TOP_K,
        species_list: Optional[set[str]] = None,
        want_embeddings: bool = False,
    ):
        self.model = model
        if len(model.labels) != model.num_classes:
            raise ClassifierBuild(
                f"label count {len(model.labels)} does not match the model's "
                f"{model.num_classes} classes")
        self.labels = model.labels
        self.min_confidence = min_confidence
        self.top_k = min(top_k, model.num_classes)
        self.species_list = species_list
        self.want_embeddings = want_embeddings
        self._warmed = _WarmupRegistry()
        self._warm_lock = threading.Lock()
        self._warmup_reports: list[WarmupReport] = []
        self._chunk_runners: dict[tuple, "ChunkRunner"] = {}
        self._chunk_runner_lock = threading.Lock()

        devices, status = select_backend(device)
        self.backend_status: BackendStatus = status
        self.device: torch.device = devices[0]
        if getattr(model, "bind_device", None) is not None:
            model.bind_device(self.device)

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

    # -- device step ----------------------------------------------------------

    def _step(self, waveform: torch.Tensor) -> tuple:
        """waveform [B, sample_count] -> (top-k values, indices[, emb])."""
        out = self.model.apply(waveform)
        vals, idx = torch.topk(out["scores"], self.top_k, dim=-1)
        if self.want_embeddings:
            return vals, idx, out["embeddings"]
        return vals, idx

    def _run_device(self, batch: np.ndarray) -> tuple:
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        try:
            with torch.inference_mode():
                return self._step(x.to(self.device))
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
            _to_host(self._run_device(dummy))
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
            out = _to_host(self._run_device(segments))
        except InferenceErr:
            raise
        except Exception as e:  # noqa: BLE001
            raise InferenceErr(str(e)) from e
        return _decode(self.labels, out, segments.shape[0], options)

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
        """Species-list retain when a list is set, else a no-op (the
        geomodel range filter is not ported yet; the processor calls this
        by the JAX classifier's name)."""
        if self.species_list is not None:
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
    windows and runs the model.
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

        self._device = classifier.device
        dtype = torch.int16 if transport == "int16" else torch.float32
        pinned = self._device.type == "cuda"
        self._host = [torch.empty(self.chunk_samples, dtype=dtype,
                                  pin_memory=pinned)
                      for _ in range(self.N_HOST_BUFFERS)]
        self._copied: list[Optional[torch.cuda.Event]] = \
            [None] * self.N_HOST_BUFFERS
        self._next = 0
        self._warm = False
        self._warm_lock = threading.Lock()

    def _step(self, chunk: torch.Tensor, scale: float) -> tuple:
        """The device step: chunk [chunk_samples] -> (values, indices[,
        embeddings]) for ``batch_size`` overlapped windows."""
        clf = self.classifier
        if self.transport == "int16":
            x = chunk.float() * scale
        else:
            x = chunk * scale
        if self.resample_on_device:
            from ..ops.resample import resample_device

            x = resample_device(x[None, :], self.src_rate,
                                clf.sample_rate)[0]
            x = x[:self.chunk_model]
        frames = x.unfold(0, clf.sample_count, self.step_samples)
        return clf._step(frames)

    def _dispatch(self, payload: np.ndarray, scale: float) -> tuple:
        """Copy the payload to the card and enqueue the step."""
        slot = self._next
        self._next = (slot + 1) % self.N_HOST_BUFFERS
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # the last copy out of it
        host = self._host[slot]
        host.numpy()[:] = payload
        chunk = host.to(self._device, non_blocking=True)
        if self._device.type == "cuda":
            self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record()
        try:
            with torch.inference_mode():
                return self._step(chunk, scale)
        except torch.cuda.OutOfMemoryError as e:
            raise _oom_error(self.batch_size, e) from e

    def ensure_warm(self) -> Optional[WarmupReport]:
        with self._warm_lock:
            if self._warm:
                return None
            start = time.monotonic()
            dtype = np.int16 if self.transport == "int16" else np.float32
            _to_host(self._dispatch(np.zeros(self.chunk_samples, dtype), 1.0))
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
        done = None
        if self._device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return PendingChunk(self, out, n_real, options, done)

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

    def __init__(self, runner: ChunkRunner, out: tuple, n_real: int,
                 options: InferenceOptions,
                 done: Optional[torch.cuda.Event] = None):
        self._runner = runner
        self._out = out
        self._n_real = n_real
        self._options = options
        self._done = done

    def collect(self) -> list[PredictionResult]:
        """Wait for the device results and decode them."""
        try:
            if self._done is not None:
                self._done.synchronize()
            out = _to_host(self._out)
        except torch.cuda.OutOfMemoryError as e:
            raise _oom_error(self._runner.batch_size, e) from e
        except Exception as e:  # noqa: BLE001
            raise InferenceErr(str(e)) from e
        return _decode(self._runner.classifier.labels, out,
                       min(self._n_real, self._runner.batch_size),
                       self._options)
