"""Per-file streaming processing: the port of
``birda_tpu/pipeline/processor.py`` onto the PyTorch classifier.

The same two-stage host pipeline per file (a decode thread streams
overlapped windows into a bounded queue; the consumer assembles chunks for
the chunk runner, keeps one chunk in flight on the card while the host
decodes the next, thresholds, sorts and writes), with two differences:
the classifier is :class:`birda_tpu_torch.inference.classifier.BirdClassifier`
(its ``mesh`` is a list of replica devices), and the output writers are
imported only for the formats a run asks for (a run without parquet never
imports pyarrow).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import constants
from ..audio.decode import (
    StreamingDecoder,
    emitted_window_count,
    normalize_window,
    put_abortable,
)
from ..errors import BirdaError
from ..inference.watchdog import start_inference_watchdog
from ..locking.file_lock import FileLock
from ..output import json_envelope as env
from ..output.types import Detection
from ..pipeline.config import ProcessingConfig
from ..pipeline.coordinator import OutputFormat, output_path_for

from ..inference.classifier import BirdClassifier, InferenceOptions

logger = logging.getLogger(__name__)


@dataclass
class ProcessResult:
    detections: int
    segments: int
    duration_secs: float
    audio_duration_secs: float

    @property
    def segments_per_sec(self) -> float:
        return self.segments / self.duration_secs if self.duration_secs > 0 else 0.0

    @property
    def realtime_factor(self) -> float:
        if self.duration_secs > 0 and self.audio_duration_secs > 0:
            return self.audio_duration_secs / self.duration_secs
        return 0.0


_SENTINEL = object()


def _decode_and_stream(
    decoder: StreamingDecoder,
    tx: queue.Queue,
    abort: threading.Event,
    seg_samples_src: int,
    ovl_samples_src: int,
    target_rate: int,
    target_count: int,
    resample_needed: bool,
):
    """HOT LOOP A (producer): decode -> resample -> exact-length -> send.

    Blocking ``put`` is the backpressure; any exception is shipped in-band.
    ``abort`` unblocks the puts when the consumer stops draining — the
    consumer joins this thread before closing the shared decoder, so the
    native handle is never freed under a live read.
    """
    try:
        while not abort.is_set():
            seg = decoder.next_segment(seg_samples_src, ovl_samples_src)
            if seg is None:
                break
            samples = normalize_window(
                seg.samples, decoder.sample_rate, target_rate, target_count,
                resample_needed,
            )
            if not put_abortable(tx, (samples, seg.start_sample), abort):
                return
    except BaseException as e:  # noqa: BLE001 — shipped to the consumer
        put_abortable(tx, e, abort)
    finally:
        put_abortable(tx, _SENTINEL, abort)


def _use_parallel_decode(n_workers: int, bat_mode: bool, total_frames,
                         exact_seek: bool, est_segments: int) -> bool:
    """Parallel span decode only when the file is long enough to split,
    its length is known (seek targets need the window grid), the codec
    seeks exactly, and we are NOT in bat mode (the bat window contract
    keeps the reference single-thread decode path)."""
    return (
        n_workers > 1
        and not bat_mode
        and total_frames is not None
        and exact_seek
        and est_segments >= 2 * n_workers
    )


def process_file(classifier: BirdClassifier, config: ProcessingConfig) -> ProcessResult:
    """Process one audio file end to end. Caller handles ``FileLocked``."""
    start_time = time.monotonic()

    # After the lock acquire, so a skipped (locked) file does not announce
    # itself; visible at the DEFAULT verbosity, like the reference's
    # info-level filter (processor.rs:445).
    lock = FileLock.acquire(config.input_path, config.output_dir)
    logger.info("Processing: %s", config.input_path)
    decoder = None
    producer = None
    tx = None
    abort = threading.Event()
    try:
        decoder = StreamingDecoder(config.input_path)
        src_rate = decoder.sample_rate

        if config.bat_mode:
            seg_duration = constants.bat.SEGMENT_DURATION
            overlap = constants.bat.OVERLAP
            seg_samples_src = constants.bat.CHUNK_SAMPLES
            ovl_samples_src = int(round(overlap * src_rate))
            target_count = constants.bat.CHUNK_SAMPLES
            resample_needed = False
            target_rate = src_rate
        else:
            seg_duration = classifier.segment_duration
            overlap = config.overlap
            seg_samples_src = int(round(seg_duration * src_rate))
            ovl_samples_src = int(round(overlap * src_rate))
            target_count = classifier.sample_count
            target_rate = classifier.sample_rate
            resample_needed = src_rate != target_rate

        audio_duration = decoder.duration_secs or 0.0
        step_secs = max(seg_duration - overlap, 1e-9)
        if decoder.total_frames:
            # Exact (mirrors the decoder's window arithmetic, including the
            # trailing overlap-only window) so progress never exceeds 100%.
            est_segments = max(1, emitted_window_count(
                decoder.total_frames, seg_samples_src, ovl_samples_src
            ))
        elif audio_duration > 0:
            import math

            est_segments = (
                1 if audio_duration <= seg_duration
                else math.ceil((audio_duration - seg_duration) / step_secs) + 1
            )
        else:
            est_segments = 1

        # Effective batch: no point padding a 10-segment file to batch 256
        # (reference processor.rs:527-545) — but every distinct batch shape
        # warms its own runner (pinned buffers, kernel layouts, library
        # autotuning), so quantize to a power-of-two ladder: a directory of
        # odd-length files shares a handful of runners instead of one per
        # file length.
        effective_batch = max(1, min(config.batch_size, est_segments))
        effective_batch = min(
            1 << (effective_batch - 1).bit_length() if effective_batch > 1 else 1,
            config.batch_size,
        )
        if classifier.mesh is not None:
            from ..parallel.mesh import pad_to_multiple

            effective_batch = pad_to_multiple(effective_batch, classifier.mesh)

        # Window step at the model rate drives the chunked device path: the
        # host ships each audio sample once (int16) and the device does the
        # overlapped windowing fused with the model.
        overlap_model = int(round(overlap * target_rate))
        step_model = max(1, target_count - overlap_model)
        step_src = max(1, seg_samples_src - ovl_samples_src)
        runner = None
        if config.use_chunk_runner:
            # Ship source-rate chunks and resample on device: the host's
            # only per-sample work is the decode itself. The runner's host
            # chunk capacity comes from OUR window geometry — the source
            # step is rounded independently of the model step, so a
            # capacity derived only from model-side numbers can overflow
            # at large batch (0.3 samples/window of rounding adds up).
            src_chunk = (
                (effective_batch - 1) * step_src + seg_samples_src
                if resample_needed else None
            )
            runner = classifier.chunk_runner(
                effective_batch, step_model,
                src_rate=src_rate if resample_needed else None,
                src_chunk_samples=src_chunk,
            )
            runner.ensure_warm()
            if runner.resample_on_device:
                resample_needed = False  # producer ships raw source windows
        else:
            classifier.ensure_warm(effective_batch)

        # With device-side resampling the producer ships raw source-rate
        # windows; otherwise it resamples each window to the model rate.
        producer_count = (
            seg_samples_src
            if runner is not None and runner.resample_on_device
            else target_count
        )

        tx: queue.Queue = queue.Queue(
            maxsize=constants.audio.QUEUE_BATCH_CAPACITY * effective_batch
        )
        # Parallel span decode when the file is long enough to split and its
        # length is known (seek targets need the window grid). Bat mode and
        # short files keep the single-thread path.
        n_workers = max(1, config.decode_workers)
        use_parallel = _use_parallel_decode(
            n_workers, config.bat_mode, decoder.total_frames,
            decoder.exact_seek, est_segments,
        )
        if use_parallel:
            from ..audio.parallel_decode import spawn_parallel_decode

            producer = spawn_parallel_decode(
                config.input_path, tx, _SENTINEL, decoder.total_frames,
                seg_samples_src, ovl_samples_src,
                target_rate, producer_count, resample_needed,
                n_workers, abort=abort,
            )
        else:
            producer = threading.Thread(
                target=_decode_and_stream,
                args=(decoder, tx, abort, seg_samples_src, ovl_samples_src,
                      target_rate, producer_count, resample_needed),
                daemon=True,
                name="birda-decode",
            )
            producer.start()

        # BSG SDM day-of-year: resolved once per file — auto-detected from
        # the file's mtime when not given (reference processor.rs:476-495;
        # each file in a batch can carry a different day).
        resolved_bsg = config.bsg_params
        if (config.bsg_processor is not None and resolved_bsg is not None
                and resolved_bsg[2] is None):
            from ..utils.date import auto_detect_day_of_year

            try:
                day = auto_detect_day_of_year(config.input_path)
                logger.debug("Auto-detected day-of-year: %d", day)
                resolved_bsg = (resolved_bsg[0], resolved_bsg[1], day)
            except BirdaError as e:
                logger.warning("%s, SDM will not be applied", e)

        # BSG calibration can RAISE confidences, and the reference applies
        # it before thresholding (processor.rs:284-318) — so with a BSG
        # processor active the device-side cut keeps every top-k prediction
        # and finalize() thresholds the calibrated values instead.
        device_min_conf = (
            0.0 if config.bsg_processor is not None else config.min_confidence
        )
        options = InferenceOptions(
            min_confidence=device_min_conf, top_k=classifier.top_k
        )
        detections: list[Detection] = []
        segments_done = 0
        batch_samples: list[np.ndarray] = []
        batch_starts: list[int] = []
        # One chunk stays in flight on the device while the host decodes and
        # assembles the next (double buffering: the card runs asynchronously).
        pending: list[tuple] = []

        def finalize(handle, starts):
            nonlocal segments_done
            with start_inference_watchdog(
                effective_batch, config.watchdog_timeout
            ):
                results = handle.collect()
            # BSG post-processing precedes range filtering (reference
            # processor.rs:284-318): calibration always; SDM only when
            # location + day resolved.
            if config.bsg_processor is not None:
                bsg = config.bsg_processor
                for r in results:
                    if resolved_bsg is not None and resolved_bsg[2] is not None:
                        r.predictions = bsg.process(
                            r.predictions, resolved_bsg[0], resolved_bsg[1],
                            resolved_bsg[2],
                        )
                    else:
                        r.predictions = bsg.calibrate(r.predictions)
            results = classifier.apply_range_filter(results)
            if config.custom_classifier is not None:
                results = config.custom_classifier.reclassify(results)
            for res, start_sample in zip(results, starts):
                t0 = start_sample / src_rate
                t1 = t0 + seg_duration
                for p in res.predictions:
                    if p.confidence >= config.min_confidence:
                        detections.append(
                            Detection.from_label(
                                p.species, p.confidence, t0, t1,
                                config.input_path,
                            )
                        )
            segments_done += len(starts)
            progress_sink = config.progress_reporter or config.reporter
            if progress_sink is not None and est_segments:
                progress_sink.progress(
                    file=env.file_progress(
                        str(config.input_path), segments_done, est_segments
                    )
                )

        class _SyncHandle:
            """Adapter so the legacy batch path flows through finalize()."""

            def __init__(self, results):
                self._results = results

            def collect(self):
                return self._results

        def flush_batch():
            if not batch_samples:
                return
            n_real = len(batch_samples)
            if runner is not None:
                # Reassemble the contiguous stream by PLACING each window
                # at its true offset — each sample crosses the link exactly
                # once. Every window here is on the uniform source grid
                # (off-grid tail windows were flushed into their own
                # single-window chunks by the loop below), so the device's
                # uniform windowing reads each row's true samples to within
                # the rational resample-rounding drift.
                if n_real == 1:
                    chunk = batch_samples[0]
                else:
                    start0 = batch_starts[0]
                    length = max(
                        st - start0 + len(s)
                        for st, s in zip(batch_starts, batch_samples)
                    )
                    chunk = np.zeros(length, np.float32)
                    for st, s in zip(batch_starts, batch_samples):
                        chunk[st - start0:st - start0 + len(s)] = s
                handle = runner.predict_chunk_async(chunk, n_real, options)
            else:
                rows = batch_samples
                if n_real < effective_batch:
                    # Silence-pad to the warmed shape (ref :242-258).
                    rows = rows + [
                        np.zeros(target_count, np.float32)
                    ] * (effective_batch - n_real)
                with start_inference_watchdog(
                    effective_batch, config.watchdog_timeout
                ):
                    results = classifier.predict_batch(np.stack(rows), options)
                handle = _SyncHandle(results[:n_real])
            pending.append((handle, batch_starts.copy()))
            batch_samples.clear()
            batch_starts.clear()
            while len(pending) > 1:
                finalize(*pending.pop(0))

        while True:
            item = tx.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                if isinstance(item, BirdaError):
                    raise item
                from ..errors import AudioDecode

                raise AudioDecode(str(config.input_path), str(item)) from item
            samples, start_sample = item
            # The device windows each chunk on ITS uniform grid anchored at
            # the chunk's first sample. Mid-file windows sit on the host's
            # uniform source grid (start0 + k*step_src), which tracks the
            # device grid to within the rational rounding drift (<~1 source
            # sample per window, below the mel hop quantization). The
            # decoder's TAIL windows advance by less than a full step and
            # fall off that grid — batched, the device row would read
            # past-EOF padding instead of the tail samples — so an off-grid
            # window is flushed into its own single-window chunk, where it
            # anchors the grid itself (row 0 reads exactly its samples).
            if (runner is not None and batch_starts
                    and start_sample != batch_starts[0]
                    + len(batch_samples) * step_src):
                flush_batch()
            batch_samples.append(samples)
            batch_starts.append(start_sample)
            if len(batch_samples) >= effective_batch:
                flush_batch()
        flush_batch()
        while pending:
            finalize(*pending.pop(0))
        producer.join(timeout=5)

        # Embedding-based heads want the embeddings too; classifier handles
        # that internally when want_embeddings=True.

        detections.sort(key=lambda d: d.sort_key())

        _attach_metadata(detections, config)

        should_write_files = config.dual_output_mode or config.reporter is None
        if should_write_files:
            for fmt in config.formats:
                _write_output(fmt, detections, config, audio_duration)

        if not config.dual_output_mode and config.reporter is not None:
            config.reporter.detections(str(config.input_path), detections)

        duration = time.monotonic() - start_time
        result = ProcessResult(
            detections=len(detections),
            segments=segments_done,
            duration_secs=duration,
            audio_duration_secs=audio_duration,
        )
        logger.info(
            "Processed %d segments in %.2fs (%.1f segments/sec, %.1fx realtime)",
            result.segments, result.duration_secs,
            result.segments_per_sec, result.realtime_factor,
        )
        return result
    finally:
        # Producer threads share the decoder (single-thread path) or hold
        # their own native handles (parallel path): on error exits they may
        # be blocked mid-put. Signal, drain, and JOIN before closing the
        # decoder — closing a native handle under a live read is a
        # use-after-free, which would turn a recoverable per-file error
        # into a process crash.
        abort.set()
        if tx is not None:
            try:
                while True:
                    tx.get_nowait()
            except queue.Empty:
                pass
        if producer is not None:
            producer.join(timeout=10)
            if producer.is_alive():  # pragma: no cover — defensive
                logger.warning("decode producer did not exit; leaking "
                               "decoder handle rather than risking a "
                               "use-after-free close")
                decoder = None
        if decoder is not None:
            decoder.close()
        lock.release()


def _attach_metadata(detections: list[Detection], config: ProcessingConfig):
    """Populate the optional metadata columns the writers may emit."""
    if not config.csv_columns:
        return
    lat = lon = week = None
    if config.range_filter_params is not None:
        lat, lon, week = config.range_filter_params
    for d in detections:
        md = d.metadata
        md.lat, md.lon, md.week = lat, lon, week
        md.model = config.model_name or None
        md.overlap = config.overlap
        md.min_conf = config.min_confidence


def _write_output(fmt: OutputFormat, detections: list[Detection],
                  config: ProcessingConfig, audio_duration: float) -> None:
    path = output_path_for(config.input_path, config.output_dir, fmt)
    if fmt == OutputFormat.CSV:
        from ..output.csv import CsvWriter

        writer = CsvWriter(path, config.csv_columns, config.csv_bom_enabled)
    elif fmt == OutputFormat.RAVEN:
        from ..output.raven import RavenWriter

        writer = RavenWriter(path)
    elif fmt == OutputFormat.AUDACITY:
        from ..output.audacity import AudacityWriter

        writer = AudacityWriter(path)
    elif fmt == OutputFormat.KALEIDOSCOPE:
        from ..output.kaleidoscope import KaleidoscopeWriter

        writer = KaleidoscopeWriter(path)
    elif fmt == OutputFormat.PARQUET:
        from ..output.parquet import ParquetWriter

        writer = ParquetWriter(path, config.csv_columns)
    elif fmt == OutputFormat.JSON:
        from ..output.json_file import JsonResultWriter

        rf = config.range_filter_params
        writer = JsonResultWriter(
            path,
            source_file=Path(config.input_path).name,
            model=config.model_name,
            min_confidence=config.min_confidence,
            overlap=config.overlap,
            audio_duration=audio_duration,
            lat=rf[0] if rf else None,
            lon=rf[1] if rf else None,
            week=rf[2] if rf else None,
        )
    else:  # pragma: no cover
        raise ValueError(fmt)
    with writer as w:
        for d in detections:
            w.write_detection(d)
