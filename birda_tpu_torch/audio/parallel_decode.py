"""Parallel segmented decode of ONE file.

The reference feeds inference from a single decode thread — its documented
scaling ceiling (SURVEY §3.1: "HOT LOOP A … the first thing the TPU rebuild
must parallelize"). At TPU inference rates one thread of WAV/FLAC decode +
resample caps end-to-end throughput, so this module decodes one file with N
workers over disjoint, window-grid-aligned spans:

- Window w of the global stream starts at ``w * step`` (step = segment −
  overlap). Worker k owns windows ``[k*W, (k+1)*W)`` and opens its OWN
  decoder, ``seek_exact``-ed to ``k*W*step`` — exact even on coarse-seek
  containers. The last *created* worker always runs to stream end (its
  bound is None), so the subtle tail-window semantics stay identical to the
  single-decoder path (decode.rs:150-202) even if the split is imperfect.
- A mux thread drains the workers' bounded queues strictly in span order
  into the pipeline's queue, so the consumer still sees consecutive windows
  (the chunk runner reassembles a contiguous sample stream from them).
  Per-worker queues provide backpressure: a worker far ahead of the mux
  blocks on its own queue.
- ``abort`` (a threading.Event) unblocks every queue put when the consumer
  stops draining (per-file error paths): without it, workers would block
  forever on full queues, leaking threads and open native decoder handles.

Decode (native C++ via ctypes) and per-window resample (numpy) both release
the GIL, so threads give real parallelism without process overhead.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

from .decode import (
    StreamingDecoder,
    normalize_window,
    put_abortable as _put_abortable,
)

_WORKER_DONE = object()
#: Per-worker lookahead (windows) before it blocks on the mux.
_WORKER_QUEUE = 8


def _worker(
    path: Path,
    out: queue.Queue,
    abort: threading.Event,
    first_window: int,
    end_window: int | None,
    seg_samples: int,
    ovl_samples: int,
    target_rate: int,
    target_count: int,
    resample_needed: bool,
):
    step = seg_samples - ovl_samples
    dec = None
    try:
        dec = StreamingDecoder(path)
        dec.seek_exact(first_window * step)
        while not abort.is_set():
            seg = dec.next_segment(seg_samples, ovl_samples)
            if seg is None:
                break
            if end_window is not None and seg.start_sample // step >= end_window:
                break
            samples = normalize_window(
                seg.samples, dec.sample_rate, target_rate, target_count,
                resample_needed,
            )
            if not _put_abortable(out, (samples, seg.start_sample), abort):
                return
    except BaseException as e:  # noqa: BLE001 — shipped in-band via the mux
        _put_abortable(out, e, abort)
    finally:
        if dec is not None:
            dec.close()
        _put_abortable(out, _WORKER_DONE, abort)


def spawn_parallel_decode(
    path: Path,
    tx: queue.Queue,
    sentinel,
    total_frames: int,
    seg_samples: int,
    ovl_samples: int,
    target_rate: int,
    target_count: int,
    resample_needed: bool,
    n_workers: int,
    abort: threading.Event | None = None,
) -> threading.Thread:
    """Start N span decoders + the ordered mux; returns the mux thread.

    The mux emits ``(samples, start_sample)`` tuples into ``tx`` in global
    window order, ships the first worker exception in-band, and always
    terminates the stream with ``sentinel`` — the same contract as the
    single-threaded producer in :mod:`birda_tpu.pipeline.processor`. Set
    ``abort`` to unblock everything when the consumer stops draining.
    """
    if abort is None:
        abort = threading.Event()
    step = max(1, seg_samples - ovl_samples)
    # Only FULL windows sit on the w*step grid the span split assumes; the
    # decoder goes off-grid at its first partial window (advance < step),
    # so the 1-2 tail windows always belong to the last worker's unbounded
    # run. Splitting on the total emitted count (or any over-count) would
    # duplicate the tail; bounding the last worker under an under-count
    # once silently dropped the final window.
    full = (
        (total_frames - seg_samples) // step + 1
        if total_frames >= seg_samples else 0
    )
    n_split = max(1, full)
    n_workers = max(1, min(n_workers, n_split))
    per = -(-n_split // n_workers)

    worker_args: list[tuple[int, int | None]] = []
    for k in range(n_workers):
        first = k * per
        if first >= n_split:
            break
        worker_args.append((first, min((k + 1) * per, n_split)))
    # The last created worker ALWAYS runs to stream end (tail windows).
    worker_args[-1] = (worker_args[-1][0], None)

    worker_queues: list[queue.Queue] = []
    threads: list[threading.Thread] = []
    for k, (first, end) in enumerate(worker_args):
        q: queue.Queue = queue.Queue(maxsize=_WORKER_QUEUE)
        t = threading.Thread(
            target=_worker,
            args=(path, q, abort, first, end, seg_samples, ovl_samples,
                  target_rate, target_count, resample_needed),
            daemon=True,
            name=f"birda-decode-{k}",
        )
        t.start()
        worker_queues.append(q)
        threads.append(t)

    def mux():
        error_sent = False
        try:
            for q in worker_queues:
                while not abort.is_set():
                    try:
                        item = q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if item is _WORKER_DONE:
                        break
                    if isinstance(item, BaseException):
                        # Ship the FIRST error immediately: the consumer
                        # raises on receipt and its teardown sets `abort`,
                        # which stops the other workers mid-span — waiting
                        # until every worker drained to DONE kept all the
                        # decoders running for minutes on output that was
                        # already doomed. Keep draining (non-forwarding) so
                        # workers blocked on a full queue can reach their
                        # abort checks.
                        if not error_sent:
                            error_sent = True
                            if not _put_abortable(tx, item, abort):
                                return
                        continue
                    if not error_sent:
                        if not _put_abortable(tx, item, abort):
                            return
        finally:
            abort_set = abort.is_set()
            if not abort_set:
                _put_abortable(tx, sentinel, abort)
            else:
                # Consumer is gone: make sure every worker can finish its
                # pending put and close its decoder.
                for q in worker_queues:
                    try:
                        while True:
                            q.get_nowait()
                    except queue.Empty:
                        pass
            for t in threads:
                t.join(timeout=5)

    m = threading.Thread(target=mux, daemon=True, name="birda-decode-mux")
    m.start()
    return m
