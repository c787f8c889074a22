"""Streaming audio decode (reference ``src/audio/decode.rs``).

``StreamingDecoder`` yields fixed-size overlapped windows at the *source*
sample rate without ever materializing the file; the pipeline resamples each
window (or ships raw windows to the device, where the polyphase kernel runs
fused with the model front-end). Decode itself is sequential host work done
by the native C++ library (WAV/RF64/FLAC), with a pure-Python WAV fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..errors import (
    AudioDecode,
    AudioOpen,
    Internal,
    NoAudioTracks,
    UnsupportedAudioFormat,
)
from ..native import audio as native_audio
from .wav_fallback import WavFallbackReader

#: Decode granularity (frames per native read). Large enough to amortize the
#: ctypes boundary, small enough to keep memory bounded.
_READ_CHUNK = 1 << 16


@dataclass
class RawSegment:
    """A raw window of decoded audio at the source rate."""

    samples: np.ndarray     # float32, exactly segment_samples long (zero-padded tail)
    start_sample: int       # position in samples from the start of the file


@dataclass
class DecodedAudio:
    samples: np.ndarray
    sample_rate: int

    @property
    def duration_secs(self) -> float:
        return len(self.samples) / self.sample_rate


def _open_reader(path: Path):
    if native_audio.available():
        try:
            return native_audio.NativeReader(path)
        except IOError as e:
            msg = str(e)
            if "unsupported" in msg:
                raise UnsupportedAudioFormat(str(path)) from e
            raise AudioOpen(str(path), msg) from e
    suffix = path.suffix.lower()
    if suffix == ".wav":
        try:
            return WavFallbackReader(path)
        except IOError as e:
            raise AudioOpen(str(path), str(e)) from e
    raise UnsupportedAudioFormat(
        f"{path}: only WAV is supported without the native decoder"
    )


class StreamingDecoder:
    """Stream overlapped segments from an audio file.

    Window semantics (reference ``src/audio/decode.rs:150-202``):
    ``next_segment(segment, overlap)`` returns exactly ``segment`` samples,
    zero-padding the final window; consecutive windows advance by
    ``segment - overlap``; a final window shorter than ``overlap`` ends the
    stream rather than looping.
    """

    def __init__(self, path: Path | str):
        self.path = Path(path)
        if not self.path.exists():
            raise AudioOpen(str(path), "no such file")
        self._reader = _open_reader(self.path)
        self.sample_rate = int(self._reader.rate)
        self.channels = int(self._reader.channels)
        if self.sample_rate <= 0 or self.channels <= 0:
            raise NoAudioTracks(str(path))
        total = int(self._reader.frames)
        self.total_frames = total if total >= 0 else None
        #: Seek-then-decode is bit-identical to sequential decode (PCM,
        #: FLAC); False for stateful codecs (MP3/AAC), where parallel span
        #: decoding would produce subtly different samples.
        self.exact_seek = bool(getattr(self._reader, "exact_seek", False))
        self._buffer = np.empty(0, np.float32)
        self._emitted = 0
        self._eof = False

    @property
    def duration_secs(self) -> float | None:
        if self.total_frames is None:
            return None
        return self.total_frames / self.sample_rate

    def next_segment(self, segment_samples: int, overlap_samples: int) -> RawSegment | None:
        """Yield the next window, or None when the file is exhausted."""
        if overlap_samples >= segment_samples:
            raise Internal(
                f"overlap_samples ({overlap_samples}) must be less than "
                f"segment_samples ({segment_samples})"
            )

        while len(self._buffer) < segment_samples and not self._eof:
            chunk = self._raw_read(max(_READ_CHUNK, segment_samples))
            if len(chunk) == 0:
                self._eof = True
                break
            self._buffer = (
                chunk if len(self._buffer) == 0
                else np.concatenate([self._buffer, chunk])
            )

        if len(self._buffer) == 0:
            return None

        take = min(segment_samples, len(self._buffer))
        samples = self._buffer[:take]
        if take < segment_samples:
            samples = np.concatenate(
                [samples, np.zeros(segment_samples - take, np.float32)]
            )
        else:
            samples = samples.copy()

        start_sample = self._emitted
        advance = max(0, take - overlap_samples)
        if advance > 0:
            self._buffer = self._buffer[advance:]
            self._emitted += advance
        else:
            # Final partial window no longer than the overlap: emit once, stop.
            self._buffer = np.empty(0, np.float32)
            self._emitted += take

        return RawSegment(samples=samples, start_sample=start_sample)

    def _raw_read(self, n: int) -> np.ndarray:
        """Reader read with mid-stream failures surfaced as typed errors
        (corrupt frames, codec parameters changing mid-file, IO faults)."""
        try:
            return self._reader.read(n)
        except OSError as e:
            raise AudioDecode(str(self.path), str(e)) from e

    def read(self, n: int) -> np.ndarray:
        """Raw sequential read (clipper path); bypasses windowing."""
        return self._raw_read(n)

    def seek(self, frame: int) -> int:
        try:
            pos = self._reader.seek(frame)
        except OSError as e:
            raise AudioDecode(str(self.path), str(e)) from e
        self._buffer = np.empty(0, np.float32)
        self._emitted = pos
        self._eof = False
        return pos

    def seek_exact(self, frame: int) -> int:
        """Land exactly on ``frame`` even when the container only supports
        coarse seeks (compressed formats): seek, then decode-and-discard the
        remainder. Needed by the parallel decoder, whose spans must align on
        the global window grid."""
        pos = self.seek(frame)
        if pos > frame:
            pos = self.seek(0)
        while pos < frame:
            c = self._raw_read(min(_READ_CHUNK, frame - pos))
            if len(c) == 0:
                break
            pos += len(c)
        self._emitted = pos
        return pos

    def close(self):
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def put_abortable(q, item, abort) -> bool:
    """Blocking queue put that gives up when ``abort`` (threading.Event) is
    set; True if delivered. Every producer-side put goes through this so a
    consumer that stops draining (per-file error paths) can release the
    producer threads instead of leaving them blocked on a full queue with
    open native decoder handles."""
    import queue as _queue

    while not abort.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def emitted_window_count(total: int, segment: int, overlap: int) -> int:
    """Exactly how many windows :meth:`StreamingDecoder.next_segment` emits
    for a stream of ``total`` samples — mirrors its advance arithmetic,
    including the trailing overlap-only window (advance==0 branch).

    This is the single source of truth for window counts: span splitting
    (parallel decode) and progress estimation both use it; an approximate
    ceil() here once dropped the final window of a parallel run.
    """
    if total <= 0:
        return 0
    count, pos = 0, 0
    while pos < total:
        take = min(segment, total - pos)
        count += 1
        if take <= overlap:
            break  # final partial window no longer than the overlap
        pos += take - overlap
    return count


def normalize_window(
    samples: np.ndarray,
    src_rate: int,
    target_rate: int,
    target_count: int,
    resample_needed: bool,
) -> np.ndarray:
    """Producer-side window normalization shared by the single-thread and
    parallel decoders: optional resample to the model rate, then exact
    length (zero-pad / truncate)."""
    if resample_needed:
        from .resample import resample_chunk

        samples = resample_chunk(samples, src_rate, target_rate)
    if len(samples) < target_count:
        return np.concatenate(
            [samples, np.zeros(target_count - len(samples), np.float32)]
        )
    if len(samples) > target_count:
        return samples[:target_count]
    return samples


def decode_audio_file(path: Path | str) -> DecodedAudio:
    """Decode a whole file to mono float32 (offline path)."""
    with StreamingDecoder(path) as dec:
        chunks = []
        while True:
            c = dec.read(_READ_CHUNK)
            if len(c) == 0:
                break
            chunks.append(c)
        samples = (
            np.concatenate(chunks) if chunks else np.empty(0, np.float32)
        )
        return DecodedAudio(samples=samples, sample_rate=dec.sample_rate)


def get_audio_duration(path: Path | str) -> float:
    """Duration probe without full decode (reference ``decode.rs:420``)."""
    with StreamingDecoder(path) as dec:
        d = dec.duration_secs
        if d is not None:
            return d
        # Containers without a declared length: count by reading.
        total = 0
        while True:
            c = dec.read(_READ_CHUNK)
            if len(c) == 0:
                break
            total += len(c)
        return total / dec.sample_rate
