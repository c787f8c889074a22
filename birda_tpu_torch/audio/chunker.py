"""Offline audio chunking with overlap (reference ``src/audio/chunker.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AudioChunk:
    """A chunk of audio with its time offset."""

    samples: np.ndarray
    start_time: float
    end_time: float


def chunk_audio(
    samples: np.ndarray,
    sample_rate: int,
    chunk_duration: float,
    overlap: float,
) -> list[AudioChunk]:
    """Split samples into fixed-duration chunks, zero-padding the tail.

    ``step = chunk - overlap`` in samples; a non-positive step returns no
    chunks (matching the reference's guard).
    """
    samples = np.asarray(samples, np.float32)
    chunk_samples = int(chunk_duration * sample_rate)
    overlap_samples = int(overlap * sample_rate)
    step = max(0, chunk_samples - overlap_samples)
    if step == 0:
        return []

    chunks: list[AudioChunk] = []
    pos = 0
    n = len(samples)
    while pos < n:
        end = min(pos + chunk_samples, n)
        data = samples[pos:end]
        if len(data) < chunk_samples:
            data = np.concatenate(
                [data, np.zeros(chunk_samples - len(data), np.float32)]
            )
        else:
            data = data.copy()
        start_time = pos / sample_rate
        chunks.append(
            AudioChunk(
                samples=data,
                start_time=start_time,
                end_time=start_time + chunk_duration,
            )
        )
        pos += step
    return chunks
