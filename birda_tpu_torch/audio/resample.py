"""Host-side resampling API (reference ``src/audio/resample.rs:10,97``).

Thin wrapper over the shared polyphase plan in :mod:`birda_tpu.ops.resample`.
Returns the input unchanged when rates match; output length is
``ceil(len * to / from)`` like the reference's chunked FFT path.
"""

from __future__ import annotations

import numpy as np

from ..errors import ResampleError
from ..ops.resample import resample_numpy


def resample(samples: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Resample a mono float32 signal to ``to_rate``."""
    if from_rate <= 0 or to_rate <= 0:
        raise ResampleError(f"invalid sample rates {from_rate} -> {to_rate}")
    if from_rate == to_rate:
        return np.asarray(samples, np.float32)
    try:
        return resample_numpy(samples, from_rate, to_rate)
    except MemoryError as e:
        raise ResampleError(str(e)) from e


def resample_chunk(samples: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Per-segment convenience wrapper (streaming path)."""
    return resample(samples, from_rate, to_rate)
