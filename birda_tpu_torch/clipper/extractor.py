"""Clip extraction (reference ``src/clipper/extractor.rs``).

Seek-based: a clip starting at or past ``SEEK_THRESHOLD_SECS`` seeks the
decoder instead of decoding from the top. Preallocation is capped both by a
seconds-scaled term and an absolute sample ceiling, because the requested
range and the container's claimed sample rate are both untrusted (#310).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..audio.decode import StreamingDecoder
from ..constants import clipper as clip_consts
from ..errors import EmptyExtraction, InvalidTimeRange
from .grouper import DetectionGroup


def validate_time_range(start: float, end: float) -> None:
    if not (math.isfinite(start) and math.isfinite(end)):
        raise InvalidTimeRange(f"bounds must be finite, got {start}..{end}")
    if start < 0:
        raise InvalidTimeRange(f"start must be non-negative, got {start}")
    if end <= start:
        raise InvalidTimeRange(f"end ({end}) must be greater than start ({start})")


def prealloc_cap(sample_rate: int) -> int:
    """Seconds-scaled reservation cap with an absolute ceiling against lying
    containers (reference ``extractor.rs:39-43``)."""
    if sample_rate <= 0:
        return 0
    return min(
        clip_consts.MAX_CLIP_PREALLOC_SECS * sample_rate,
        clip_consts.MAX_CLIP_PREALLOC_SAMPLES,
    )


@dataclass
class ExtractedClip:
    samples: np.ndarray
    sample_rate: int


class ClipExtractor:
    def extract_clip(self, source_path: Path | str,
                     group: DetectionGroup) -> ExtractedClip:
        validate_time_range(group.start, group.end)
        with StreamingDecoder(source_path) as dec:
            rate = dec.sample_rate
            start_frame = int(group.start * rate)
            end_frame = int(group.end * rate)

            if group.start >= clip_consts.SEEK_THRESHOLD_SECS:
                dec.seek(start_frame)
                skip = 0
            else:
                skip = start_frame

            want = end_frame - start_frame
            # The reservation is only a sizing hint; the read loop collects
            # what the file actually holds.
            chunks: list[np.ndarray] = []
            got = 0
            while skip > 0:
                c = dec.read(min(skip, 1 << 16))
                if len(c) == 0:
                    raise EmptyExtraction(str(source_path))
                skip -= len(c)
            while got < want:
                c = dec.read(min(want - got, max(prealloc_cap(rate), 1 << 16)))
                if len(c) == 0:
                    break
                chunks.append(c)
                got += len(c)

            if got == 0:
                raise EmptyExtraction(str(source_path))
            return ExtractedClip(
                samples=np.concatenate(chunks), sample_rate=rate
            )
