"""Clip WAV writer (reference ``src/clipper/writer.rs``).

Writes ``clips/<species>/<species>_<NN>p_<start>-<end>.wav`` (16-bit PCM),
atomically: to a sibling temp name, then renamed, so a kill or full disk
never leaves a truncated WAV at the final path. Species names are sanitized
against invalid filename characters and path traversal.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..errors import OutputDirCreateFailed, WavWriteFailed
from ..native import audio as native_audio

_INVALID = set('/\\:*?"<>|')

# RIFF sizes are 32-bit: 16-bit mono PCM caps out just under 4 GiB of
# payload. Past it the Python writer's struct.pack raises (crashing the
# batch instead of warning per-clip) and the native writer's uint32 cast
# silently writes a corrupt header — so reject at the shared chokepoint,
# like the reference's hound writer errors (``src/clipper/writer.rs:44``).
MAX_WAV16_SAMPLES = (0xFFFFFFFF - 36) // 2


def sanitize_filename(name: str) -> str:
    sanitized = "".join("_" if c in _INVALID else c for c in name)
    return sanitized.replace("..", "__")


def generate_filename(species: str, confidence: float,
                      start_time: float, end_time: float) -> str:
    pct = int(round(confidence * 100))
    return f"{species}_{pct}p_{start_time:.1f}-{end_time:.1f}.wav"


def _write_wav16_python(path: Path, samples: np.ndarray, rate: int) -> None:
    import struct

    pcm = np.clip(samples, -1.0, 1.0)
    pcm = np.rint(pcm * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)))
        f.write(pcm)


class WavWriter:
    def __init__(self, output_dir: Path | str):
        self.output_dir = Path(output_dir)

    def write_clip(
        self,
        samples: np.ndarray,
        sample_rate: int,
        species: str,
        confidence: float,
        start_time: float,
        end_time: float,
    ) -> Path:
        if samples.size > MAX_WAV16_SAMPLES:
            raise WavWriteFailed(
                str(self.output_dir),
                f"clip of {samples.size} samples exceeds the 4 GiB WAV "
                f"limit ({MAX_WAV16_SAMPLES} samples at 16-bit mono)",
            )
        safe_species = sanitize_filename(species)
        species_dir = self.output_dir / safe_species
        try:
            species_dir.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise OutputDirCreateFailed(str(species_dir), str(e)) from e

        filename = generate_filename(safe_species, confidence, start_time, end_time)
        output_path = species_dir / filename
        temp_path = species_dir / f".{filename}.{os.getpid()}.part"
        try:
            if native_audio.available():
                native_audio.write_wav16(temp_path, samples, sample_rate)
            else:
                _write_wav16_python(temp_path, samples, sample_rate)
            os.replace(temp_path, output_path)
        except (OSError, IOError) as e:
            try:
                temp_path.unlink()
            except OSError:
                pass
            raise WavWriteFailed(str(output_path), str(e)) from e
        return output_path
