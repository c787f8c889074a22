#!/usr/bin/env python3
"""Host-side cycle budget of the chunked streaming path, through the
PyTorch port's own audio stack: the counterpart of
``scripts/bench_host_budget.py``.

End-to-end realtime factor is ``min(host budget, link bound, device
bound)``. This tool measures the host leg on the current machine: every
per-chunk host cost with transfer and device compute left out. Per chunk of
B windows the host must decode B windows of samples
(``birda_tpu_torch/audio/decode.py``: the native decoder where it loads,
else the Python WAV reader), assemble the contiguous chunk, and take its
amax and quantize it to int16 (``birda_tpu_torch/native/audio.py``, numpy
where the native library does not load). It needs no card. Run:

    python3 scripts/torch_bench_host_budget.py [--batch 256] [--seconds 120]

Prints one JSON object: the JAX tool's ``host`` record, unrounded, and
beside it whether the native decoder loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _write_wav16(path: Path, x: np.ndarray, rate: int) -> None:
    """16-bit PCM mono WAV: the native writer where the library loads, else
    the standard library's (a machine without the native decoder's FFmpeg
    libraries is measured too)."""
    from birda_tpu_torch.native import audio as native_audio

    if native_audio.available():
        native_audio.write_wav16(path, x, rate)
        return
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(x, -1, 1) * 32767).round().astype("<i2")
                      .tobytes())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=120.0,
                    help="audio length of the test file")
    ap.add_argument("--rate", type=int, default=48_000)
    args = ap.parse_args(argv)

    from birda_tpu_torch.audio.decode import StreamingDecoder
    from birda_tpu_torch.native import audio as native_audio

    rate, secs = args.rate, args.seconds
    n = int(rate * secs)
    rng = np.random.default_rng(0)
    x = (0.25 * np.sin(2 * np.pi * 3000 * np.arange(n) / rate)
         + 0.05 * rng.normal(size=n)).astype(np.float32)

    with tempfile.TemporaryDirectory() as td:
        wav = Path(td) / "budget.wav"
        _write_wav16(wav, x, rate)

        # 1. Decode, windowed like the producer.
        dec = StreamingDecoder(wav)
        seg, count = 144_000, 0
        t0 = time.perf_counter()
        while dec.next_segment(seg, 0) is not None:
            count += 1
        t_decode = time.perf_counter() - t0
        dec.close()
        decode_rt = secs / t_decode

    # 2. Chunk assembly (concatenate B window steps).
    windows = [x[i * seg:(i + 1) * seg]
               for i in range(min(args.batch, count))]
    reps = max(1, int(2e8 // (len(windows) * seg)))
    t0 = time.perf_counter()
    for _ in range(reps):
        chunk = np.concatenate(windows)
    t_assemble = (time.perf_counter() - t0) / reps
    chunk_secs = len(chunk) / rate

    # 3. amax + int16 quantize (native when available).
    t0 = time.perf_counter()
    for _ in range(reps):
        if native_audio.available():
            native_audio.quantize_int16(chunk)
        else:
            amax = float(np.max(np.abs(chunk)))
            (chunk * (32767.0 / amax)).astype(np.int16)
    t_quant = (time.perf_counter() - t0) / reps

    per_chunk_host = t_assemble + t_quant
    # Decode overlaps assembly and quantize only across threads; the
    # single-thread budget is the serial sum.
    print(json.dumps({
        "host": {
            "decode_x_realtime_1thread": decode_rt,
            "assemble_ms_per_chunk": t_assemble * 1e3,
            "quantize_ms_per_chunk": t_quant * 1e3,
            "chunk_audio_seconds": chunk_secs,
            "host_bound_x_realtime_excl_decode": chunk_secs / per_chunk_host,
            "host_bound_x_realtime_serial_1thread": chunk_secs / (
                per_chunk_host + chunk_secs / decode_rt),
            "note": ("decode parallelizes with --decode-workers; the "
                     "serial figure is the 1-thread floor"),
        },
        "native_decoder_loaded": native_audio.available(),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
