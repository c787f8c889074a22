"""ctypes bindings for the native audio library (``native/birda_audio.cpp``).

The shared library is built from the repository's ``native/`` sources by
``make -C native OUT=...`` into ``birda_tpu_torch/_build/`` (named by a
digest of the sources, so edited sources rebuild) at first use. If it cannot
be built or loaded (no toolchain or codec headers), :data:`available` is
False and callers fall back to the pure-Python WAV reader in
:mod:`birda_tpu_torch.audio.wav_fallback`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lib = None
#: Set once a build or load failed: the decoder stays on the fallback for
#: the rest of the process instead of re-running make on every call.
_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256()
    for f in sorted(_NATIVE_DIR.glob("*")):
        if f.is_file():
            h.update(f.name.encode() + f.read_bytes())
    return _BUILD_DIR / f"libbirda_audio-{h.hexdigest()[:16]}.so"


def _try_build(out: Path) -> bool:
    """Build the native library into ``out`` (best effort; atomic, so
    concurrent processes never load a half-written file)."""
    if not (_NATIVE_DIR / "Makefile").exists():
        return False
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), f"OUT={tmp}"],
            capture_output=True, timeout=120, check=True,
        )
        os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        tmp.unlink(missing_ok=True)
    return out.exists()


def _load():
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed or not _NATIVE_DIR.is_dir():
        return None
    path = _lib_path()
    if not path.exists() and not _try_build(path):
        _failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        _failed = True
        return None
    lib.birda_open.restype = ctypes.c_void_p
    lib.birda_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.birda_rate.restype = ctypes.c_int32
    lib.birda_rate.argtypes = [ctypes.c_void_p]
    lib.birda_channels.restype = ctypes.c_int32
    lib.birda_channels.argtypes = [ctypes.c_void_p]
    lib.birda_frames.restype = ctypes.c_int64
    lib.birda_frames.argtypes = [ctypes.c_void_p]
    lib.birda_read_mono.restype = ctypes.c_int64
    lib.birda_read_mono.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.birda_seek.restype = ctypes.c_int64
    lib.birda_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    if hasattr(lib, "birda_exact_seek"):
        lib.birda_exact_seek.restype = ctypes.c_int32
        lib.birda_exact_seek.argtypes = [ctypes.c_void_p]
    lib.birda_error.restype = ctypes.c_char_p
    lib.birda_error.argtypes = [ctypes.c_void_p]
    lib.birda_close.restype = None
    lib.birda_close.argtypes = [ctypes.c_void_p]
    lib.birda_quantize_int16.restype = None
    lib.birda_quantize_int16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
    ]
    lib.birda_write_wav16.restype = ctypes.c_int
    lib.birda_write_wav16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeReader:
    """Streaming mono reader over the native decoder."""

    def __init__(self, path: Path | str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native audio library unavailable")
        err = ctypes.create_string_buffer(256)
        self._h = lib.birda_open(str(path).encode(), err, 256)
        if not self._h:
            raise IOError(err.value.decode() or "open failed")
        self._lib = lib
        self.rate = lib.birda_rate(self._h)
        self.channels = lib.birda_channels(self._h)
        self.frames = lib.birda_frames(self._h)
        try:
            self.exact_seek = bool(lib.birda_exact_seek(self._h))
        except AttributeError:  # stale .so without the symbol
            self.exact_seek = False

    def read(self, n: int) -> np.ndarray:
        """Read up to ``n`` mono frames; empty array at EOF."""
        out = np.empty(n, np.float32)
        got = self._lib.birda_read_mono(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
        )
        if got < 0:
            raise IOError(self._lib.birda_error(self._h).decode() or "read failed")
        return out[:got]

    def seek(self, frame: int) -> int:
        pos = self._lib.birda_seek(self._h, frame)
        if pos < 0:
            raise IOError(self._lib.birda_error(self._h).decode() or "seek failed")
        return pos

    def close(self):
        if self._h:
            self._lib.birda_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_wav16(path: Path | str, samples: np.ndarray, rate: int) -> None:
    """Write mono float32 samples as 16-bit PCM WAV via the native writer."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native audio library unavailable")
    samples = np.ascontiguousarray(samples, np.float32)
    err = ctypes.create_string_buffer(256)
    rc = lib.birda_write_wav16(
        str(path).encode(),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), rate, err, 256,
    )
    if rc != 0:
        raise IOError(err.value.decode() or "wav write failed")


def quantize_int16(samples: np.ndarray) -> tuple[np.ndarray, float]:
    """Fused amax + int16 quantization in native code (one pass each,
    auto-vectorized). Returns (int16 payload, amax scale)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native audio library unavailable")
    samples = np.ascontiguousarray(samples, np.float32)
    out = np.empty(len(samples), np.int16)
    amax = ctypes.c_float(0.0)
    lib.birda_quantize_int16(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.byref(amax),
    )
    return out, float(amax.value)
