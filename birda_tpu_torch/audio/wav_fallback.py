"""Pure-Python WAV reader — fallback when the native library is absent.

Handles the same WAV surface as the native decoder: RIFF/RF64/BW64, PCM
u8/s16/s24/s32 and IEEE float f32/f64, WAVE_FORMAT_EXTENSIBLE, mono downmix,
declared-size clamping against lying headers.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

FMT_PCM = 0x0001
FMT_IEEE_FLOAT = 0x0003
FMT_EXTENSIBLE = 0xFFFE


class WavFallbackReader:
    """Streaming mono WAV reader with the NativeReader interface."""

    #: PCM is context-free: decode after a seek == sequential decode.
    exact_seek = True

    def __init__(self, path: Path | str):
        self._f = open(path, "rb")
        try:
            self._parse_header()
        except IOError:
            self._f.close()
            raise
        except Exception as e:
            # Malformed headers can fail deep in the parse (struct.error,
            # arithmetic on absent fields); the caller's contract is
            # IOError -> typed AudioOpen, never a raw parser traceback
            # aborting the whole batch run.
            self._f.close()
            raise IOError(f"malformed WAV header: {e}") from e
        self._pos = 0

    def _parse_header(self):
        f = self._f
        riff = f.read(4)
        f.read(4)  # 32-bit riff size (unused; possibly 0xFFFFFFFF for RF64)
        wave = f.read(4)
        rf64 = riff in (b"RF64", b"BW64")
        if riff != b"RIFF" and not rf64:
            raise IOError("not a RIFF/RF64 file")
        if wave != b"WAVE":
            raise IOError("not a WAVE file")

        ds64_data_size = None
        fmt = None
        data_offset = None
        data_size = None

        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, sz = struct.unpack("<4sI", hdr)
            if cid == b"ds64" and rf64:
                body = f.read(min(sz, 28))
                if len(body) < 16:
                    raise IOError("truncated ds64 chunk")
                ds64_data_size = struct.unpack("<Q", body[8:16])[0]
                rest = sz - len(body) + (sz & 1)
                if rest:
                    f.seek(rest, 1)
            elif cid == b"fmt ":
                body = f.read(sz + (sz & 1))
                fmt = self._parse_fmt(body[:sz])
            elif cid == b"data":
                data_offset = f.tell()
                data_size = ds64_data_size if (rf64 and sz == 0xFFFFFFFF) else sz
                if data_size is None:
                    raise IOError("RF64 data chunk without a ds64 size")
                if fmt is not None:
                    break
                f.seek(data_size + (data_size & 1), 1)
            else:
                f.seek(sz + (sz & 1), 1)

        if fmt is None:
            raise IOError("missing fmt chunk")
        if data_offset is None:
            raise IOError("missing data chunk")

        self._format, self.channels, self.rate, self._bits = fmt
        self._sample_bytes = self._bits // 8
        self._frame_bytes = self.channels * self._sample_bytes

        f.seek(0, 2)
        avail = max(0, f.tell() - data_offset)
        data_size = min(data_size, avail)  # lying headers (#310 hardening)
        self.frames = data_size // self._frame_bytes
        self._data_offset = data_offset
        f.seek(data_offset)

    @staticmethod
    def _parse_fmt(body: bytes):
        if len(body) < 16:
            raise IOError("fmt chunk too small")
        format_tag, ch, rate, _br, _block, bits = struct.unpack("<HHIIHH", body[:16])
        if format_tag == FMT_EXTENSIBLE:
            if len(body) < 40:
                raise IOError("extensible fmt too small")
            format_tag = struct.unpack("<H", body[24:26])[0]
        if format_tag == FMT_PCM and bits in (8, 16, 24, 32):
            pass
        elif format_tag == FMT_IEEE_FLOAT and bits in (32, 64):
            pass
        else:
            raise IOError("unsupported WAV codec")
        if ch <= 0 or rate <= 0:
            raise IOError("invalid WAV channel count or sample rate")
        return format_tag, ch, rate, bits

    def read(self, n: int) -> np.ndarray:
        n = min(n, self.frames - self._pos)
        if n <= 0:
            return np.empty(0, np.float32)
        raw = self._f.read(n * self._frame_bytes)
        got = len(raw) // self._frame_bytes
        if got == 0:
            return np.empty(0, np.float32)
        raw = raw[: got * self._frame_bytes]
        fmt, bits, ch = self._format, self._bits, self.channels
        if fmt == FMT_PCM:
            if bits == 8:
                x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
            elif bits == 16:
                x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
            elif bits == 24:
                b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
                v = (
                    b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16)
                )
                v = np.where(v & 0x800000, v - 0x1000000, v)
                x = v.astype(np.float32) / 8388608.0
            else:
                x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
        out = x.reshape(got, ch).mean(axis=1).astype(np.float32)
        self._pos += got
        return out

    def seek(self, frame: int) -> int:
        frame = max(0, min(frame, self.frames))
        self._f.seek(self._data_offset + frame * self._frame_bytes)
        self._pos = frame
        return frame

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
