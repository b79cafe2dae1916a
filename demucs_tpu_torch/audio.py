"""WAV read/write with zero third-party deps.

The port of the numpy path of `demucs_tpu/audio.py` (its native C++
codec is not ported): 44.1 kHz only, mono is duplicated to stereo,
output stems written as float32 or 16-bit PCM WAV.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np

from .config import SAMPLE_RATE


def raw_to(data: bytes, dtype) -> np.ndarray:
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer(data[: len(data) - len(data) % itemsize], dtype)


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> ((channels, n) float32 in [-1, 1], sample_rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/float64.
    """
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    # walk chunks ourselves: stdlib wave rejects WAVE_FORMAT_IEEE_FLOAT
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        (size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", fmt, 0)
    if tag == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        (tag,) = struct.unpack_from("<H", fmt, 24)

    if tag == 1:  # PCM
        if bits == 8:
            x = (raw_to(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = raw_to(data, np.int16).astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(data, np.uint8)
            b = b[: len(b) - len(b) % 3].reshape(-1, 3)
            v = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            v = np.where(v & 0x800000, v - 0x1000000, v)
            x = v.astype(np.float32) / 8388608.0
        elif bits == 32:
            x = raw_to(data, np.int32).astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM width {bits}")
    elif tag == 3:  # IEEE float
        x = raw_to(data, np.float32 if bits == 32 else np.float64).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format tag {tag}")

    x = x[: len(x) - len(x) % channels].reshape(-1, channels).T
    return np.ascontiguousarray(x), rate


def write_wav(path: str | Path, audio: np.ndarray, rate: int = SAMPLE_RATE,
              pcm16: bool = False) -> None:
    """Write (channels, n) float32 as WAV (float32 default, or 16-bit PCM)."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    channels, n = audio.shape
    if pcm16:
        clipped = np.clip(np.ascontiguousarray(audio.T), -1.0, 1.0)
        frames = np.round(clipped * 32767.0).astype(np.int16).tobytes()
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(frames)
        return
    # IEEE float32 WAV (stdlib wave can't write format tag 3)
    payload = np.ascontiguousarray(audio.T).tobytes()
    block = channels * 4
    # RIFF content size: "WAVE"(4) + fmt(8+18) + fact(8+4) + data hdr(8) + payload
    hdr = b"".join([
        b"RIFF", struct.pack("<I", 4 + 26 + 12 + 8 + len(payload)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 18, 3, channels, rate,
                             rate * block, block, 32), b"\x00\x00",
        b"fact", struct.pack("<II", 4, n),
        b"data", struct.pack("<I", len(payload)),
    ])
    Path(path).write_bytes(hdr + payload)


def load_track(path: str | Path) -> np.ndarray:
    """Read + validate like the reference CLI: require 44.1 kHz, return
    stereo (2, n) (mono duplicated)."""
    audio, rate = read_wav(path)
    if rate != SAMPLE_RATE:
        raise ValueError(
            f"{path}: demucs supports {SAMPLE_RATE} Hz only, got {rate}")
    if audio.shape[0] == 1:
        audio = np.repeat(audio, 2, axis=0)
    elif audio.shape[0] > 2:
        audio = audio[:2]
    return audio
