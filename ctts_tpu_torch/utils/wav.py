"""WAV I/O with exact parity to the C reference.

- Reader: chunked RIFF walk, PCM16 only, stereo averaged to mono with C
  integer semantics (ctts.c:721-807).
- Writer: canonical 44-byte header, 22050 Hz 16-bit mono (ctts.c:809-848).

Copy of ctts_tpu/utils/wav.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import struct

import numpy as np


class WavError(ValueError):
    pass


def read_wav(path: str) -> np.ndarray:
    """Read a PCM16 WAV; returns int16 mono samples (ctts.c:721-807).

    Stereo inputs are averaged per frame with C semantics:
    (left + right) / 2 in int arithmetic (truncation toward zero).
    """
    with open(path, "rb") as f:
        data = f.read()

    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    payload = None
    # Walk chunks until the data chunk, as the C reader does (ctts.c:740-765).
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = pos + 8
        if cid == b"fmt ":
            if size < 16:
                raise WavError(f"{path}: fmt chunk too small")
            fmt = struct.unpack_from("<HHIIHH", data, body)
            pos = body + size
        elif cid == b"data":
            payload = data[body : body + size]
            break
        else:
            pos = body + size

    if fmt is None or payload is None:
        raise WavError(f"{path}: missing fmt/data chunk")

    audio_format, num_channels, _sr, _br, _ba, bits = fmt
    if audio_format != 1 or bits != 16:
        raise WavError(f"{path}: only PCM16 supported")

    raw = np.frombuffer(payload, dtype="<i2")
    # C computes sample_count = data_size/2/channels and reads that many
    # frames; replicate the truncation (ctts.c:777).
    frames = len(payload) // 2 // num_channels
    if num_channels == 1:
        return raw[:frames].astype(np.int16)
    raw = raw[: frames * num_channels].reshape(frames, num_channels)
    left = raw[:, 0].astype(np.int32)
    right = raw[:, 1].astype(np.int32)
    # (int16_t)((left + right) / 2): C division truncates toward zero.
    s = left + right
    mono = np.where(s >= 0, s // 2, -((-s) // 2))
    return mono.astype(np.int16)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write int16 mono PCM WAV, byte-identical to ctts_write_wav
    (ctts.c:809-848)."""
    samples = np.ascontiguousarray(samples, dtype="<i2")
    data_size = samples.nbytes
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(samples.tobytes())
