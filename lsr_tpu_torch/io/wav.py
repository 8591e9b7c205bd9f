"""Minimal WAV writer and reader (PCM16 mono / stereo), copied from
lsr_tpu/io/wav.py: the headless edge of the audio demo, as PNGs are for
frames.  Host numpy; the bytes equal lsr_tpu's."""

from __future__ import annotations

import struct

import numpy as np


def write_wav(path: str, samples, sample_rate: int = 48000):
    """samples: (N,) or (N, C) float in [-1, 1] -> PCM16 WAV."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    byte_rate = sample_rate * ch * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, ch, sample_rate, byte_rate,
                            ch * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path: str):
    """Tiny PCM16 reader: returns (samples float32 (N, C), rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE"
    pos = 12
    rate, ch, data = None, None, None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            _, ch, rate = struct.unpack("<HHI", body[:8])
        elif cid == b"data":
            data = np.frombuffer(body, "<i2")
        pos += 8 + size + (size & 1)
    assert rate is not None and ch is not None, \
        f"{path}: no 'fmt ' chunk found"
    assert data is not None, f"{path}: no 'data' chunk found"
    x = data.astype(np.float32) / 32767.0
    return x.reshape(-1, ch), rate
