"""Minimal dependency-free PNG writer and reader (port of lsr_tpu/io/png.py:
write_png, save_canvas_png and read_png).

Canvas arrays use a bottom-left origin; PNG rows run top to bottom, so
save_canvas_png flips the rows.  read_png decodes 8-bit gray, gray+alpha,
RGB and RGBA PNGs with scanline filters 0-4 in Python; lsr_tpu's optional
native unfilter (native/png_filters.cpp) is not bound here, and the Python
path gives the same bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Write an (H, W, 3) u8 array as PNG; row 0 is the TOP row."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png expects (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, 6))
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def save_canvas_png(path: str, canvas_u8: np.ndarray) -> None:
    """Save a bottom-left-origin canvas (row 0 = bottom) as a PNG."""
    write_png(path, np.asarray(canvas_u8)[::-1])


def _unfilter_row(ftype: int, row, prev, channels: int):
    """One scanline's bytes (int32) after undoing PNG filter ftype against
    the previous unfiltered row."""
    stride = row.shape[0]
    if ftype == 0:
        return row
    if ftype == 2:                                   # Up
        return (row + prev) & 0xFF
    cur = row.copy()
    if ftype == 1:                                   # Sub
        for i in range(channels, stride):
            cur[i] = (cur[i] + cur[i - channels]) & 0xFF
    elif ftype == 3:                                 # Average
        for i in range(stride):
            left = cur[i - channels] if i >= channels else 0
            cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif ftype == 4:                                 # Paeth
        for i in range(stride):
            a = cur[i - channels] if i >= channels else 0
            b = prev[i]
            c = prev[i - channels] if i >= channels else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    else:
        raise ValueError(f"unsupported filter {ftype}")
    return cur


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit gray / gray+alpha / RGB / RGBA PNG (filters 0-4).
    Returns (H, W, channels) uint8, row 0 the TOP row."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color_type = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if bitdepth != 8:
        raise ValueError("only 8-bit PNGs supported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(h):
        row = np.frombuffer(raw, np.uint8, stride, off + 1).astype(np.int32)
        cur = _unfilter_row(raw[off], row, prev, channels)
        off += 1 + stride
        img[y] = cur.astype(np.uint8)
        prev = cur
    return img.reshape(h, w, channels)
