"""Minimal dependency-free PNG writer and reader (port of lsr_tpu/io/png.py:
write_png, save_canvas_png and read_png).

Canvas arrays use a bottom-left origin; PNG rows run top to bottom, so
save_canvas_png flips the rows.  read_png decodes 8-bit gray, gray+alpha,
RGB and RGBA PNGs with scanline filters 0-4: the scanlines go through the
native unfilter (lsr_tpu_torch/native/png_filters.cpp, built with g++ at
first use, as lsr_tpu/io/png.py binds its own).  Where lsr_tpu decodes in
Python a stream its native call declines, this raises: a failed build, a
short stream or an unknown filter byte.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from lsr_tpu_torch.utils.native_build import ensure_native_built


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


_PNG_LIB = None


def _png_lib():
    """ctypes handle of the native scanline unfilter (built at first use;
    a failed build raises)."""
    global _PNG_LIB
    if _PNG_LIB is None:
        lib = ctypes.CDLL(ensure_native_built("libpngfilters.so"))
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        _PNG_LIB = lib
    return _PNG_LIB


def unfilter_native(raw: bytes, h: int, stride: int, channels: int):
    """(h, stride) uint8 scanlines of an inflated stream through the native
    unfilter.  Raises ValueError on a stream shorter than h rows or on an
    unknown filter byte."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG stream of {len(raw)} bytes is short of {h} "
                         f"rows of {stride + 1}")
    out = np.empty(h * stride, np.uint8)
    rc = _png_lib().png_unfilter(raw, h, stride, channels,
                                 out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"unsupported filter {rc}")
    return out.reshape(h, stride)


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
    return unfilter_native(raw, h, stride, channels).reshape(h, w, channels)
