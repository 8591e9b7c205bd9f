"""The port's native helpers (lsr_tpu_torch/native/, built with g++ at first
use by utils/native_build): the OBJ loader io/fast_obj against the port's
and lsr_tpu's Python parsers, exactly; the PNG unfilter bound in io/png
against lsr_tpu's Python decoder; and a build that cannot succeed raising (no
Python path takes over, where lsr_tpu falls back)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import pytest

from lsr_tpu.io import png as jpng
from lsr_tpu.io.obj import load_obj as jload_obj
from lsr_tpu_torch.io import fast_obj, png
from lsr_tpu_torch.io.mesh_writer import write_obj
from lsr_tpu_torch.io.obj import load_obj, make_uv_sphere
from lsr_tpu_torch.utils import native_build
from test_torch_loaders import OBJ_TEXTS

FIELDS = ("positions", "normals", "uvs", "indices")


def _equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", sorted(OBJ_TEXTS))
def test_load_obj_fast_text_matches_python(name):
    """The OBJ text variants of lsr_tpu's tests: the native loader equals
    the port's Python parser and lsr_tpu's, array for array."""
    text = OBJ_TEXTS[name]
    got = fast_obj.load_obj_fast(text, from_text=True)
    _equal(got, load_obj(text, from_text=True))
    _equal(got, jload_obj(text, from_text=True))


def _obj_without_normals(mesh):
    """OBJ text of v and vt records, faces v/vt: no normals."""
    rows = lambda tag, a: "".join(  # noqa: E731
        f"{tag} " + " ".join(f"{v:.9g}" for v in r) + "\n"
        for r in a.tolist())
    faces = "".join(f"f {a}/{a} {b}/{b} {c}/{c}\n"
                    for a, b, c in (mesh.indices + 1).tolist())
    return rows("v", mesh.positions) + rows("vt", mesh.uvs) + faces


@pytest.mark.parametrize("with_normals", [True, False])
def test_load_obj_fast_sphere_matches_python(tmp_path, with_normals):
    """A UV-sphere OBJ (40 x 40, 3,200 triangles) written with its normals
    (io/mesh_writer) and without (both sides then sum area-weighted normals
    in the same order), through the native loader and both Python
    parsers."""
    mesh = make_uv_sphere(rings=40, sectors=40)
    path = str(tmp_path / "sphere.obj")
    if with_normals:
        write_obj(path, mesh)
    else:
        with open(path, "w") as f:
            f.write(_obj_without_normals(mesh))
    got = fast_obj.load_obj_fast(path)
    assert got.num_triangles == 3200
    _equal(got, load_obj(path))
    _equal(got, jload_obj(path))
    corners = lambda m, f: getattr(m, f)[m.indices]  # noqa: E731
    for f in ("positions", "normals", "uvs")[:3 if with_normals else 1]:
        np.testing.assert_array_equal(corners(got, f), corners(mesh, f))


def test_native_available_builds_into_build_dir():
    assert fast_obj.native_available()
    path = native_build.ensure_native_built("libfastobj.so")
    assert os.path.dirname(path) == native_build.BUILD_DIR
    assert not any(f.endswith(".so") for f in
                   os.listdir(native_build.NATIVE_DIR))


def test_build_without_compiler_raises(tmp_path, monkeypatch):
    """A missing compiler raises from the build and from the loaders
    (lsr_tpu returns None there and parses in Python)."""
    monkeypatch.setattr(native_build, "CXX", str(tmp_path / "no-g++"))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="not found"):
        native_build.ensure_native_built("libfastobj.so")
    monkeypatch.setattr(fast_obj, "_LIB", None)
    with pytest.raises(RuntimeError, match="not found"):
        fast_obj.load_obj_fast(OBJ_TEXTS["mixed"], from_text=True)
    monkeypatch.setattr(png, "_PNG_LIB", None)
    with pytest.raises(RuntimeError, match="not found"):
        png.unfilter_native(b"\0" * 8, 2, 3, 3)


def test_failed_compile_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises with its output; nothing is
    left in the build directory."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "fast_obj.cpp").write_text("this is not C++\n")
    build = tmp_path / "build"
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(src))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(build))
    with pytest.raises(RuntimeError, match="failed to build libfastobj"):
        native_build.ensure_native_built("libfastobj.so")
    assert os.listdir(build) == []


def test_build_is_named_by_its_source(tmp_path, monkeypatch):
    """One library per source text, reused; an edited source builds a new
    one beside it."""
    src = tmp_path / "src"
    src.mkdir()
    code = (open(os.path.join(native_build.NATIVE_DIR, "png_filters.cpp"))
            .read())
    (src / "png_filters.cpp").write_text(code)
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(src))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    a = native_build.ensure_native_built("libpngfilters.so")
    assert native_build.ensure_native_built("libpngfilters.so") == a
    (src / "png_filters.cpp").write_text(code + "\n// edited\n")
    b = native_build.ensure_native_built("libpngfilters.so")
    assert b != a and sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(a), os.path.basename(b)])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(img, ftypes, channels):
    """The PNG stream of img (h, stride) u8 with row y filtered by
    ftypes[y] (RFC 2083 section 6)."""
    h, stride = img.shape
    out = b""
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        x = img[y].astype(np.int32)
        a = np.concatenate([np.zeros(channels, np.int32), x[:-channels]])
        c = np.concatenate([np.zeros(channels, np.int32), prev[:-channels]])
        pred = {0: 0, 1: a, 2: prev, 3: (a + prev) >> 1,
                4: _paeth(a, prev, c)}[ftypes[y]]
        out += bytes([ftypes[y]]) + ((x - pred) & 0xFF).astype(
            np.uint8).tobytes()
        prev = x
    return out


def _png_file(path, raw, w, h, channels):
    """An 8-bit PNG of w x h pixels whose IDAT holds the stream raw."""
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                          0))
        + png._chunk(b"IDAT", zlib.compress(raw))
        + png._chunk(b"IEND", b""))
    return str(path)


def _read_png_python(monkeypatch, path):
    """lsr_tpu's read_png through its Python decoder (its native unfilter
    switched off)."""
    monkeypatch.setattr(jpng, "_PNG_LIB", None)
    monkeypatch.setattr(jpng, "_PNG_LIB_TRIED", True)
    return jpng.read_png(path)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, None])
def test_png_unfilter_native_matches_python(tmp_path, monkeypatch, channels,
                                            ftype):
    """Hand-filtered rows of each filter type (None: all five mixed): the
    bound native unfilter gives the image, and read_png gives lsr_tpu's
    Python decoder's bytes."""
    rng = np.random.default_rng(channels * 10 + (ftype or 7))
    h, w = 9, 13
    img = rng.integers(0, 256, (h, w * channels)).astype(np.uint8)
    types = [ftype] * h if ftype is not None else [y % 5 for y in range(h)]
    raw = _filtered(img, types, channels)
    np.testing.assert_array_equal(
        png.unfilter_native(raw, h, w * channels, channels), img)
    path = _png_file(tmp_path / "f.png", raw, w, h, channels)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, img.reshape(h, w, channels))
    np.testing.assert_array_equal(got, _read_png_python(monkeypatch, path))


def test_png_unknown_filter_raises(tmp_path, monkeypatch):
    """An unknown filter byte raises from the native call and from
    read_png with lsr_tpu's message; so does a short stream (lsr_tpu
    decodes both in Python, which raises on the first)."""
    img = np.zeros((2, 6), np.uint8)
    raw = bytearray(_filtered(img, [0, 0], 3))
    raw[7] = 9
    with pytest.raises(ValueError, match="unsupported filter 9"):
        png.unfilter_native(bytes(raw), 2, 6, 3)
    with pytest.raises(ValueError, match="short of 2 rows"):
        png.unfilter_native(bytes(raw[:-1]), 2, 6, 3)
    path = _png_file(tmp_path / "bad.png", bytes(raw), 2, 2, 3)
    with pytest.raises(ValueError, match="unsupported filter 9"):
        png.read_png(path)
    with pytest.raises(ValueError, match="unsupported filter 9"):
        _read_png_python(monkeypatch, path)
