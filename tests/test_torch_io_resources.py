"""The port's host edges against lsr_tpu's, on files and arrays the tests
make from numpy seeds: io.png (write_png, save_canvas_png, read_png with
every filter and color type), utils.host (fetch, fetch_image), core.gather
(take_rows), resources.cubemap (load_cubemap), resources.textures
(load_texture_linear, ResourceRegistry) and convert's carriers of their
arrays.  Every comparison is bit for bit: these are byte and integer
paths, and the loaders' float math is the same numpy on both sides.
"""

from __future__ import annotations

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu_torch import convert


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_png(path, img, filters):
    """A PNG of img (H, W, C) u8 whose row y uses scanline filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, ch = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch).astype(np.int32)
    raw = b""
    prev = np.zeros(w * ch, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        f = filters[y % len(filters)]
        pred = [np.zeros_like(cur), left, prev, (left + prev) >> 1,
                _paeth(left, prev, upleft)][f]
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_read_png_matches_jax(tmp_path, channels, filters):
    from lsr_tpu.io.png import read_png as jread
    from lsr_tpu_torch.io.png import read_png

    rng = np.random.default_rng(channels * 10 + len(filters) + filters[0])
    img = rng.integers(0, 256, (11, 13, channels)).astype(np.uint8)
    img[:, :5] = img[:, 5:6]                   # runs the filters predict
    path = str(tmp_path / "f.png")
    _encode_png(path, img, filters)
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jread(path))
    assert got.dtype == np.uint8


def test_write_and_save_canvas_png_match_jax(tmp_path):
    """The port's write_png / save_canvas_png write the same bytes as
    lsr_tpu's; read_png of them gives the image back bit for bit, on both
    sides (save_canvas_png flips the rows)."""
    from lsr_tpu.io.png import read_png as jread
    from lsr_tpu.io.png import save_canvas_png as jsave
    from lsr_tpu.io.png import write_png as jwrite
    from lsr_tpu_torch.io.png import read_png, save_canvas_png, write_png

    img = np.random.default_rng(1).integers(0, 256, (37, 53, 3)) \
        .astype(np.uint8)
    for ours, theirs, want in ((write_png, jwrite, img),
                               (save_canvas_png, jsave, img[::-1])):
        a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        ours(a, img)
        theirs(b, img)
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(read_png(a), want)
        np.testing.assert_array_equal(jread(a), want)
    with pytest.raises(ValueError):
        read_png(__file__)


def test_fetch_and_take_rows_match_jax():
    """fetch / fetch_image give the tensor's bytes and dtype (u8 as u8,
    as lsr_tpu's widen-and-narrow does); take_rows gathers as lsr_tpu's
    (negative ids from the end, others out of range clamped)."""
    from lsr_tpu.core.gather import take_rows as jtake
    from lsr_tpu.utils.host import fetch as jfetch
    from lsr_tpu_torch.core.gather import take_rows
    from lsr_tpu_torch.utils.host import fetch, fetch_image

    rng = np.random.default_rng(2)
    for a in (rng.integers(0, 256, (9, 7, 3)).astype(np.uint8),
              rng.normal(size=(5, 4)).astype(np.float32),
              rng.integers(-9, 9, (6,)).astype(np.int32)):
        want = jfetch(jnp.asarray(a))
        for fn in (fetch, fetch_image):
            got = fn(torch.as_tensor(a))
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert fetch(a).tobytes() == a.tobytes()

    table = rng.normal(size=(20, 3, 2)).astype(np.float32)
    idx = rng.integers(0, 20, (4, 5)).astype(np.int32)
    idx[0, :4] = (-1, -20, 25, -23)
    np.testing.assert_array_equal(
        take_rows(torch.as_tensor(table), torch.as_tensor(idx)).numpy(),
        np.asarray(jtake(jnp.asarray(table), jnp.asarray(idx))))


def _faces(tmp_path, size, seed, names=None, channels=3):
    from lsr_tpu.resources.cubemap import FACE_FILES
    from lsr_tpu_torch.io.png import write_png

    rng = np.random.default_rng(seed)
    paths = []
    for k, name in enumerate(names or FACE_FILES):
        img = rng.integers(0, 256, (size, size, channels)).astype(np.uint8)
        img[: size // 2] = k * 40                # a flat top half per face
        p = str(tmp_path / f"{name}.png")
        if channels == 3:
            write_png(p, img)
        else:
            _encode_png(p, img, (0, 4))
        paths.append(p)
    return paths


@pytest.mark.parametrize("size,srgb,channels", [(None, True, 3), (8, True, 3),
                                                (4, False, 4), (8, True, 4)])
def test_load_cubemap_matches_jax(tmp_path, size, srgb, channels):
    """load_cubemap on a directory of faces the test writes (and on the
    list of their paths), equal to lsr_tpu's; its vertical flip puts each
    file's top rows at the top of the face (row S-1)."""
    from lsr_tpu.resources.cubemap import load_cubemap as jload
    from lsr_tpu_torch.resources.cubemap import FACE_FILES, load_cubemap

    assert FACE_FILES == ("right", "left", "top", "bottom", "front", "back")
    paths = _faces(tmp_path, 16, 3, channels=channels)
    a = load_cubemap(str(tmp_path), size=size, srgb=srgb)
    np.testing.assert_array_equal(a, jload(str(tmp_path), size=size,
                                           srgb=srgb))
    np.testing.assert_array_equal(a, load_cubemap(paths, size=size,
                                                  srgb=srgb))
    s = a.shape[1]
    assert a.shape == (6, s, s, 3) and a.dtype == np.float32
    for k in range(6):
        assert np.all(a[k, s - 1] == a[k, s - 1, 0, 0])   # flat file top
    with pytest.raises(ValueError):
        load_cubemap(paths[:5])
    with pytest.raises(ValueError):
        load_cubemap(str(tmp_path), size=5)


def test_load_texture_and_registry_match_jax(tmp_path):
    """load_texture_linear (RGB, RGBA, gray; nearest resize) and the
    ResourceRegistry's stack, equal to lsr_tpu's; convert carries the
    stack and a cubemap."""
    from lsr_tpu.resources.textures import ResourceRegistry as JReg
    from lsr_tpu.resources.textures import load_texture_linear as jtex
    from lsr_tpu_torch.resources.textures import (
        ResourceRegistry, load_texture_linear)

    rng = np.random.default_rng(4)
    paths = []
    for ch, sz in ((3, 16), (4, 16), (1, 12), (3, 24)):
        img = rng.integers(0, 256, (sz, sz, ch)).astype(np.uint8)
        p = str(tmp_path / f"t{ch}_{sz}.png")
        _encode_png(p, img, (0, 1, 2, 3, 4))
        paths.append(p)
    for p in paths:
        for size in (None, 16, 8):
            np.testing.assert_array_equal(load_texture_linear(p, size),
                                          jtex(p, size))
    regs = []
    for cls in (ResourceRegistry, JReg):
        r = cls()
        r.add_mesh("mesh")
        for p in paths:
            r.load_texture(p, 16 if p is paths[0] else None)
        r.add_material(base_color=(1, 0, 0))
        with pytest.raises(ValueError):
            r.add_texture(np.zeros((4, 4, 3), np.float32))
        regs.append(r)
    ours, theirs = regs
    assert ours.counts() == theirs.counts() == {
        "meshes": 1, "textures": 4, "materials": 1}
    assert ours.get_mesh(0) == "mesh" and ours.get_mesh(3) is None
    assert ours.materials() == theirs.materials()
    np.testing.assert_array_equal(ours.texture_array(),
                                  theirs.texture_array())
    assert ResourceRegistry().texture_array() is None
    t = convert.texture_array(theirs, "cpu")
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), theirs.texture_array())
    assert convert.texture_array(JReg(), "cpu") is None

    faces = rng.uniform(size=(6, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        convert.cubemap(jnp.asarray(faces), "cpu").numpy(), faces)
