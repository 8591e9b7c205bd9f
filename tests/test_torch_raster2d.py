"""lsr_tpu_torch's 2D and debug rasters (raster/lines.py, wireframe.py,
primitives2d.py, debug_draw.py) against lsr_tpu's on the same seeded numpy
inputs, on the CPU, bit for bit.

The line scatter's winner is the largest flattened (line, step) index per
pixel, which is the step XLA:CPU's `.at[].set` leaves last; the debug
overlay's clip transform sums as lsr_tpu's product does.  Every canvas is
uint8 (the f32 overlay float32) and must be equal on every pixel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu.raster import debug_draw as jdd
from lsr_tpu.raster import lines as jl
from lsr_tpu.raster import primitives2d as jp
from lsr_tpu_torch.raster import debug_draw as tdd
from lsr_tpu_torch.raster import lines as tl
from lsr_tpu_torch.raster import primitives2d as tp


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def _canvas(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# lines
# ---------------------------------------------------------------------------

def test_line_points_bit_for_bit():
    """200 random segments, some of length 0, both endpoint orders."""
    rng = np.random.default_rng(1)
    p0 = rng.integers(-30, 30, (200, 2)).astype(np.int32)
    p1 = rng.integers(-30, 30, (200, 2)).astype(np.int32)
    p1[:5] = p0[:5]
    ref = jl.line_points(jnp.asarray(p0), jnp.asarray(p1), max_steps=64)
    got = tl.line_points(p0, p1, max_steps=64, device="cpu")
    for a, b in zip(got, ref):
        _eq(a, b)
    assert got[2].any(1).all() and not got[2].all()


def test_line_points_truncates_float_endpoints():
    """Float endpoints are truncated toward zero to int32, as
    jnp.asarray(p, jnp.int32) does (hello_pixel_primitives' line star)."""
    rng = np.random.default_rng(2)
    p0 = rng.uniform(-40, 40, (64, 2)).astype(np.float32)
    p1 = rng.uniform(-40, 40, (64, 2)).astype(np.float32)
    ref = jl.line_points(jnp.asarray(p0), jnp.asarray(p1), max_steps=128)
    got = tl.line_points(torch.as_tensor(p0), torch.as_tensor(p1),
                         max_steps=128)
    for a, b in zip(got, ref):
        _eq(a, b)


def test_rasterize_lines_later_line_wins():
    """Two identical lines of colors 10 and 20 leave 20; a crossing third
    line of color 30 wins its pixels; the port's canvas equals lsr_tpu's."""
    canvas = np.zeros((16, 16, 3), np.uint8)
    p0 = np.array([[0, 0], [0, 0], [0, 15]], np.int32)
    p1 = np.array([[15, 15], [15, 15], [15, 0]], np.int32)
    col = np.array([[10] * 3, [20] * 3, [30] * 3], np.uint8)
    ref = jl.rasterize_lines(jnp.asarray(canvas), jnp.asarray(p0),
                             jnp.asarray(p1), jnp.asarray(col))
    got = tl.rasterize_lines(torch.as_tensor(canvas), p0, p1, col)
    _eq(got, ref)
    g = got.numpy()
    assert (g[3, 3] == 20).all() and (g[12, 3] == 30).all()
    assert (g[8, 7] == 30).all() or (g[7, 7] == 30).all()


@pytest.mark.parametrize("seed", range(4))
def test_rasterize_lines_overlaps_and_bounds(seed):
    """30 overlapping lines of different colors with endpoints out of
    bounds and negative, over a noisy canvas; one color for all, then one
    per line; a max_steps that cuts the longest lines."""
    rng = np.random.default_rng(10 + seed)
    h, w = 40, 50
    p0 = rng.integers(-25, 75, (30, 2)).astype(np.int32)
    p1 = rng.integers(-25, 75, (30, 2)).astype(np.int32)
    cols = rng.integers(0, 256, (30, 3)).astype(np.uint8)
    canvas = _canvas(rng, h, w)
    for color, steps in ((cols, None), ((0, 255, 0), None), (cols, 20)):
        ref = jl.rasterize_lines(jnp.asarray(canvas), jnp.asarray(p0),
                                 jnp.asarray(p1),
                                 jnp.asarray(color, jnp.uint8),
                                 max_steps=steps)
        got = tl.rasterize_lines(torch.as_tensor(canvas), p0, p1, color,
                                 max_steps=steps)
        _eq(got, ref)


def test_rasterize_lines_drops_negative_coordinates():
    """A line running from negative coordinates into the canvas: nothing
    wraps around to the far edge."""
    canvas = np.zeros((16, 16, 3), np.uint8)
    p0 = np.array([[-5, 8], [8, -7]], np.int32)
    p1 = np.array([[20, 8], [8, 3]], np.int32)
    got = tl.rasterize_lines(torch.as_tensor(canvas), p0, p1, (0, 255, 0))
    ref = jl.rasterize_lines(jnp.asarray(canvas), jnp.asarray(p0),
                             jnp.asarray(p1), jnp.asarray([0, 255, 0],
                                                          jnp.uint8))
    _eq(got, ref)
    lit = got.numpy().any(-1)
    assert lit[8].all() and lit[:4, 8].all() and not lit[4:8, 8].any()


@pytest.mark.parametrize("per_line", [False, True])
def test_rasterize_lines_f32(per_line):
    rng = np.random.default_rng(21)
    h, w, c = 24, 32, 4
    buf = rng.standard_normal((h, w, c)).astype(np.float32)
    p0 = rng.integers(-10, 40, (12, 2)).astype(np.int32)
    p1 = rng.integers(-10, 40, (12, 2)).astype(np.int32)
    val = (rng.standard_normal((12, c)) if per_line
           else rng.standard_normal(c)).astype(np.float32)
    ref = jl.rasterize_lines_f32(jnp.asarray(buf), jnp.asarray(p0),
                                 jnp.asarray(p1), jnp.asarray(val))
    got = tl.rasterize_lines_f32(torch.as_tensor(buf), p0, p1, val)
    _eq(got, ref)


# ---------------------------------------------------------------------------
# wireframe
# ---------------------------------------------------------------------------

def _meshes(name):
    from lsr_tpu.io import obj as jobj
    from lsr_tpu_torch.io import obj as tobj

    if name == "cube":
        return jobj.make_cube(1.2), tobj.make_cube(1.2)
    return (jobj.make_uv_sphere(0.9, rings=16, sectors=32),
            tobj.make_uv_sphere(0.9, rings=16, sectors=32))


@pytest.mark.parametrize("name,size", [("cube", (64, 48)),
                                       ("sphere", (120, 96)),
                                       ("sphere", (600, 600))])
def test_render_wireframe(name, size):
    """Edges (v0, v1), (v1, v2), the strict interior test and the
    truncating projection: the canvas equal to lsr_tpu's."""
    from lsr_tpu.raster.wireframe import render_wireframe as jrw
    from lsr_tpu_torch.raster.wireframe import render_wireframe as trw

    jm, tm = _meshes(name)
    w, h = size
    ref = jrw(jm, w, h, color=(0, 255, 0), bg=(5, 6, 7))
    got = trw(tm, w, h, color=(0, 255, 0), bg=(5, 6, 7), device="cpu")
    _eq(got, ref)
    assert (got.numpy()[..., 1] == 255).sum() > 50


# ---------------------------------------------------------------------------
# primitives2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rect", [(2, 3, 5, 4), (-3, -2, 8, 6),
                                  (30, 20, 50, 50)])
def test_fill_rect(rect):
    rng = np.random.default_rng(3)
    c = _canvas(rng, 32, 40)
    _eq(tp.fill_rect(torch.as_tensor(c), *rect, (255, 0, 9)),
        jp.fill_rect(jnp.asarray(c), *rect, (255, 0, 9)))


@pytest.mark.parametrize("r,seg", [(80, 48), (52, 12), (26, 5), (120, 7)])
def test_draw_circle_poly(r, seg):
    c = np.zeros((200, 200, 3), np.uint8)
    _eq(tp.draw_circle_poly(torch.as_tensor(c), 100, 100, r, seg,
                            (120, 220, 250)),
        jp.draw_circle_poly(jnp.asarray(c), 100, 100, r, seg,
                            (120, 220, 250)))


def test_draw_triangle_outline():
    rng = np.random.default_rng(4)
    c = _canvas(rng, 64, 64)
    for _ in range(8):
        v = rng.integers(-10, 74, (3, 2))
        _eq(tp.draw_triangle_outline(torch.as_tensor(c), v, (90, 170, 250)),
            jp.draw_triangle_outline(jnp.asarray(c), v, (90, 170, 250)))


@pytest.mark.parametrize("kind", ["integer", "float", "degenerate"])
def test_fill_triangle_2d(kind):
    """Random triangles with integer and float corners over the canvas
    edges, and degenerate ones (a repeated corner, collinear corners)."""
    rng = np.random.default_rng({"integer": 5, "float": 6,
                                 "degenerate": 7}[kind])
    c = np.zeros((96, 128, 3), np.uint8)
    for k in range(24):
        v = rng.uniform(-20, 140, (3, 2)).astype(np.float32)
        if kind == "integer":
            v = np.round(v)
        elif kind == "degenerate":
            v[2] = v[0] if k % 2 else v[0] + 0.5 * (v[1] - v[0])
        _eq(tp.fill_triangle_2d(torch.as_tensor(c), v, (250, 120, 90)),
            jp.fill_triangle_2d(jnp.asarray(c), v, (250, 120, 90)))


@pytest.mark.parametrize("alpha", ["scalar", "map", "half"])
def test_alpha_blend(alpha):
    """dst (1 - a) + src a, rounded half to even: scalar, per-pixel, and
    a = 0.5 over values whose blends land on .5 exactly."""
    rng = np.random.default_rng(8)
    d, s = _canvas(rng, 48, 40), _canvas(rng, 48, 40)
    a = {"scalar": 0.45,
         "map": rng.uniform(0, 1, (48, 40)).astype(np.float32),
         "half": 0.5}[alpha]
    got = tp.alpha_blend(torch.as_tensor(d), torch.as_tensor(s), a)
    _eq(got, jp.alpha_blend(jnp.asarray(d), jnp.asarray(s), a))
    if alpha == "half":
        odd = (d.astype(int) + s.astype(int)) % 2 == 1
        assert odd.any()


@pytest.mark.parametrize("xy", [(16, 16), (88, 88), (-10, 5), (30, -20),
                                (150, 150)])
def test_image_blit(xy):
    rng = np.random.default_rng(9)
    c, img = _canvas(rng, 120, 100), _canvas(rng, 30, 24)
    _eq(tp.image_blit(torch.as_tensor(c), torch.as_tensor(img), *xy),
        jp.image_blit(jnp.asarray(c), jnp.asarray(img), *xy))


# ---------------------------------------------------------------------------
# debug_draw
# ---------------------------------------------------------------------------

def _vp(w, h, eye):
    from lsr_tpu.core import math3d as m3

    view = m3.look_at_lh(jnp.asarray(eye, jnp.float32), jnp.zeros(3),
                         jnp.asarray([0.0, 1.0, 0.0]))
    proj = m3.perspective_lh_no(np.pi / 3, w / h, 0.1, 100.0)
    vp = proj @ view
    return vp, torch.as_tensor(np.array(vp))


def test_draw_segments_near_plane_crossing():
    """lsr_tpu's overlay cases: a horizontal segment through the centre and
    one crossing the near plane (clipped, not wrapped)."""
    w, h = 64, 64
    vp, tvp = _vp(w, h, (0, 0, -5.0))
    ldr = np.zeros((h, w, 3), np.uint8)
    p0 = np.array([[-1.0, 0.0, 0.0], [0.0, 0.5, -10.0]], np.float32)
    p1 = np.array([[1.0, 0.0, 0.0], [0.0, 0.5, 5.0]], np.float32)
    s_ref = jdd.project_segments(jnp.asarray(p0), jnp.asarray(p1), vp, w, h)
    s_got = tdd.project_segments(p0, p1, tvp, w, h)
    for a, b in zip(s_got, s_ref):
        _eq(a, b)
    assert bool(s_got[2][1])          # the crossing segment is kept, clipped
    got = tdd.draw_segments(torch.as_tensor(ldr), p0, p1, tvp)
    _eq(got, jdd.draw_segments(jnp.asarray(ldr), jnp.asarray(p0),
                               jnp.asarray(p1), vp))
    assert got.numpy()[h // 2 - 2:h // 2 + 2].any(-1).sum() > 10


@pytest.mark.parametrize("seed", range(3))
def test_draw_segments_random(seed):
    """40 random segments around random eyes, many behind the camera or
    crossing its near plane, over a noisy frame."""
    rng = np.random.default_rng(30 + seed)
    w, h = 96, 72
    vp, tvp = _vp(w, h, tuple(rng.uniform(-6, 6, 3)))
    p0 = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    p1 = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    ldr = _canvas(rng, h, w)
    for a, b in zip(tdd.project_segments(p0, p1, tvp, w, h),
                    jdd.project_segments(jnp.asarray(p0), jnp.asarray(p1),
                                         vp, w, h)):
        _eq(a, b)
    _eq(tdd.draw_segments(torch.as_tensor(ldr), p0, p1, tvp, (1, 2, 3)),
        jdd.draw_segments(jnp.asarray(ldr), jnp.asarray(p0),
                          jnp.asarray(p1), vp, (1, 2, 3)))


def test_draw_aabbs():
    """aabb_segments' corners and edges, and the boxes drawn."""
    rng = np.random.default_rng(40)
    w, h = 96, 96
    vp, tvp = _vp(w, h, (1.5, 2.0, -5.0))
    lo = rng.uniform(-2, 0, (5, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 2, (5, 3)).astype(np.float32)
    for a, b in zip(tdd.aabb_segments(lo, hi, device="cpu"),
                    jdd.aabb_segments(jnp.asarray(lo), jnp.asarray(hi))):
        _eq(a, b)
    assert tdd.aabb_segments(lo, hi, device="cpu")[0].shape == (60, 3)
    got = tdd.draw_aabbs(torch.zeros((h, w, 3), dtype=torch.uint8), lo, hi,
                         tvp)
    _eq(got, jdd.draw_aabbs(jnp.zeros((h, w, 3), jnp.uint8),
                            jnp.asarray(lo), jnp.asarray(hi), vp))
    assert got.numpy().any(-1).sum() > 50
