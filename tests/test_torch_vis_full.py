"""Kernel V2's full-resolution planes on the CPU: its plain version
(local_shadows.vis_planes_full_plain: vis_planes_plain on the strided grid,
then resize_bilinear) and the tile and halo layout its wrapper fixes on the
host (vis_kernel.axis_halo, upsample_layout), against
core/image._taps and resize_bilinear.

- The plain route equals resize_bilinear(vis_planes_plain(...)) bit for
  bit at vis_scale 1, 2 and 3, with even and odd frame sizes (ceil(H / 2) *
  2 != H), and local_shadow_vis_planes (what a frame calls) equals it too.
- Every output tile's taps lie inside the halo axis_halo gives it, for the
  (strided, full) sizes of the configurations the port renders.
- A model of V2's upsample in Python (each tile's halo staged, then the
  separable two-tap sums in the kernel's order, rows first) equals
  resize_bilinear bit for bit on random planes, so the kernel's order of
  operations is resize_bilinear's.
- At odd frame sizes the port's planes agree with lsr_tpu's as
  test_torch_local_shadows.py holds them (ESM within 1.3e-3; PCF within
  1e-6 on >= 99.9% of pixels).

The drill scene is tests/test_torch_vis_crop.py's: the grid-2 stand-in
under five shadowed lights (a tight spot, a wide spot, an empty footprint,
a point, a culled point).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_scenes import jax_flagship_scene

SPOT, POINT = 64, 32
ENABLED = np.array([1, 1, 1, 1, 0], bool)
SIZES = {"even": (128, 96), "odd": (131, 97)}


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def jscene():
    """The grid-2 stand-in, the five drill lights and lsr_tpu's atlas
    under ESM and PCF (slot by slot, torch_scenes.jax_local_atlas)."""
    from lsr_tpu.lighting.light_types import LightSetBuilder

    from torch_scenes import jax_local_atlas

    geom, objects, _, ctx = jax_flagship_scene(n_lights=16, grid=2)
    lb = LightSetBuilder()
    lb.spot((0.9, 3.0, -0.3), (0.0, -1.0, 0.0), intensity=3.0, range=5.0,
            inner_angle=0.1, outer_angle=0.15)
    lb.spot((-3.5, 4.0, 1.5), (0.0, -1.0, 0.0), intensity=3.0, range=9.0,
            inner_angle=0.6, outer_angle=1.1)
    lb.spot((0.0, 3.0, 0.0), (0.0, 1.0, 0.0), intensity=3.0, range=5.0,
            inner_angle=0.4, outer_angle=0.7)
    lb.point((0.8, 0.2, -1.6), intensity=2.0, range=2.0)
    lb.point((-2.4, 1.2, -2.4), intensity=2.0, range=3.0)
    lights = lb.build()
    atlas = {m: jax_local_atlas(geom, objects, lights, (0, 1, 2), (3, 4),
                                SPOT, POINT, m, caster_enabled=ENABLED)
             for m in ("esm", "pcf")}
    return dict(geom=geom, objects=objects, ctx=ctx, atlas=atlas)


@pytest.fixture(scope="module", params=list(SIZES))
def receivers(request, jscene):
    """(size name, lsr_tpu's world positions, normals and coverage) of
    camera 0 of the bench orbit at that size (brute raster)."""
    import jax.numpy as jnp

    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.shading.models import _norm

    from torch_scenes import jax_camera

    w, h = SIZES[request.param]
    geom, objects, ctx = jscene["geom"], jscene["objects"], jscene["ctx"]
    cam, _ = jax_camera(0, ctx, w, h)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, w, h)
    depth, tid = rasterize_brute(setup, w, h, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials,
                             want_face_normal=False)
    return (request.param, gb.world_pos, jnp.asarray(_norm(gb.normal_ws)),
            np.asarray(gb.covered))


def _maps(jscene, mode, vis_scale, h, w):
    """(lsr_tpu's maps, the port's) at vis_scale with the default cascade
    of an h x w frame."""
    from lsr_tpu.lighting.local_shadows import default_vis_crop

    from lsr_tpu_torch.convert import local_shadow_maps

    ref = dataclasses.replace(jscene["atlas"][mode], vis_scale=vis_scale,
                              vis_crop=default_vis_crop(h, w))
    return ref, local_shadow_maps(ref, "cpu")


@pytest.mark.parametrize("vis_scale", [1, 2, 3])
@pytest.mark.parametrize("mode", ["esm", "pcf"])
def test_full_plain_is_the_resized_strided_planes(jscene, receivers, mode,
                                                  vis_scale):
    """vis_planes_full_plain is resize_bilinear(vis_planes_plain(...)) bit
    for bit (vis_planes_plain itself at vis_scale 1), at world_pos's full
    size, and local_shadow_vis_planes returns it."""
    from lsr_tpu_torch.core.image import resize_bilinear
    from lsr_tpu_torch.lighting import local_shadows as ls

    name, wp, nm, _ = receivers
    w, h = SIZES[name]
    _, sh = _maps(jscene, mode, vis_scale, h, w)
    wp, nm = _t(wp), _t(nm)
    win, run = ls.vis_windows_plain(sh, wp)
    strided = ls.vis_planes_plain(sh, wp, nm, win, run)
    hs, ws = ls.vis_grid_shape(sh, wp)
    assert strided.shape == (6, hs, ws)
    if name == "odd" and vis_scale > 1:
        assert hs * vis_scale != h and ws * vis_scale != w
    want = (strided if vis_scale == 1
            else resize_bilinear(strided, (6, h, w)))
    got = ls.vis_planes_full_plain(sh, wp, nm, win, run)
    assert got.shape == (6, h, w)
    assert torch.equal(got, want)
    assert torch.equal(ls.local_shadow_vis_planes(sh, wp, nm), got)
    assert bool((got[:-1] < 1.0).any())
    assert torch.allclose(got[5], torch.ones(()), rtol=0.0, atol=1e-6)


# (strided, full) axis sizes of the configurations the port renders:
# flagship (a) at 1920x1080 (vis_scale 2), the presets and compositions at
# 1280x720 and 800x600, the sharded frame at 1920x1088, the tests' 192x108,
# 128x96 and 131x97, and vis_scale 3 / 4 at odd sizes.
AXES = [(540, 1080), (960, 1920), (360, 720), (640, 1280), (300, 600),
        (400, 800), (544, 1088), (54, 108), (96, 192), (48, 96), (64, 128),
        (49, 97), (66, 131), (33, 97), (44, 131), (25, 97), (33, 131),
        (97, 97), (1, 1)]


@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 128])
@pytest.mark.parametrize("m,n", AXES)
def test_every_tile_lies_inside_its_halo(m, n, tile):
    """core/image._taps' indices rise with the output (an axis that keeps
    its size reads each sample itself, weights (1, 0)); every output of a
    tile reads only samples in [i0 of the tile's first output, +
    axis_halo)."""
    from lsr_tpu_torch.core.image import _taps
    from lsr_tpu_torch.lighting.vis_kernel import axis_halo

    i0, i1, w0, w1 = _taps(m, n, torch.device("cpu"))
    if m == n:
        assert torch.equal(i0, torch.arange(n))
        assert (w0 == 1.0).all() and (w1 == 0.0).all()
    assert bool((i0[1:] >= i0[:-1]).all()) and bool((i1[1:] >= i1[:-1]).all())
    assert bool((i1 >= i0).all()) and int(i1.max()) < m and int(i0.min()) >= 0
    halo = axis_halo(m, n, tile)
    for t in range(0, n, tile):
        lo = int(i0[t])
        for j in range(t, min(t + tile, n)):
            assert lo <= int(i0[j]) and int(i1[j]) < lo + halo, (t, j)
    if m < n:
        assert halo <= -(-tile * m // n) + 2


def test_upsample_layout_fits_shared_memory():
    """upsample_layout takes the most rows whose halos of K planes fit
    V2_SMEM bytes: 8 x 128 tiles for flagship (a)'s ten planes (a 6 x 66
    halo), fewer rows for more planes, and raises where none fits."""
    from lsr_tpu_torch.lighting import vis_kernel as vk

    assert vk.upsample_layout(10, 540, 960, 1080, 1920) == (
        8, 6, 66, 4 * 10 * (4 + 6 * 66))
    tile_h, halo_h, halo_w, smem = vk.upsample_layout(80, 540, 960, 1080,
                                                      1920)
    assert tile_h < 8 and smem <= vk.V2_SMEM
    assert halo_h == vk.axis_halo(540, 1080, tile_h) and halo_w == 66
    with pytest.raises(ValueError):
        vk.upsample_layout(400, 540, 960, 1080, 1920)


def _v2_upsample_model(strided, h, w, tile_h):
    """V2's upsample as the kernel runs it: per tile_h x 128 output tile, the halo of strided samples its taps reach, then per
    output r0 = a[c0] * wy0 + b[c0] * wy1, r1 likewise at c1, and r0 * wx0
    + r1 * wx1, each product and sum rounded in f32."""
    from lsr_tpu_torch.core.image import _taps

    k, hs, ws = strided.shape
    cpu = torch.device("cpu")
    i0y, i1y, w0y, w1y = _taps(hs, h, cpu)
    i0x, i1x, w0x, w1x = _taps(ws, w, cpu)
    out = torch.empty((k, h, w), dtype=torch.float32)
    for ty in range(0, h, tile_h):
        for tx in range(0, w, 128):
            ys = torch.arange(ty, min(ty + tile_h, h))
            xs = torch.arange(tx, min(tx + 128, w))
            hy0, hx0 = int(i0y[ty]), int(i0x[tx])
            halo = strided[:, hy0:int(i1y[ys[-1]]) + 1,
                           hx0:int(i1x[xs[-1]]) + 1]
            a = halo[:, i0y[ys] - hy0]
            b = halo[:, i1y[ys] - hy0]
            wy0, wy1 = w0y[ys][None, :, None], w1y[ys][None, :, None]
            c0, c1 = i0x[xs] - hx0, i1x[xs] - hx0
            r0 = a[:, :, c0] * wy0 + b[:, :, c0] * wy1
            r1 = a[:, :, c1] * wy0 + b[:, :, c1] * wy1
            out[:, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = (
                r0 * w0x[xs] + r1 * w1x[xs])
    return out


@pytest.mark.parametrize("hw", [(96, 128), (97, 131), (108, 192),
                                (1080, 1920)])
@pytest.mark.parametrize("sc", [2, 3])
def test_v2_upsample_model_equals_resize_bilinear(hw, sc):
    """The kernel's tiled upsample (_v2_upsample_model, at the layout
    upsample_layout picks for ten planes and for eighty) equals
    resize_bilinear bit for bit on random planes with ones in them."""
    from lsr_tpu_torch.core.image import resize_bilinear
    from lsr_tpu_torch.lighting.vis_kernel import upsample_layout

    h, w = hw
    hs, ws = -(-h // sc), -(-w // sc)
    rng = np.random.default_rng(h * 7 + sc)
    planes = rng.random((3, hs, ws), np.float32)
    planes[1, :, ::3] = 1.0
    planes[2] = 1.0
    x = torch.as_tensor(planes)
    want = resize_bilinear(x, (3, h, w))
    for k in (10, 80):
        tile_h = upsample_layout(k, hs, ws, h, w)[0]
        assert torch.equal(_v2_upsample_model(x, h, w, tile_h), want)


@pytest.mark.parametrize("vis_scale", [1, 2])
@pytest.mark.parametrize("mode", ["esm", "pcf"])
def test_full_planes_match_jax_at_odd_sizes(jscene, receivers, mode,
                                            vis_scale):
    """The full-resolution planes against lsr_tpu's (its lax.cond cascade
    and jax.image.resize) at both frame sizes, within the contract of
    test_torch_local_shadows.py; the empty footprint, the culled point and
    plane K stay 1.0."""
    from lsr_tpu.lighting.local_shadows import (
        local_shadow_vis_planes as jplanes)

    from lsr_tpu_torch.lighting.local_shadows import local_shadow_vis_planes

    name, wp, nm, covered = receivers
    w, h = SIZES[name]
    ref, sh = _maps(jscene, mode, vis_scale, h, w)
    want = np.asarray(jplanes(ref, wp, nm))
    got = local_shadow_vis_planes(sh, _t(wp), _t(nm)).numpy()
    assert got.shape == want.shape == (6, h, w)
    for k in (2, 4, 5):
        assert (got[k] == 1.0).all()
    assert ((want[:-1] < 0.999) & covered).sum() > 10
    d = np.abs(got - want)
    if mode == "esm":
        assert d.max() <= 1.3e-3, d.max()
    else:
        assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 0.03, d.max()


def test_v2_on_a_card_tensor_launches_or_raises(monkeypatch):
    """The wrappers take the plain route for CPU tensors only: a tensor on
    any other device takes the kernel route, which raises where the device
    is no CUDA card, and never falls back to the plain version."""
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.lighting import vis_kernel as vk

    called = []
    monkeypatch.setattr(ls, "vis_planes_full_plain",
                        lambda *a: called.append(a))
    monkeypatch.setattr(ls, "vis_windows_plain", lambda *a: called.append(a))
    wp = torch.zeros((4, 4, 3), device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        vk.vis_planes(None, wp, wp, None, None)
    with pytest.raises((RuntimeError, ValueError)):
        vk.vis_windows(None, wp)
    assert not called
