"""lsr_tpu_torch binned (B3) and chunk-worklist (B4) rasterizers, and the
tile arguments of the direct rasterizer (B1), vs lsr_tpu (CPU).

Both packages rasterize the same TriSetup (lsr_tpu's, converted): the
procedural grid-2 flagship scene at 160x96, whose width is not a multiple
of the 128-pixel tile.  lsr_tpu runs rasterize_tiled / rasterize_chunklist /
rasterize_direct in Pallas interpret mode; the port runs the plain versions
that its wrappers take for CPU tensors, over the same lists the CUDA kernels
get.

Tolerances, as in test_torch_raster.py: XLA:CPU contracts A*x + B*y + C
into FMAs and torch does not, so depth01 agrees within 2e-5 and tids on
>= 99.8% of covered pixels.  Lists, counts and maxima are integers and
must be equal.  Within the port, the plain versions equal rasterize_brute
bit for bit when no list is capped.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import jax_camera, jax_flagship_scene, torch_setup

W, H = 160, 96


@pytest.fixture(scope="module")
def scene():
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, _, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, _ = jax_camera(0, ctx, W, H)
    js = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                     geom.vtx_obj, geom.tri_obj, objects.model,
                     objects.normal_mat, cam.viewproj, W, H,
                     obj_visible=objects.visible)
    return dict(js=js, ts=torch_setup(js), cam=cam, zn=float(cam.zn),
                zf=float(cam.zf))


@pytest.fixture(scope="module")
def brute(scene):
    """The port's rasterize_brute on the same setup, view-z and NDC01."""
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ

    return {m: rasterize_brute(scene["ts"], W, H, scene["zn"], scene["zf"],
                               depth_mode=m)
            for m in (DEPTH_VIEWZ, DEPTH_NDC01)}


def _compare(jd, jt, td, tt, depth_tol=2e-5):
    jd, jt = np.asarray(jd), np.asarray(jt)
    td, tt = td.numpy(), tt.numpy()
    same = jt == tt
    covered = max(int((jt >= 0).sum()), 1)
    assert (~same).sum() <= 0.002 * covered, ((~same).sum(), covered)
    err = np.abs(jd - td)[same].max()
    assert err <= depth_tol, err


def _mode(name):
    from lsr_tpu_torch.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ

    return DEPTH_VIEWZ if name == "viewz" else DEPTH_NDC01


def _cube_setups(w, h):
    """Two make_cube draws (lsr_tpu's test_tiled_depth_chaining scene) as
    lsr_tpu_torch setups."""
    from lsr_tpu.core import math3d as m3
    from lsr_tpu.io.obj import make_cube
    from lsr_tpu.raster.setup import scene_setup

    cube = make_cube(1.5)
    vp = np.asarray(m3.perspective_lh_no(np.pi / 3, w / h, 0.1, 100.0)
                    @ m3.look_at_lh(jnp.array([0.0, 0.0, -3.0]),
                                    jnp.array([0.0, 0.0, 0.0]),
                                    jnp.array([0.0, 1.0, 0.0])))
    out = []
    for model in (m3.translate([-0.4, 0.0, 0.2]),
                  m3.translate([0.4, 0.0, -0.2]) @ m3.rotate_y(0.6)):
        m = np.asarray(model)
        s = scene_setup(jnp.asarray(cube.positions), jnp.asarray(cube.normals),
                        jnp.asarray(cube.uvs), jnp.asarray(cube.indices),
                        jnp.zeros(cube.num_vertices, jnp.int32),
                        jnp.zeros(cube.num_triangles, jnp.int32),
                        jnp.asarray(m)[None],
                        np.asarray(m3.normal_matrix(jnp.asarray(m)))[None],
                        jnp.asarray(vp), w, h)
        out.append(torch_setup(s))
    return out


# ---------------------------------------------------------------------------
# B3: binning and the binned raster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_h,cap", [(32, 16), (32, 1024), (32, 2048),
                                        (16, 64), (64, 4096)])
def test_bin_triangles_matches_jax(scene, tile_h, cap):
    """Lists, capped counts and max_bin are the same integers as lsr_tpu's
    dense-mask binning, also under a cap that truncates (cap 16 and 1024:
    the counterpart of test_tiled_overflow_reported)."""
    from lsr_tpu.raster.tiled import bin_triangles as jbin

    from lsr_tpu_torch.raster.tiled import bin_triangles, fitted_cap

    jl, jc, jm = jbin(scene["js"], W, H, tile_h, 128, cap)
    tl, tc, tm = bin_triangles(scene["ts"], W, H, tile_h, 128, cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tm) == int(jm)
    if cap < int(jm):
        assert int(tc.max()) == cap
    # fit_cap raises the cap to the rule of lsr_tpu's bench: nothing dropped.
    fl, fc, fm = bin_triangles(scene["ts"], W, H, tile_h, 128, cap,
                               fit_cap=True)
    assert fl.shape[1] == fitted_cap(cap, int(jm)) >= int(jm)
    assert int(fc.max()) == int(fm) == int(jm)


@pytest.mark.parametrize("tile_h,chunk,mode", [
    (16, 8, "viewz"), (32, 8, "viewz"), (64, 8, "viewz"), (16, 16, "ndc01"),
    (32, 16, "viewz"), (64, 16, "ndc01")])
def test_rasterize_tiled_matches_jax(scene, tile_h, chunk, mode):
    """rasterize_tiled with a cap that drops nothing (fitted_cap) vs
    lsr_tpu's at the same cap: same max_bin, depth and tids under the
    module's contract."""
    from lsr_tpu.raster.tiled import rasterize_tiled as jrt

    from lsr_tpu_torch.raster.tiled import (
        bin_triangles,
        fitted_cap,
        rasterize_tiled,
    )

    _, _, m = bin_triangles(scene["ts"], W, H, tile_h, 128, 256)
    cap = fitted_cap(256, int(m))
    cam = scene["cam"]
    jd, jt, jm = jrt(scene["js"], W, H, cam.zn, cam.zf,
                     depth_mode=_mode(mode), tile_h=tile_h, cap=cap,
                     chunk=chunk)
    td, tt, tm = rasterize_tiled(scene["ts"], W, H, scene["zn"], scene["zf"],
                                 depth_mode=_mode(mode), tile_h=tile_h,
                                 cap=cap, chunk=chunk)
    assert int(tm) == int(jm) <= cap
    _compare(jd, jt, td, tt)


def test_tiled_truncated_cap_matches_jax(scene, brute):
    """An explicit cap below max_bin (1024 at 32x128 tiles; max_bin is
    1,846) drops the same triangles on both sides: the port reproduces
    lsr_tpu's truncated image, which loses thousands of pixels against
    the brute raster."""
    from lsr_tpu.raster.tiled import rasterize_tiled as jrt

    from lsr_tpu_torch.raster.setup import DEPTH_VIEWZ
    from lsr_tpu_torch.raster.tiled import rasterize_tiled

    cam = scene["cam"]
    jd, jt, jm = jrt(scene["js"], W, H, cam.zn, cam.zf, cap=1024)
    td, tt, tm = rasterize_tiled(scene["ts"], W, H, scene["zn"], scene["zf"],
                                 cap=1024)
    assert int(tm) == int(jm) > 1024
    _compare(jd, jt, td, tt)
    bt = brute[DEPTH_VIEWZ][1]
    assert int((tt != bt).sum()) > 1000
    assert int((tt >= 0).sum()) < int((bt >= 0).sum())


def test_tiled_cap_not_multiple_of_chunk_matches_jax(scene):
    """A cap that is not a multiple of the chunk, on a tile that overflows
    it: both sides walk cap // chunk whole chunks (96 of 100 entries), and
    no tile is given more entries to walk than its list holds."""
    from lsr_tpu.raster.tiled import rasterize_tiled as jrt

    from lsr_tpu_torch.raster.tiled import rasterize_tiled, tiled_inputs

    _, lists, n_walk, max_bin = tiled_inputs(scene["ts"], W, H, 32, 128, 100,
                                             16)
    assert int(max_bin) > 100 and lists.shape[1] == 100
    assert int(n_walk.max()) == 96
    cam = scene["cam"]
    jd, jt, _ = jrt(scene["js"], W, H, cam.zn, cam.zf, cap=100, chunk=16)
    td, tt, _ = rasterize_tiled(scene["ts"], W, H, scene["zn"], scene["zf"],
                                cap=100, chunk=16)
    _compare(jd, jt, td, tt)


@pytest.mark.parametrize("tile_h,chunk", [(16, 8), (32, 16), (64, 16)])
def test_tiled_plain_equals_brute(scene, brute, tile_h, chunk):
    """Uncapped, the plain B3 equals rasterize_brute bit for bit (same
    arithmetic, same first-submitted rule), depth and tids."""
    from lsr_tpu_torch.raster.setup import DEPTH_VIEWZ
    from lsr_tpu_torch.raster.tiled import rasterize_tiled

    td, tt, _ = rasterize_tiled(scene["ts"], W, H, scene["zn"], scene["zf"],
                                tile_h=tile_h, cap=256, chunk=chunk,
                                fit_cap=True)
    bd, bt = brute[DEPTH_VIEWZ]
    assert torch.equal(td, bd) and torch.equal(tt, bt)


def test_tiled_depth_chaining():
    """Rasterizing cube A then cube B over the same buffers equals the
    brute raster of A chained into B (lsr_tpu's test_tiled_depth_chaining)."""
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.tiled import rasterize_tiled

    s_a, s_b = _cube_setups(128, 128)
    d1, t1, _ = rasterize_tiled(s_a, 128, 128, 0.1, 100.0, cap=256)
    d2, t2, _ = rasterize_tiled(s_b, 128, 128, 0.1, 100.0, depth_init=d1,
                                tid_init=t1, cap=256)
    ra, ta = rasterize_brute(s_a, 128, 128, 0.1, 100.0)
    rd, rt = rasterize_brute(s_b, 128, 128, 0.1, 100.0, depth_init=ra,
                             tid_init=ta)
    assert torch.equal(d2, rd) and torch.equal(t2, rt)
    assert int((t2 >= 0).sum()) > 100


# ---------------------------------------------------------------------------
# B4: chunk worklists and the chunk-list raster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_h,sub_h,ccap", [(32, 16, None), (128, 32, None),
                                               (128, 32, 16), (64, 16, 40)])
def test_chunk_lists_match_jax(scene, tile_h, sub_h, ccap):
    """Packed entries (id << 5 | band_start << 2 | band_count - 1), capped
    counts and the maximum are the same integers as lsr_tpu's, also under
    an explicit ccap that truncates."""
    from lsr_tpu.raster.tiled import _chunk_lists as jcl

    from lsr_tpu_torch.raster.tiled import _chunk_lists

    n = scene["ts"].coef.shape[0]
    n_pad = -(-n // 256) * 256
    cap = n_pad // 16 if ccap is None else ccap
    args = (n_pad, 16, 2, -(-H // tile_h), 128, tile_h, cap)
    jl, jc, jm = jcl(scene["js"], *args, jnp.float32(0.0), sub_h)
    tl, tc, tm = _chunk_lists(scene["ts"], *args, 0, sub_h)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tm) == int(jm)


@pytest.mark.parametrize("tile_h,sub_h", [(32, 16), (128, 32)])
def test_rasterize_chunklist_matches_jax(scene, brute, tile_h, sub_h):
    """rasterize_chunklist vs lsr_tpu's at sub_h 16 and 32: same
    max_chunks_per_tile, depth and tids under the module's contract; the
    port also equals rasterize_brute bit for bit."""
    from lsr_tpu.raster.tiled import rasterize_chunklist as jrc

    from lsr_tpu_torch.raster.setup import DEPTH_VIEWZ
    from lsr_tpu_torch.raster.tiled import rasterize_chunklist

    cam = scene["cam"]
    jd, jt, jm = jrc(scene["js"], W, H, cam.zn, cam.zf, tile_h=tile_h,
                     sub_h=sub_h)
    td, tt, tm = rasterize_chunklist(scene["ts"], W, H, scene["zn"],
                                     scene["zf"], tile_h=tile_h, sub_h=sub_h)
    assert int(tm) == int(jm) > 0
    _compare(jd, jt, td, tt)
    bd, bt = brute[DEPTH_VIEWZ]
    assert torch.equal(td, bd) and torch.equal(tt, bt)


def test_chunklist_depth_only_band_offset(scene, brute):
    """NDC01 depth only: the full target equals the brute depth, tids come
    back as tid_init, and a y_offset half band equals the full target's
    rows (lsr_tpu's test_chunklist_depth_only_and_band_offset); the band
    also matches lsr_tpu's band within the module's depth bound."""
    from lsr_tpu.raster.tiled import rasterize_chunklist as jrc

    from lsr_tpu_torch.raster.setup import DEPTH_NDC01
    from lsr_tpu_torch.raster.tiled import rasterize_chunklist

    ts = scene["ts"]
    d_c, t_c, _ = rasterize_chunklist(ts, W, H, 0.0, 1.0, tile_h=32,
                                      sub_h=32, depth_mode=DEPTH_NDC01,
                                      track_ids=False)
    assert torch.equal(d_c, brute[DEPTH_NDC01][0])
    assert bool((t_c == -1).all())
    band = H // 2
    d_b, t_b, _ = rasterize_chunklist(ts, W, band, 0.0, 1.0, tile_h=32,
                                      sub_h=32, depth_mode=DEPTH_NDC01,
                                      y_offset=band, full_height=H)
    assert torch.equal(d_b, d_c[band:])
    assert torch.equal(t_b, brute[DEPTH_NDC01][1][band:])
    jd, jt, _ = jrc(scene["js"], W, band, jnp.float32(0.0), jnp.float32(1.0),
                    tile_h=32, sub_h=32, depth_mode=DEPTH_NDC01,
                    y_offset=band, full_height=H)
    _compare(jd, jt, d_b, t_b)


def test_chunklist_depth_chaining():
    """Cube A then cube B through the chunk-list raster equals the brute
    raster chained the same way (lsr_tpu's test_chunklist_depth_chaining)."""
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.tiled import rasterize_chunklist

    s_a, s_b = _cube_setups(128, 128)
    d1, t1, _ = rasterize_chunklist(s_a, 128, 128, 0.1, 100.0)
    d2, t2, _ = rasterize_chunklist(s_b, 128, 128, 0.1, 100.0,
                                    depth_init=d1, tid_init=t1)
    ra, ta = rasterize_brute(s_a, 128, 128, 0.1, 100.0)
    rd, rt = rasterize_brute(s_b, 128, 128, 0.1, 100.0, depth_init=ra,
                             tid_init=ta)
    assert torch.equal(d2, rd) and torch.equal(t2, rt)
    assert int((t2 >= 0).sum()) > 100


def test_chunklist_capped_worklists_drop_like_jax(scene):
    """An explicit ccap below max_chunks_per_tile drops the same chunks on
    both sides."""
    from lsr_tpu.raster.tiled import rasterize_chunklist as jrc

    from lsr_tpu_torch.raster.tiled import rasterize_chunklist

    cam = scene["cam"]
    jd, jt, jm = jrc(scene["js"], W, H, cam.zn, cam.zf, ccap=64)
    td, tt, tm = rasterize_chunklist(scene["ts"], W, H, scene["zn"],
                                     scene["zf"], ccap=64)
    assert int(tm) == int(jm) > 64
    _compare(jd, jt, td, tt)


# ---------------------------------------------------------------------------
# B1: the caller's tile shape (repair)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_h,chunk,sort", [(16, 16, False),
                                               (64, 16, False)])
def test_rasterize_direct_tile_args_match_jax(scene, tile_h, chunk, sort):
    """rasterize_direct takes lsr_tpu's tile arguments (the pipeline raster
    passes 64x128, chunk 16): depth and tids as before, and
    max_supers_per_tile counted at the caller's tiles equals lsr_tpu's."""
    from lsr_tpu.raster.tiled import rasterize_direct as jrd

    from lsr_tpu_torch.raster.tiled import rasterize_direct

    cam = scene["cam"]
    jd, jt, jm = jrd(scene["js"], W, H, cam.zn, cam.zf, tile_h=tile_h,
                     chunk=chunk, spatial_sort=sort)
    td, tt, tm = rasterize_direct(scene["ts"], W, H, scene["zn"], scene["zf"],
                                  tile_h=tile_h, chunk=chunk,
                                  spatial_sort=sort)
    assert int(tm) == int(jm)
    _compare(jd, jt, td, tt)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def test_b3_b4_wrappers_do_not_fall_back(scene):
    """Only CPU tensors run the plain versions: another device launches the
    kernel or raises (a meta tensor raises), and B4 keeps lsr_tpu's
    two-bit band encoding check."""
    from lsr_tpu_torch.raster.setup import TriSetup
    from lsr_tpu_torch.raster.tiled import (
        rasterize_chunklist,
        rasterize_tiled,
    )

    ts = scene["ts"]
    meta = TriSetup(**{f.name: getattr(ts, f.name).to("meta")
                       for f in dataclasses.fields(TriSetup)})
    with pytest.raises(ValueError, match="unsupported device"):
        rasterize_tiled(meta, W, H, 0.1, 100.0)
    with pytest.raises(ValueError, match="unsupported device"):
        rasterize_chunklist(meta, W, H, 0.1, 100.0)
    with pytest.raises(ValueError, match="band encoding"):
        rasterize_chunklist(ts, W, H, 0.1, 100.0, tile_h=128, sub_h=16)
