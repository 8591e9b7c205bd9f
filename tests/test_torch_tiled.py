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
    tl, tc, tm, _, _ = bin_triangles(scene["ts"], W, H, tile_h, 128, cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tm) == int(jm)
    if cap < int(jm):
        assert int(tc.max()) == cap
    # fit_cap raises the cap to the rule of lsr_tpu's bench: nothing dropped.
    fl, fc, fm, _, f_over = bin_triangles(scene["ts"], W, H, tile_h, 128,
                                          cap, fit_cap=True)
    assert not bool(f_over)
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

    _, _, m, _, _ = bin_triangles(scene["ts"], W, H, tile_h, 128, 256)
    cap = fitted_cap(256, int(m))
    cam = scene["cam"]
    jd, jt, jm = jrt(scene["js"], W, H, cam.zn, cam.zf,
                     depth_mode=_mode(mode), tile_h=tile_h, cap=cap,
                     chunk=chunk)
    td, tt, tm, _, _ = rasterize_tiled(
        scene["ts"], W, H, scene["zn"], scene["zf"], depth_mode=_mode(mode),
        tile_h=tile_h, cap=cap, chunk=chunk)
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
    td, tt, tm, _, over = rasterize_tiled(scene["ts"], W, H, scene["zn"],
                                          scene["zf"], cap=1024)
    assert int(tm) == int(jm) > 1024 and bool(over)
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

    _, lists, n_walk, max_bin, _, _ = tiled_inputs(scene["ts"], W, H, 32,
                                                   128, 100, 16)
    assert int(max_bin) > 100 and lists.shape[1] == 100
    assert int(n_walk.max()) == 96
    cam = scene["cam"]
    jd, jt, _ = jrt(scene["js"], W, H, cam.zn, cam.zf, cap=100, chunk=16)
    td, tt, *_ = rasterize_tiled(scene["ts"], W, H, scene["zn"], scene["zf"],
                                 cap=100, chunk=16)
    _compare(jd, jt, td, tt)


@pytest.mark.parametrize("tile_h,chunk", [(16, 8), (32, 16), (64, 16)])
def test_tiled_plain_equals_brute(scene, brute, tile_h, chunk):
    """Uncapped, the plain B3 equals rasterize_brute bit for bit (same
    arithmetic, same first-submitted rule), depth and tids."""
    from lsr_tpu_torch.raster.setup import DEPTH_VIEWZ
    from lsr_tpu_torch.raster.tiled import rasterize_tiled

    td, tt, *_ = rasterize_tiled(scene["ts"], W, H, scene["zn"], scene["zf"],
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
    d1, t1, *_ = rasterize_tiled(s_a, 128, 128, 0.1, 100.0, cap=256)
    d2, t2, *_ = rasterize_tiled(s_b, 128, 128, 0.1, 100.0, depth_init=d1,
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


# ---------------------------------------------------------------------------
# The exact block cull of kernels B3 / B4 (plain model: cull_rejects)
# ---------------------------------------------------------------------------

def _sweep_records(kind, rng, n_rect, k):
    """(n_rect, k, 16) f32 records around the origin of each rectangle.

    Each record's edge functions come from three screen vertices near the
    rectangle (within [-12, 28) of its corner), normalised like the setup's
    (divided by the doubled area), so many triangles straddle the
    rectangle's border.  "sliver": nearly collinear vertices, coefficients
    scaled up to |coef| ~ 2.5e7; "nonfinite": a tenth of the coefficients
    replaced by +-inf / nan / +-3e38; "negzero": a fifth replaced by -0.0 or
    +0.0; "ids": ordinary triangles, a third with an invalid id lane."""
    v0 = rng.uniform(-12.0, 28.0, (n_rect, k, 2))
    d = rng.normal(0.0, 6.0, (n_rect, k, 2))
    e = rng.normal(0.0, 6.0, (n_rect, k, 2))
    if kind == "sliver":
        e = d * rng.uniform(-1.5, 1.5, (n_rect, k, 1)) \
            + rng.normal(0.0, 1.0, (n_rect, k, 2)) \
            * 10.0 ** rng.uniform(-7.0, -1.0, (n_rect, k, 1))
    v = np.stack([v0, v0 + d, v0 + e], axis=2)            # (n, k, 3, 2)
    a = np.roll(v, -1, 2)
    b = np.roll(v, -2, 2)
    A = a[..., 1] - b[..., 1]
    B = b[..., 0] - a[..., 0]
    C = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    area = (A * v[..., 0] + B * v[..., 1] + C)[..., :1]
    area = np.where(np.abs(area) < 1e-30, 1e-30, area)
    coef = np.stack([A, B, C], axis=-1) / area[..., None]  # (n, k, 3, 3)
    coef = np.clip(coef, -2.5e7, 2.5e7).reshape(n_rect, k, 9)
    rec = np.zeros((n_rect, k, 16), np.float32)
    rec[..., :9] = coef
    rec[..., 9:12] = 1.0          # 1/w: denom is the sum of the edge values
    rec[..., 12:15] = 0.5
    rec[..., 15] = np.arange(k, dtype=np.float32)
    if kind == "nonfinite":
        bad = rng.choice(np.array([np.inf, -np.inf, np.nan, 3e38, -3e38],
                                  np.float32), (n_rect, k, 9))
        rec[..., :9] = np.where(rng.random((n_rect, k, 9)) < 0.1, bad,
                                rec[..., :9])
    elif kind == "negzero":
        z = rng.choice(np.array([-0.0, 0.0], np.float32), (n_rect, k, 9))
        rec[..., :9] = np.where(rng.random((n_rect, k, 9)) < 0.2, z,
                                rec[..., :9])
    elif kind == "ids":
        rec[..., 15] = np.where(rng.random((n_rect, k)) < 1 / 3, -1.0,
                                rec[..., 15])
    return torch.from_numpy(rec)


def _sweep_rects(rng, n_rect, w, h):
    """n_rect pixel rectangles (w x h) at random origins and y offsets, as
    a frame-like object (px (T,1,1,w), py (T,1,h,1)) and their bounds."""
    import types

    x0 = torch.from_numpy(rng.integers(0, 4096, n_rect))
    y0 = torch.from_numpy(rng.integers(0, 2048, n_rect)
                          + rng.choice([0, 540, 8192], n_rect))
    px = (x0[:, None] + torch.arange(w)).to(torch.float32) + 0.5
    py = (y0[:, None] + torch.arange(h)).to(torch.float32) + 0.5
    fr = types.SimpleNamespace(px=px[:, None, None, :], py=py[:, None, :, None])
    bounds = (px[:, :1], px[:, -1:], py[:, :1], py[:, -1:])   # each (T, 1)
    return fr, bounds, x0, y0


def _cull_violations(kind, seed, w, h, n_rect=96, k=192):
    """Run the cull model and _tri_depth on a sweep.  Returns (pairs that
    were rejected although a pixel of the rectangle is covered, rejected
    pairs, kept pairs with a covered pixel, all pairs)."""
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.setup import DEPTH_VIEWZ

    rng = np.random.default_rng(seed)
    fr, bounds, x0, y0 = _sweep_rects(rng, n_rect, w, h)
    rec = _sweep_records(kind, rng, n_rect, k)
    # Move each record's triangle to its rectangle: C -= A*x0 + B*y0.
    shift = (rec[..., 0:9:3] * x0[:, None, None]
             + rec[..., 1:9:3] * y0[:, None, None])
    rec[..., 2:9:3] = (rec[..., 2:9:3] - shift).to(torch.float32)
    rej = tiled.cull_rejects(rec, *bounds)                       # (T, K)
    inside, _ = tiled._tri_depth(rec, fr, 0.1, 0.01, DEPTH_VIEWZ)
    # The coverage test alone (tri_depth's first exit), same op order.
    cov = torch.ones_like(inside)
    for e in (0, 3, 6):
        bc = (rec[..., e, None, None] * fr.px + rec[..., e + 1, None, None]
              * fr.py + rec[..., e + 2, None, None])
        cov &= bc >= 0.0
    cov &= (rec[..., 15] >= 0.0)[..., None, None]
    assert not bool((inside & ~cov).any())
    covered = cov.flatten(2).any(-1)
    return (int((rej & covered).sum()), int(rej.sum()),
            int((~rej & covered).sum()), rej.numel())


@pytest.mark.parametrize("kind,w,h", [
    ("sliver", 16, 16), ("sliver", 8, 4), ("nonfinite", 16, 16),
    ("nonfinite", 8, 4), ("negzero", 16, 16), ("ids", 16, 16),
    ("ids", 4, 8)])
def test_cull_rejects_no_covered_pair(kind, w, h):
    """Seeded sweep: no (record, rectangle) pair that cull_rejects drops
    has a pixel center that passes _tri_depth's coverage test, for slivers
    with |coef| up to 2.5e7, non-finite coefficients, signed zeros and
    invalid ids, on 16x16 block and 8x4 / 4x8 warp rectangles at origins up
    to 4096 x 10240 (y_offset bands).  The sweep rejects and covers enough
    pairs to mean something."""
    bad = n_rej = n_cov = n_all = 0
    for seed in range(3):
        b, r, c, a = _cull_violations(kind, seed, w, h)
        bad, n_rej, n_cov, n_all = bad + b, n_rej + r, n_cov + c, n_all + a
    assert bad == 0, (bad, n_rej)
    assert n_rej > 0.2 * n_all and n_cov > 0.01 * n_all, (n_rej, n_cov, n_all)


@pytest.mark.parametrize("kind", ["sliver", "ids"])
def test_cull_sweep_catches_a_wrong_corner(kind, monkeypatch):
    """The test of the test: with the corner choice inverted (the smallest
    corner instead of the largest) the same sweep finds rejected pairs that
    are covered."""
    from lsr_tpu_torch.raster import tiled

    def wrong(a, b, c, x0, x1, y0, y1):
        return (a * torch.where(a >= 0.0, x0, x1)
                + b * torch.where(b >= 0.0, y0, y1) + c)

    monkeypatch.setattr(tiled, "_edge_max", wrong)
    bad, _, _, _ = _cull_violations(kind, 0, 16, 16)
    assert bad > 0


def test_cull_keeps_nan_corners_and_negative_zero():
    """A corner that is NaN (inf - inf, nan coefficients) never rejects;
    an edge value of -0.0 passes '>= 0' at every pixel and is kept; -inf at
    the largest corner and an invalid id reject."""
    from lsr_tpu_torch.raster.tiled import cull_rejects

    inf, nan = float("inf"), float("nan")
    ok = [1.0, 0.0, 0.0]                       # bc = px > 0 everywhere
    rows = {
        "inf-inf": [inf, -inf, 0.0] + ok + ok,
        "nan": ok + [nan, 1.0, 1.0] + ok,
        "inf+c=-inf": ok + ok + [inf, 0.0, -inf],
        "-0": [-0.0, -0.0, -0.0] + ok + ok,
        "tiny negative at the far corner only": [-1.0, 0.0, 31.5] + ok + ok,
        "-inf": ok + [-inf, 0.0, 0.0] + ok,
        "negative everywhere": ok + ok + [-1.0, -1.0, 10.0],
        "invalid id": ok + ok + ok,
    }
    rec = torch.zeros((len(rows), 16))
    rec[:, :9] = torch.tensor(list(rows.values()))
    rec[-1, 15] = -1.0
    x0, x1, y0, y1 = (torch.tensor(v) for v in (16.5, 31.5, 32.5, 47.5))
    got = cull_rejects(rec, x0, x1, y0, y1).tolist()
    assert dict(zip(rows, got)) == {
        "inf-inf": False, "nan": False, "inf+c=-inf": False, "-0": False,
        "tiny negative at the far corner only": False, "-inf": True,
        "negative everywhere": True, "invalid id": True}


@pytest.mark.parametrize("tile_h,y_offset", [(32, 0), (64, 48), (16, 31)])
def test_block_cull_on_ragged_frames(scene, tile_h, y_offset):
    """On the frames the kernels see (160x96: a ragged last tile column,
    blocks past the right and bottom edges, y_offset bands whose rows cross
    the NDC bound), no pixel that passes _tri_depth inside its NDC bounds
    belongs to a (record, 16x16 block) or (record, 8x4 warp rectangle) pair
    the cull rejects; and the cull rejects most of the scene's pairs."""
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.setup import DEPTH_VIEWZ

    rec, _, _ = tiled.pack_direct_records(scene["ts"], False)
    fr = tiled._TileFrame(W, H - y_offset, 128, tile_h, y_offset, H,
                          torch.device("cpu"))
    rows = torch.nonzero(rec[:, 15] >= 0)[:, 0]
    blk = rec[rows][None].expand(fr.tx * fr.ty, -1, -1)
    keep_all, lost = 0, 0
    for s in range(0, blk.shape[1], 256):
        part = blk[:, s:s + 256]
        inside, _ = tiled._tri_depth(part, fr, 0.1, 0.01, DEPTH_VIEWZ)
        inside &= fr.ndc_ok[:, None]
        keep = tiled._walk_keep(part, fr)
        lost += int((inside & ~keep).sum())
        keep_all += int(keep.sum())
    assert lost == 0
    assert keep_all < 0.25 * blk.shape[0] * blk.shape[1] * tile_h * 128


@pytest.mark.parametrize("kernel,tile_h,chunk,mode,y_offset", [
    ("b3", 32, 8, "viewz", 0), ("b3", 64, 16, "ndc01", 0),
    ("b3", 32, 16, "viewz", 48), ("b4", 128, 16, "viewz", 0),
    ("b4", 32, 16, "ndc01", 48), ("b4", 64, 8, "viewz", 0),
    ("b4", 32, 8, "viewz", 16)])
def test_plain_rasters_unchanged_by_block_cull(scene, kernel, tile_h, chunk,
                                               mode, y_offset):
    """rasterize_tiled_plain / rasterize_chunklist_plain with the rejected
    (record, block) and (record, warp rectangle) pairs masked out, and for
    B4 the entries whose bands miss the block's or the warp's rows, equal
    the unmasked versions bit for bit on the grid-2 scene, whose pole
    slivers cover pixels outside their bboxes: neither cull level nor the
    band tests drop anything the kernels' results need."""
    from lsr_tpu_torch.raster import tiled

    ts, zn, zf = scene["ts"], scene["zn"], scene["zf"]
    hb = H - y_offset
    d0, t0 = tiled._targets(None, None, hb, W, torch.device("cpu"))
    if kernel == "b3":
        rec, lists, n_walk, *_ = tiled.tiled_inputs(
            ts, W, hb, tile_h, 128, 256, chunk, y_offset, fit_cap=True)

        def run(cull):
            return tiled.rasterize_tiled_plain(
                rec, lists, n_walk, d0, t0, W, hb, zn, zf, _mode(mode),
                tile_h, 128, chunk, y_offset, H, block_cull=cull)
    else:
        # 32x128 tiles with chunk 8: bands of 8 rows, two to a block.
        sub_h = {128: 32, 64: 16, 32: 8 if chunk == 8 else 16}[tile_h]
        rec, cl, cc, _ = tiled.chunklist_inputs(ts, W, hb, tile_h, 128, chunk,
                                                None, sub_h, y_offset)

        def run(cull):
            return tiled.rasterize_chunklist_plain(
                rec, cl, cc, d0, t0, W, hb, zn, zf, _mode(mode), tile_h, 128,
                chunk, sub_h, y_offset, H, block_cull=cull)

    (d_a, t_a), (d_b, t_b) = run(False), run(True)
    assert torch.equal(d_a, d_b) and torch.equal(t_a, t_b)
    assert int((t_a >= 0).sum()) > 1000


def test_tile_order_longest_first():
    """The kernels' block order: tiles by falling count, ties in tile order
    (a permutation, so every tile is still rasterized once)."""
    from lsr_tpu_torch.raster.tiled import tile_order

    counts = torch.tensor([3, 0, 7, 3, 7, 1], dtype=torch.int32)
    assert tile_order(counts).tolist() == [2, 4, 0, 3, 5, 1]


@pytest.mark.parametrize("tile_h,sub_h", [(128, 32), (64, 16), (32, 8),
                                          (64, 32), (16, 16)])
def test_band_hit_of_rectangles_is_exact(tile_h, sub_h):
    """The band test kernel B4 applies to a block's and a warp's rows
    (band_hit in csrc/block_walk.cuh, _rect_keep here): for every packed
    band range, a 16-row block or a 4-row warp rectangle meets the bands
    exactly when one of its rows lies in them, so no row the per-pixel test
    would accept is skipped, and no rectangle is walked for nothing."""
    import types

    from lsr_tpu_torch.raster import tiled

    nb = tile_h // sub_h
    packed = [(bs << 2) | (cnt - 1) for bs in range(nb)
              for cnt in range(1, nb - bs + 1)]
    bands = torch.tensor(packed)[None]                          # (1, K)
    rec = torch.zeros((1, len(packed), 16))
    rec[..., 0:9:3] = 1.0            # every edge value is px > 0: all kept
    fr = types.SimpleNamespace(
        th=tile_h, tw=16,
        px=(torch.arange(16.0) + 0.5)[None, None, None, :],
        py=(torch.arange(float(tile_h)) + 0.5)[None, None, :, None])
    band_of_row = torch.arange(tile_h) // sub_h
    bs = (bands[0] >> 2) & 3
    row_ok = ((band_of_row >= bs[:, None])
              & (band_of_row <= (bs + (bands[0] & 3))[:, None]))  # (K, th)
    assert bool(row_ok.any(1).all()) and (nb == 1 or not bool(row_ok.all()))
    for bw, bh in ((16, 16), tiled._KERNEL_WARP):
        got = tiled._rect_keep(rec, fr, bw, bh, bands, sub_h)[0, ..., 0]
        want = row_ok.view(len(packed), tile_h // bh, bh).any(-1)
        assert torch.equal(got, want), (bw, bh)


@pytest.mark.parametrize("kernel,tile_h,y_offset", [
    ("b3", 64, 0), ("b3", 32, 48), ("b4", 128, 0), ("b4", 64, 48)])
def test_walk_survivors_counts_the_mask(scene, kernel, tile_h, y_offset):
    """walk_survivors (the counts chip_smoke.py reports) equals a direct
    count of the plain versions' mask on the kernels' own lists: per warp
    rectangle the pairs of _walk_keep over live entries, per block the
    first cull level alone; and the warp level keeps no more than the block
    level, which keeps no more than the list."""
    from lsr_tpu_torch.raster import tiled

    ts, hb = scene["ts"], H - y_offset
    if kernel == "b3":
        rec, lists, n, *_ = tiled.tiled_inputs(ts, W, hb, tile_h, 128, 256,
                                               16, y_offset, fit_cap=True)
        chunk = sub_h = None
    else:
        chunk, sub_h = 16, tile_h // 4
        rec, lists, n, _ = tiled.chunklist_inputs(ts, W, hb, tile_h, 128,
                                                  chunk, None, sub_h, y_offset)
    per_block, per_warp = tiled.walk_survivors(
        rec, lists, n, W, hb, tile_h, 128, chunk, sub_h, y_offset, H)
    fr = tiled._TileFrame(W, hb, 128, tile_h, y_offset, H, torch.device("cpu"))
    e = lists[:, :int(n.max())].to(torch.int64)
    live = torch.arange(e.shape[1])[None] < n[:, None]
    if chunk is None:
        rows, bands = torch.clamp(e, min=0), None
    else:
        rows, bands = tiled._chunk_triangles(e, chunk)
        live = live[..., None].expand(-1, -1, chunk).flatten(1)
    keep = tiled._walk_keep(rec[rows], fr, bands, sub_h) \
        & live[..., None, None]
    ww, wh = tiled._KERNEL_WARP
    want = keep.sum(1).view(-1, tile_h // wh, wh, 128 // ww, ww)
    assert torch.equal(want[:, :, 0, :, 0], per_warp)
    assert bool((want == want[:, :, :1, :, :1]).all())
    kb = tiled._rect_keep(rec[rows], fr, 16, 16, bands, sub_h) \
        & live[..., None, None]
    assert torch.equal(kb.sum(1), per_block)
    wb = per_warp.view(-1, tile_h // 16, 16 // wh, 128 // 16, 16 // ww)
    assert bool((wb <= per_block[:, :, None, :, None]).all())
    per_tile = n.to(torch.int64) * (chunk or 1)
    assert bool((per_block <= per_tile[:, None, None]).all())
    assert 0 < int(per_warp.sum()) < int(per_block.sum()) * 8


def test_listed_rows_counts_distinct_rows():
    """listed_rows: the distinct setup rows a walk reads, entries past a
    tile's count left out; a chunk-list entry names `chunk` rows whatever
    its band bits."""
    from lsr_tpu_torch.raster.tiled import listed_rows

    lists = torch.tensor([[4, 7, 9, 0], [7, 4, 0, 0], [0, 0, 0, 0]],
                         dtype=torch.int32)
    counts = torch.tensor([3, 2, 0], dtype=torch.int32)
    assert listed_rows(lists, counts) == 3
    cl = torch.tensor([[(2 << 5) | 0b0101, (3 << 5) | 3],
                       [(2 << 5) | 0b1000, 0]], dtype=torch.int32)
    assert listed_rows(cl, torch.tensor([2, 1], dtype=torch.int32), 16) == 32


# ---------------------------------------------------------------------------
# B1 on the shared walk: its plain model, tie rule and counts
# ---------------------------------------------------------------------------

def _direct_inputs(ts, sort, w=W, h=H):
    from lsr_tpu_torch.raster import tiled

    rec, ss, n_pad = tiled.pack_direct_records(ts, sort)
    cbb = tiled._chunk_bboxes(ss, n_pad, 16)
    sl, cnt, _ = tiled._super_lists(cbb, 16, -(-w // 128), -(-h // 128), 128,
                                    128)
    return rec, cbb, sl, cnt


@pytest.mark.parametrize("sort,mode,track", [
    (True, "viewz", True), (False, "ndc01", True), (True, "viewz", False)])
def test_direct_plain_walk_unchanged_by_block_cull(scene, brute, sort, mode,
                                                   track):
    """The plain model of kernel B1's walk (a triangle is evaluated only
    where its chunk's bbox meets the pixel's 16x16 block), with the pairs
    masked out that the cull against the block and the warp's 8x4 rectangle
    rejects, equals the unmasked walk bit for bit, sorted (ties by id) and
    unsorted (ties by row), view-z and NDC01, ids and depth only.  On this
    scene the walk also equals rasterize_brute: no winner lies outside its
    chunk's bbox."""
    from lsr_tpu_torch.raster import tiled

    rec, cbb, sl, cnt = _direct_inputs(scene["ts"], sort)
    d0, t0 = tiled._targets(None, None, H, W, torch.device("cpu"))

    def run(cull):
        return tiled.rasterize_direct_plain(
            rec, cbb, sl, cnt, d0, t0, W, H, scene["zn"], scene["zf"],
            _mode(mode), track, sort, block_cull=cull)

    (d_a, t_a), (d_b, t_b) = run(False), run(True)
    assert torch.equal(d_a, d_b) and torch.equal(t_a, t_b)
    d_r, t_r = brute[_mode(mode)]
    assert torch.equal(d_a, d_r)
    assert torch.equal(t_a, t_r if track else t0)
    assert int((d_a < 1.0).sum()) > 1000


@pytest.mark.parametrize("tie_tid", [False, True])
def test_direct_plain_walk_on_the_sliver_sweep(tie_tid):
    """The same on the seeded sliver sweep (|coef| up to 2.5e7, triangles
    that straddle block and warp borders and cover pixels far from their
    vertices): 768 records over one 128x96 tile, every chunk's bbox the
    whole frame, so only the per-triangle cull decides what a pixel
    evaluates.  Ids are shuffled so that the tie rules differ."""
    from lsr_tpu_torch.raster import tiled

    w, h, k = 128, 96, 192
    rng = np.random.default_rng(5)
    rec = _sweep_records("sliver", rng, 4, k)
    x0 = torch.tensor([8.0, 72.0, 24.0, 90.0])[:, None, None]
    y0 = torch.tensor([10.0, 20.0, 60.0, 70.0])[:, None, None]
    shift = rec[..., 0:9:3] * x0 + rec[..., 1:9:3] * y0
    rec[..., 2:9:3] = (rec[..., 2:9:3] - shift).to(torch.float32)
    rec = rec.reshape(-1, 16).contiguous()
    rec[:, 15] = torch.from_numpy(rng.permutation(4 * k).astype(np.float32))
    cbb = torch.tensor([0.0, 0.0, w - 1.0, h - 1.0]).repeat(4 * k // 16, 1)
    sl = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    cnt = torch.tensor([3], dtype=torch.int32)
    d0, t0 = tiled._targets(None, None, h, w, torch.device("cpu"))

    def run(cull):
        return tiled.rasterize_direct_plain(rec, cbb, sl, cnt, d0, t0, w, h,
                                            0.1, 100.0, tie_tid=tie_tid,
                                            block_cull=cull)

    (d_a, t_a), (d_b, t_b) = run(False), run(True)
    assert torch.equal(d_a, d_b) and torch.equal(t_a, t_b)
    assert int((t_a >= 0).sum()) > 500
    assert len(torch.unique(t_a)) > 50


def test_resolve_tie_rules():
    """_resolve: the first of equal depths wins inside a group and a tie
    with the target loses; with tie_tid the smaller id wins both."""
    from lsr_tpu_torch.raster.tiled import _resolve

    z = torch.tensor([0.5, 0.5, 0.25, 0.5]).view(1, 4, 1, 1).expand(1, 4, 1, 3)
    inside = torch.tensor([[1, 1, 0], [1, 1, 1], [0, 0, 1], [0, 1, 1]],
                          dtype=torch.bool).T.reshape(1, 3, 4).permute(
                              0, 2, 1)[:, :, None, :]
    ids = torch.tensor([[7.0, 3.0, 9.0, 1.0]])
    d = torch.tensor([[[1.0, 0.5, 0.25]]])
    t = torch.tensor([[[-1, 2, 4]]], dtype=torch.int32)
    d1, t1 = _resolve(inside, z, ids, d, t, True)
    assert d1.flatten().tolist() == [0.5, 0.5, 0.25]
    assert t1.flatten().tolist() == [7, 2, 4]
    d2, t2 = _resolve(inside, z, ids, d, t, True, tie_tid=True)
    assert d2.flatten().tolist() == [0.5, 0.5, 0.25]
    assert t2.flatten().tolist() == [3, 1, 4]
    d3, t3 = _resolve(inside, z, ids, d, t, False, tie_tid=True)
    assert d3.flatten().tolist() == [0.5, 0.5, 0.25]
    assert t3.flatten().tolist() == [-1, 2, 4]


@pytest.mark.parametrize("sort", [False, True])
def test_walk_survivors_counts_the_direct_walk(scene, sort):
    """walk_survivors on B1's source (the triangles of the listed supers'
    chunks whose bbox meets the block) equals a direct count of the plain
    walk's mask, and direct_chunk_hits a direct count of the chunk test."""
    from lsr_tpu_torch.raster import tiled

    rec, cbb, sl, cnt = _direct_inputs(scene["ts"], sort)
    per_block, per_warp = tiled.walk_survivors(rec, sl, cnt, W, H, 128, 128,
                                               chunk_bb=cbb)
    hits = tiled.direct_chunk_hits(cbb, sl, cnt, W, H)
    fr = tiled._TileFrame(W, H, 128, 128, 0, H, torch.device("cpu"))
    want_b = torch.zeros_like(per_block)
    want_w = torch.zeros_like(per_warp)
    want_h = torch.zeros_like(hits)
    ww, wh = tiled._KERNEL_WARP
    for t in range(sl.shape[0]):
        for s in sl[t, :int(cnt[t])].tolist():
            for c in range(s * 16, s * 16 + 16):
                x0, y0, x1, y1 = cbb[c].tolist()
                bx = torch.arange(8) * 16 + (t % fr.tx) * 128
                by = torch.arange(8) * 16 + (t // fr.tx) * 128
                hit = ((x0 <= bx + 15) & (x1 >= bx))[None, :] \
                    & ((y0 <= by + 15) & (y1 >= by))[:, None]      # (8, 8)
                want_h[t] += hit
                if not bool(hit.any()):
                    continue
                blk = rec[c * 16:c * 16 + 16][None]
                one = types_frame(fr, t)
                kb = tiled._rect_keep(blk, one, 16, 16)[0] & hit[None]
                kw = tiled._rect_keep(blk, one, ww, wh)[0] \
                    & kb.repeat_interleave(16 // wh, 1).repeat_interleave(
                        16 // ww, 2)
                want_b[t] += kb.sum(0)
                want_w[t] += kw.sum(0)
    assert torch.equal(want_h, hits)
    assert torch.equal(want_b, per_block) and torch.equal(want_w, per_warp)
    assert 0 < int(per_warp.sum()) * 32 < int(per_block.sum()) * 256 \
        < int(hits.sum()) * 16 * 256


def types_frame(fr, t):
    """Tile t of a _TileFrame as a one-tile frame."""
    import types

    return types.SimpleNamespace(th=fr.th, tw=fr.tw, px=fr.px[t:t + 1],
                                 py=fr.py[t:t + 1])
