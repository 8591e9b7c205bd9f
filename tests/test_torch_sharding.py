"""lsr_tpu_torch's multi-device paths (parallel/) and kernel B1's screen-band
branch (B1b) vs lsr_tpu and vs their own unsharded frames (CPU).

The ranks are virtual: every mesh here is [torch.device("cpu")] * n, as
lsr_tpu's tests run theirs on XLA's forced host devices.  The JAX side runs
as lsr_tpu's own CPU tests do: rasterize_direct in Pallas interpret mode,
make_sharded_flagship and make_light_sharded_forward jitted on a (1, 1)
mesh.  Scenes are procedural (lsr_tpu's tests/test_sharding.py and the
grid-2 flagship stand-in); lights come from numpy seeds.

Tolerances, in ROADMAP C1's terms: the port's own sharded frames equal its
unsharded ones bit for bit (dp, sp, pp; lp up to the order of the light
sum: at most 1 LSB on under 2% of pixels, lsr_tpu's own bound).  Against
lsr_tpu, XLA:CPU's multiply-add contraction moves depth by up to 2e-5 and
flips edge tids (>= 99.5% equal) and LDR by 1 LSB (>= 99.9% of pixels
within 1 LSB), as in the port's other parity tests.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu.core import math3d as jm3
from lsr_tpu.io.obj import make_cube as jmake_cube
from lsr_tpu.io.obj import make_plane as jmake_plane
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu_torch import convert
from lsr_tpu_torch.parallel import collectives
from lsr_tpu_torch.parallel import sharding as tsh

CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


def _t(a):
    return torch.as_tensor(np.array(a))


def _to_torch(geom, objects, ctx, lights=None):
    """lsr_tpu scene state -> the port's dataclasses on the CPU."""
    mats = convert.materials_soa(ctx.materials, "cpu")
    out = (convert.geometry(geom, "cpu"), convert.objects_soa(objects, "cpu"),
           convert.shade_context(ctx, mats, "cpu"))
    return out + ((convert.lights_soa(lights, "cpu"),) if lights else ())


def _ldr_close(a, b, share=0.999):
    """LDR within 1 LSB on >= share of pixels (C1's LDR bound)."""
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max(-1)
    ok = float((d <= 1).mean())
    assert ok >= share, (ok, int(d.max()))
    return ok


def _lp_close(out, ref):
    """lsr_tpu's bound for a light-sharded frame: the order of the light
    sum moves a pixel by at most 1 LSB, on under 2% of pixels."""
    d = np.abs(np.asarray(out).astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 1, int(d.max())
    assert (d != 0).mean() < 0.02, float((d != 0).mean())


# ---------------------------------------------------------------------------
# Scenes (lsr_tpu's tests/test_sharding.py)
# ---------------------------------------------------------------------------

def _tiny_scene():
    b = SceneBuilder()
    b.add(jmake_cube(1.2), np.asarray(jm3.rotate_y(0.5) @ jm3.rotate_x(0.3)))
    geom, objects = b.build()
    mats = make_materials(base_color=[(0.8, 0.5, 0.3)])
    ctx = make_shade_context(mats, light_dir_ws=(0.4, -0.7, 0.5),
                             camera_pos=(0, 0.5, -3.0), light_intensity=2.0)
    return geom, objects, ctx


def _lit_scene(seed, n_points, rng_hi, light_range):
    """The cube over a plane with seeded point lights."""
    b = SceneBuilder()
    b.add(jmake_cube(1.1),
          np.asarray(jm3.translate([0, 0.3, 0]) @ jm3.rotate_y(0.4)))
    b.add(jmake_plane(5.0, y=-1.0), material=0, casts_shadow=False)
    geom, objects = b.build()
    mats = make_materials(base_color=[(0.8, 0.5, 0.3)])
    ctx = make_shade_context(mats, light_dir_ws=(0.35, -0.7, 0.5),
                             camera_pos=(0.5, 1.8, -3.5), light_intensity=2.0)
    lb = LightSetBuilder()
    rng = np.random.default_rng(seed)
    for _ in range(n_points):
        lb.point(tuple(rng.uniform([-2, 0.2, -2], [2, rng_hi, 2]).tolist()),
                 intensity=1.5, range=light_range)
    return geom, objects, ctx, lb.build()


@pytest.fixture(scope="module")
def tiny():
    geom, objects, ctx = _tiny_scene()
    return dict(j=(geom, objects, ctx), t=_to_torch(geom, objects, ctx))


@pytest.fixture(scope="module")
def flag():
    geom, objects, ctx, lights = _lit_scene(2, 8, 1.5, 2.0)
    return dict(j=(geom, objects, ctx, lights),
                t=_to_torch(geom, objects, ctx, lights),
                sun=jnp.asarray([0.35, -0.7, 0.5], jnp.float32))


def _cams(n, w, h, radius, y, a1):
    cams = [make_camera(w, h, (np.sin(a) * -radius, y, np.cos(a) * -radius),
                        (0, 0, 0)) for a in np.linspace(0.0, a1, n)]
    return cams, [convert.camera_state(c, "cpu") for c in cams]


# ---------------------------------------------------------------------------
# make_cube and the OBJ parser
# ---------------------------------------------------------------------------

_OBJ = """# a quad and a triangle sharing corners, some with uv and normal
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 2 0.25
vt 0 0
vt 1 0
vt 1 1
vn 0 0 -1
f 1/1/1 2/2/1 3/3/1 4
f -2 -3 5/3
"""


@pytest.mark.parametrize("size", [1.0, 1.2])
def test_make_cube_matches_jax(size):
    """The cube of both packages: every array equal bit for bit."""
    from lsr_tpu_torch.io.obj import make_cube

    t, j = make_cube(size), jmake_cube(size)
    for f in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)


def test_load_obj_text_matches_jax():
    """load_obj(from_text=True) of both packages on the same OBJ text (a
    fan-triangulated quad, negative indices, corners with and without uv
    and normal): every array equal bit for bit."""
    from lsr_tpu.io.obj import load_obj as jload

    from lsr_tpu_torch.io.obj import load_obj

    t, j = load_obj(_OBJ, from_text=True), jload(_OBJ, from_text=True)
    assert t.num_triangles == 3
    for f in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# B1b: rasterize_direct(y_offset, full_height)
# ---------------------------------------------------------------------------

BW, BH, BAND = 128, 64, 16
TW, TH = 64, 384          # a tall frame: bands across 128-row list tiles


@pytest.fixture(scope="module")
def band_scene():
    """The port's setup of the grid-2 flagship scene seen from above two of
    its spheres (every row covered), and the same TriSetup as lsr_tpu
    arrays: both packages rasterize the very same rows.  "tall": the scene
    in a 64x384 frame (wide vertical field of view), whose bands cross the
    rasterizer's 128-row list tiles."""
    from lsr_tpu.raster.setup import TriSetup as JTriSetup

    from lsr_tpu_torch.frame import build_flagship_scene
    from lsr_tpu_torch.raster.setup import scene_setup
    from lsr_tpu_torch.scene.scene import make_camera as tmake_camera

    geom, objects, _, _ = build_flagship_scene(n_lights=16, grid=2,
                                               device="cpu")
    tcam = tmake_camera(BW, BH, (-1.2, 3.5, -4.5), (-1.2, -0.5, -1.0),
                        device="cpu")
    ts = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                     geom.vtx_obj, geom.tri_obj, objects.model,
                     objects.normal_mat, tcam.viewproj, BW, BH,
                     obj_visible=objects.visible)

    def j(x):
        x = x.numpy()
        return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)

    js = JTriSetup(**{f: j(getattr(ts, f)) for f in (
        "coef", "iw", "ziw", "bbox", "valid", "obj_id", "wp", "nw", "uv")})
    tall_cam = tmake_camera(TW, TH, (-1.2, 1.5, -4.5), (-1.2, 0.0, -1.2),
                            fov=2.6, device="cpu")
    tall = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                       geom.vtx_obj, geom.tri_obj, objects.model,
                       objects.normal_mat, tall_cam.viewproj, TW, TH,
                       obj_visible=objects.visible)
    return dict(js=js, ts=ts, tcam=tcam, tall=(tall, tall_cam))


def _walk_model(ts, w, h, y0, rows, zn, zf, sort, cull):
    """Kernel B1's walk (rasterize_direct_plain) on the band's own lists:
    rows [y0, y0 + rows) of a w x h frame."""
    from lsr_tpu_torch.raster import tiled

    rec, ss, n_pad = tiled.pack_direct_records(ts, sort)
    cbb = tiled._chunk_bboxes(ss, n_pad, 16)
    sl, cnt, _ = tiled._super_lists(cbb, 16, -(-w // 128), -(-rows // 128),
                                    128, 128, y0)
    d0, t0 = tiled._targets(None, None, rows, w, CPU)
    return tiled.rasterize_direct_plain(
        rec, cbb, sl, cnt, d0, t0, w, rows, zn, zf, tie_tid=sort,
        block_cull=cull, y_offset=y0, full_height=h)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("y0", [0, 16, 37, BH - BAND])
def test_direct_bands_equal_the_full_frame(band_scene, y0, track, sort):
    """B1b's plain version: the band of BAND rows at y0, and the frame split
    at y0 into two bands, equal the full frame's raster bit for bit (depth
    and tid)."""
    from lsr_tpu_torch.raster.tiled import rasterize_direct

    ts, tcam = band_scene["ts"], band_scene["tcam"]
    kw = dict(track_ids=track, spatial_sort=sort)
    fd, ft, _ = rasterize_direct(ts, BW, BH, tcam.zn, tcam.zf, **kw)
    assert int((ft >= 0).sum() if track else (fd < 1).sum()) > 500
    bd, bt, _ = rasterize_direct(ts, BW, BAND, tcam.zn, tcam.zf,
                                 y_offset=y0, full_height=BH, **kw)
    assert torch.equal(bd, fd[y0:y0 + BAND]) and torch.equal(
        bt, ft[y0:y0 + BAND])
    parts = [rasterize_direct(ts, BW, hi - lo, tcam.zn, tcam.zf, y_offset=lo,
                              full_height=BH, **kw)
             for lo, hi in ((0, y0), (y0, BH)) if hi > lo]
    assert torch.equal(torch.cat([p[0] for p in parts]), fd)
    assert torch.equal(torch.cat([p[1] for p in parts]), ft)


@pytest.mark.parametrize("frame,y0,rows,sort,cull", [
    ("wide", 37, BAND, False, False), ("wide", 37, BAND, True, True),
    ("wide", 16, BAND, False, True),
    ("tall", 100, 140, False, True), ("tall", 100, 140, True, False)])
def test_direct_band_walk_model(band_scene, frame, y0, rows, sort, cull):
    """The walk of kernel B1 on a band (rasterize_direct_plain: the band's
    own super lists, built less y0, the chunk boxes tested at global rows,
    with and without the block cull) gives the plain band bit for bit.
    y0 = 37 and 100 put the 16x16 blocks off the whole frame's grid; the
    tall frame's band of 140 rows spans two of its own 128-row list tiles,
    each listing the supers of other global rows than the frame's tiles."""
    from lsr_tpu_torch.raster.tiled import rasterize_direct

    ts, tcam = ((band_scene["ts"], band_scene["tcam"]) if frame == "wide"
                else band_scene["tall"])
    w, h = (BW, BH) if frame == "wide" else (TW, TH)
    bd, bt, _ = rasterize_direct(ts, w, rows, tcam.zn, tcam.zf, y_offset=y0,
                                 full_height=h, spatial_sort=sort)
    md, mt = _walk_model(ts, w, h, y0, rows, tcam.zn, tcam.zf, sort, cull)
    assert int((bt >= 0).sum()) > 200 and torch.unique(bt).numel() > 10
    assert torch.equal(md, bd) and torch.equal(mt, bt)


def test_direct_bands_match_jax(band_scene):
    """lsr_tpu's rasterize_direct(y_offset, full_height) in interpret mode
    and the port's, at 128x64 in two bands of 32 rows: depth01 within 2e-5,
    tids equal on >= 99.5% of covered pixels, max supers per tile equal."""
    from lsr_tpu.raster.tiled import rasterize_direct as jrd

    from lsr_tpu_torch.raster.tiled import rasterize_direct as trd

    tcam = band_scene["tcam"]
    for y0 in (0, BH // 2):
        jd, jt, jm = jrd(band_scene["js"], BW, BH // 2, float(tcam.zn),
                         float(tcam.zf), y_offset=y0, full_height=BH,
                         interpret=True)
        td, tt, tm = trd(band_scene["ts"], BW, BH // 2, tcam.zn, tcam.zf,
                         y_offset=y0, full_height=BH)
        jd, jt = np.asarray(jd), np.asarray(jt)
        assert int(jm) == int(tm)
        covered = max(int((jt >= 0).sum()), 1)
        same = jt == tt.numpy()
        assert covered > 300 and (~same).sum() <= 0.005 * covered
        assert np.abs(jd - td.numpy())[same].max() <= 2e-5


def test_direct_band_h_with_y_offset_raises(band_scene):
    """band_h (a slot stack) and a screen band do not combine; a band past
    the frame's last row is refused."""
    from lsr_tpu_torch.raster.tiled import rasterize_direct

    ts, tcam = band_scene["ts"], band_scene["tcam"]
    with pytest.raises(ValueError, match="band_h"):
        rasterize_direct(ts, BW, 32, tcam.zn, tcam.zf, band_h=16,
                         y_offset=16, full_height=BH)
    with pytest.raises(ValueError, match="outside"):
        rasterize_direct(ts, BW, 32, tcam.zn, tcam.zf, y_offset=48,
                         full_height=BH)


def test_interpolate_gbuffer_band_matches_jax(band_scene):
    """interpolate_gbuffer(y_offset) of both packages on lsr_tpu's band
    raster: attributes within 2e-5 (the interp parity test's bound), ids,
    coverage and depth exact; and the port's band equals the rows of its
    full-frame G-buffer bit for bit."""
    from lsr_tpu.raster.interp import interpolate_gbuffer as jinterp
    from lsr_tpu.raster.tiled import rasterize_direct as jrd

    from lsr_tpu_torch.raster.interp import interpolate_gbuffer
    from lsr_tpu_torch.raster.tiled import rasterize_direct

    tcam = band_scene["tcam"]
    y0 = 24
    jd, jt, _ = jrd(band_scene["js"], BW, 32, float(tcam.zn),
                    float(tcam.zf), y_offset=y0, full_height=BH,
                    interpret=True)
    jgb = jinterp(band_scene["js"], jd, jt, y_offset=y0)
    gb = interpolate_gbuffer(band_scene["ts"], _t(jd), _t(jt), y_offset=y0)
    for f in ("world_pos", "normal_ws", "uv", "bary", "face_normal",
              "tangent"):
        np.testing.assert_allclose(getattr(gb, f).numpy(),
                                   np.asarray(getattr(jgb, f)), rtol=0,
                                   atol=2e-5, err_msg=f)
    for f in ("obj_id", "covered", "tri_id", "depth01"):
        np.testing.assert_array_equal(getattr(gb, f).numpy(),
                                      np.asarray(getattr(jgb, f)), err_msg=f)
    fd, ft, _ = rasterize_direct(band_scene["ts"], BW, BH, tcam.zn, tcam.zf)
    full = interpolate_gbuffer(band_scene["ts"], fd, ft)
    band = interpolate_gbuffer(band_scene["ts"], fd[y0:y0 + 32],
                               ft[y0:y0 + 32], y_offset=y0)
    for f in ("world_pos", "normal_ws", "uv", "bary", "face_normal"):
        assert torch.equal(getattr(band, f), getattr(full, f)[y0:y0 + 32]), f


# ---------------------------------------------------------------------------
# Meshes and collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build,args", [
    ("make_mesh", (4,)), ("make_mesh", (8,)), ("make_mesh_lp", (4,)),
    ("make_mesh_pp", (2,))])
def test_meshes_raise_without_enough_devices(monkeypatch, build, args):
    """A mesh builder's default devices are the visible CUDA devices; with
    too few it raises ValueError naming the explicit one-card form, and
    never shrinks the mesh or moves to the CPU.  Given enough devices it
    lays them out as lsr_tpu does."""
    fn = getattr(tsh, build)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"devices=\[torch.device\('cuda', "
                                         r"0\)\]"):
        fn(*args)
    with pytest.raises(ValueError, match="needs"):
        fn(*args, devices=cpus(args[0] - 1))
    mesh = fn(*args, devices=cpus(args[0]))
    assert mesh.devices.size == args[0]
    assert all(d == CPU for d in mesh.devices.flat)
    expect = {"make_mesh": {4: (2, 2), 8: (2, 4)}, "make_mesh_lp": {4: (2, 2)},
              "make_mesh_pp": {2: (2,)}}[build][args[0]]
    assert tuple(mesh.shape.values()) == expect


def test_collectives_match_their_definitions():
    """all_gather concatenates every rank's part in rank order for every
    rank; ppermute moves parts along the permutation and gives zeros to a
    rank that receives nothing; psum adds in rank order, on every device
    asked for."""
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.standard_normal((2, 3)).astype(np.float32))
             for _ in range(4)]
    devs = cpus(4)
    for got in collectives.all_gather(parts, devs):
        assert torch.equal(got, torch.cat(parts))
    up = collectives.ppermute(parts, [(i, i + 1) for i in range(3)], devs)
    assert torch.equal(up[0], torch.zeros(2, 3))
    for i in range(1, 4):
        assert torch.equal(up[i], parts[i - 1])
    with pytest.raises(ValueError, match="twice"):
        collectives.ppermute(parts, [(0, 1), (2, 1)], devs)
    total = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    for got in collectives.psum(parts, devs):
        assert torch.equal(got, total)
    got, = collectives.psum(parts, devs[:1])
    assert torch.equal(got, total)


def test_replicate_moves_nested_state(flag):
    """replicate copies every tensor of nested dataclasses, tuples and
    dicts and keeps host fields (the lights' kinds, the context's flags)."""
    _, _, ctx, lights = flag["t"]
    got = tsh.replicate({"x": (lights, ctx)}, torch.device("meta"))
    lt, cm = got["x"]
    assert lt.position.device.type == "meta" and lt.kinds == lights.kinds
    assert cm.materials.base_color.device.type == "meta"
    assert cm.surface_maps == ctx.surface_maps


# ---------------------------------------------------------------------------
# The sharded paths
# ---------------------------------------------------------------------------

def test_render_band_matches_jax(tiny):
    """render_band of both packages on a band of 40 rows at row 12 of
    lsr_tpu's tiny cube: LDR within 1 LSB on >= 99.9% of pixels
    (use_tiled=False: lsr_tpu's brute raster sliced, the port's at the
    band's rows); the port's bands, of either raster, are the rows of its
    whole frame bit for bit."""
    from lsr_tpu.parallel.sharding import render_band as jrb

    w, h = 128, 64
    (jg, jo, jc), (tg, to, tc) = tiny["j"], tiny["t"]
    cams, tcams = _cams(1, w, h, 3.0, 0.5, 0.0)
    cam, tcam = cams[0], tcams[0]
    full = tsh.render_band(tg, to, tcam.viewproj, tcam.zn, tcam.zf, tc, w, h,
                           h, 0)
    assert full.shape == (h, w, 3) and full.dtype == torch.uint8
    # Jitted, as lsr_tpu runs it under shard_map.
    jband = jax.jit(functools.partial(jrb, width=w, height=h, band_h=40,
                                      y_offset=12, use_tiled=False))(
        jg, jo, cam.viewproj, cam.zn, cam.zf, jc)
    band = tsh.render_band(tg, to, tcam.viewproj, tcam.zn, tcam.zf, tc, w, h,
                           40, 12, use_tiled=False)
    assert int((np.asarray(jband) != np.asarray(jband)[:1, :1]).any(-1)
               .sum()) > 500
    _ldr_close(band.numpy(), jband)
    bands = [tsh.render_band(tg, to, tcam.viewproj, tcam.zn, tcam.zf, tc, w,
                             h, 16, y0) for y0 in range(0, h, 16)]
    assert torch.equal(torch.cat(bands), full)
    assert torch.equal(band, full[12:52])


def test_sharded_render_equals_whole_frames(tiny):
    """make_sharded_render on [cpu] * 8 (dp 2, sp 4): each camera equals the
    port's whole-frame render_band bit for bit."""
    w, h = 128, 64
    tg, to, tc = tiny["t"]
    mesh = tsh.make_mesh(8, devices=cpus(8))
    assert mesh.shape == {"dp": 2, "sp": 4}
    step = tsh.make_sharded_render(mesh, tg, to, tc, w, h, cap=256)
    _, tcams = _cams(2, w, h, 3.0, 0.5, 0.6)
    out = step(torch.stack([c.viewproj for c in tcams]), tcams[0].zn,
               tcams[0].zf)
    assert out.shape == (2, h, w, 3)
    for b, cam in enumerate(tcams):
        ref = tsh.render_band(tg, to, cam.viewproj, cam.zn, cam.zf, tc, w, h,
                              h, 0, cap=256)
        assert torch.equal(out[b], ref), b
        assert out[b].any()


def _flagship(mesh, state, w, h, shadow, sun, n_cams=None):
    tg, to, tc, tl = state
    dp = mesh.shape["dp"]
    step = tsh.make_sharded_flagship(mesh, tg, to, tc, tl, w, h,
                                     shadow_size=shadow)
    _, tcams = _cams(n_cams or dp, w, h, 3.5, 1.8, 0.5)
    return step(torch.stack([c.viewproj for c in tcams]),
                torch.stack([c.view for c in tcams]), tcams[0].proj,
                tcams[0].zn, tcams[0].zf, _t(sun))


def test_sharded_flagship_bit_exact(flag):
    """The flagship composition (sun map bands + all_gather, local atlas
    slots sharded over sp + all_gather, cull, forward+, FXAA with ppermute
    halos) over (2, 4) equals the (1, 1) mesh's frame bit for bit at
    128x128 with a 256^2 sun map, camera by camera; (1, 8) too, whose last
    ranks take zero view-projections past the 12 cube faces."""
    w = h = 128
    ref = _flagship(tsh.make_mesh(1, devices=cpus(1)), flag["t"], w, h, 256,
                    flag["sun"], n_cams=2)
    for n, dp in ((8, 2), (8, 1)):
        out = _flagship(tsh.make_mesh(n, dp=dp, devices=cpus(n)), flag["t"],
                        w, h, 256, flag["sun"], n_cams=2)
        assert out.shape == ref.shape == (2, h, w, 3)
        assert torch.equal(out, ref), (n, dp)
    assert ref[0].any()


def test_sharded_flagship_matches_jax(flag):
    """The (1, 1) flagship of both packages at 64x64 with a 128^2 sun map:
    LDR within 1 LSB on >= 99.9% of pixels.  lsr_tpu's step is jitted; its
    sun map's texel snap (ROADMAP C11) and its lax.map over atlas slots
    (C15) did not move this frame, so the jitted step is the reference."""
    from lsr_tpu.parallel.sharding import make_mesh as jmesh
    from lsr_tpu.parallel.sharding import make_sharded_flagship as jflag

    w = h = 64
    jg, jo, jc, jl = flag["j"]
    step = jflag(jmesh(1), jg, jo, jc, jl, w, h, shadow_size=128)
    cams, _ = _cams(1, w, h, 3.5, 1.8, 0.5)
    ref = np.asarray(step(cams[0].viewproj[None], cams[0].view[None],
                          cams[0].proj, cams[0].zn, cams[0].zf, flag["sun"]))
    out = _flagship(tsh.make_mesh(1, devices=cpus(1)), flag["t"], w, h, 128,
                    flag["sun"])
    assert out.shape == ref.shape == (1, h, w, 3)
    _ldr_close(out.numpy(), ref)


def test_light_sharded_forward(flag):
    """Lights sharded over lp (psum of the partial sums) on (sp 4, lp 2) and
    (sp 1, lp 8) against the (1, 1) mesh, and the (1, 1) mesh against
    lsr_tpu's: at most 1 LSB on under 2% of pixels.  16 lights do not
    split into whole slices of 3 (lp 3): the set is padded with disabled
    lights, which change nothing."""
    from lsr_tpu.parallel.sharding import make_light_sharded_forward as jlsf
    from lsr_tpu.parallel.sharding import make_mesh_lp as jmesh_lp

    w = h = 64
    jg, jo, jc, jl = _lit_scene(3, 16, 1.5, 2.5)
    state = _to_torch(jg, jo, jc, jl)
    cams, tcams = _cams(1, w, h, 3.5, 1.8, 0.4)
    cam, tcam = cams[0], tcams[0]

    def run(mesh):
        step, shards = tsh.make_light_sharded_forward(mesh, *state, w, h,
                                                      cap=32)
        assert len(shards) == mesh.shape["lp"]
        return step(tcam.viewproj, tcam.view, tcam.proj, tcam.zn, tcam.zf)

    ref = run(tsh.make_mesh_lp(1, sp=1, lp=1, devices=cpus(1)))
    assert ref.shape == (h, w, 3) and ref.any()
    for sp, lp in ((4, 2), (1, 8), (1, 3)):
        _lp_close(run(tsh.make_mesh_lp(sp * lp, sp=sp, lp=lp,
                                       devices=cpus(sp * lp))), ref)
    jstep, _ = jlsf(jmesh_lp(1, sp=1, lp=1), jg, jo, jc, jl, w, h, cap=32)
    _lp_close(ref.numpy(),
              jstep(cam.viewproj, cam.view, cam.proj, cam.zn, cam.zf))


def test_pipelined_render(tiny):
    """The two-stage pipeline over a stream of 4 cameras: output i equals
    the whole-frame render_band of camera i - 1 bit for bit; output 0 is
    the fill bubble (background only)."""
    w, h = 128, 64
    tg, to, tc = tiny["t"]
    mesh = tsh.make_mesh_pp(2, devices=cpus(2))
    stream = tsh.make_pipelined_render(mesh, tg, to, tc, w, h)
    _, tcams = _cams(4, w, h, 3.0, 0.5, 0.8)
    out = stream(torch.stack([c.viewproj for c in tcams]), tcams[0].zn,
                 tcams[0].zf)
    assert out.shape == (4, h, w, 3)
    assert (out[0] == out[0, :1, :1]).all()
    for i in range(1, 4):
        ref = tsh.render_band(tg, to, tcams[i - 1].viewproj, tcams[0].zn,
                              tcams[0].zf, tc, w, h, h, 0)
        assert torch.equal(out[i], ref), i
    with pytest.raises(AssertionError, match="pp axis"):
        tsh.make_pipelined_render(tsh.make_mesh_pp(3, devices=cpus(3)), tg,
                                  to, tc, w, h)


# ---------------------------------------------------------------------------
# Dry runs
# ---------------------------------------------------------------------------

def test_dryruns_print_rows(capsys):
    """run_dryrun and run_flagship_dryrun on 4 CPU ranks at 64x64 (8 ranks
    would cut 64 rows into bands of 8, less than a light tile): each checks
    its meshes against the unsharded frames and prints one JSON row per
    mesh (render (2, 2), flagship (1, 1) / (1, 4) / (2, 2), lp (2, 2) /
    (1, 4), pp)."""
    from lsr_tpu_torch.parallel.dryrun import run_dryrun

    rows = run_dryrun(4, device="cpu", width=64, height=64, flagship_size=64,
                      shadow_size=128)
    printed = [json.loads(line)
               for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == rows
    kinds = {(r["path"], r.get("dp"), r.get("sp"), r.get("lp"), r.get("pp"))
             for r in rows}
    assert kinds == {("render", 2, 2, None, None),
                     ("flagship", 1, 1, None, None),
                     ("flagship", 1, 4, None, None),
                     ("flagship", 2, 2, None, None),
                     ("light_sharded", 1, 2, 2, None),
                     ("light_sharded", 1, 1, 4, None),
                     ("pipelined", None, None, None, 2)}
    for r in rows:
        assert r["platform"] == "cpu" and r["ranks"] >= 1
        assert r["step_ms"] > 0 and r["w"] == 64 and r["h"] == 64
