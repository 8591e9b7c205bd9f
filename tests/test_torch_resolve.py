"""lsr_tpu_torch's fused resolve (kernel B5's plain path), the resolve
route of the forward+ pass and the resolve frame vs lsr_tpu (CPU).

The JAX side runs resolve_fused_pallas in Pallas interpret mode, as its own
CPU tests do; the torch side the plain versions.  Both get the same scene
(tests/torch_scenes.py: 4 spheres + ground plane, 16 lights), lsr_tpu's own
setup and visibility buffer, and, with a sun shadow, lsr_tpu's own 256^2
ESM map carried over by convert.shadow_context.  Each test states its
tolerance; the residual differences are f32 rounding (XLA:CPU fuses
multiply-adds into FMAs, torch does not) and ESM's one-quantum soft-map
differences.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import (
    jax_camera,
    jax_flagship_scene,
    jax_reference_stages,
    jax_sun_shadow,
    to_torch,
    torch_setup,
)

W, H = 128, 96
S = 256


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """Scene state on both sides, lsr_tpu's setup and visibility buffer
    (brute raster) and its 256^2 ESM sun map."""
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.setup import scene_setup

    from lsr_tpu_torch import convert

    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    _, _, sc = jax_sun_shadow(geom, objects, ctx, S)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t),
                t=to_torch(geom, objects, lights, ctx, cam, ctx_t),
                setup=setup, depth=depth, tid=tid, shadow=sc,
                tshadow=convert.shadow_context(sc, "cpu"))


def _mixed_lights():
    """Point / spot / rect / tube lights with non-unit attenuation powers
    and every attenuation model; lsr_tpu LightsSoA."""
    from lsr_tpu.lighting.light_types import LightSetBuilder

    rng = np.random.default_rng(11)
    b = LightSetBuilder()
    for i in range(12):
        p = tuple(rng.uniform([-2.5, 0.0, -2.5], [2.5, 2.0, 2.5]).tolist())
        c = tuple(rng.uniform(0.3, 1.0, 3).tolist())
        if i % 4 == 1:
            b.rect_area(p, (0, -1, 0), color=c, intensity=1.5, range=4.0)
        elif i % 4 == 2:
            b.tube_area(p, axis=(1, 0, 0), color=c, intensity=1.5, range=4.0,
                        atten_power=1.5, atten_model=i % 3)
        elif i % 4 == 0:
            b.spot(p, (0, -1, 0), color=c, intensity=2.0, range=4.0)
        else:
            b.point(p, color=c, intensity=1.5, range=3.0, atten_power=0.7)
    return b.build()


@pytest.mark.parametrize("lights_kind,sun_model,chunk", [
    ("flagship", "pbr_mr", 8), ("flagship", "blinn_phong", 8),
    ("mixed", "pbr_mr", 8), ("mixed", "blinn_phong", 8),
    ("mixed", "pbr_mr", 16)])
def test_resolve_fused_matches_pallas(scene, lights_kind, sun_model, chunk):
    """resolve_fused (records through tid) against resolve_fused_pallas on
    the gathered records, the same sun visibility (seeded, in [0, 1]) and
    texture albedo: HDR within 1e-4 everywhere, background included."""
    from lsr_tpu.lighting.resolve_kernel import resolve_fused_pallas
    from lsr_tpu.raster.interp import pack_interp_records

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.resolve_kernel import resolve_fused

    _, _, lights, ctx, cam, ctx_t = scene["j"]
    _, _, tl, _, tcam, tct = scene["t"]
    if lights_kind == "mixed":
        lights = _mixed_lights()
        tl = convert.lights_soa(lights, "cpu")
    rng = np.random.default_rng(3)
    vis = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    tex = rng.uniform(0.3, 1.0, (H, W, 3)).astype(np.float32)
    table = pack_interp_records(scene["setup"], ctx.materials)
    tid = np.asarray(scene["tid"])
    rec = np.asarray(table)[np.where(tid >= 0, tid, 0)]
    radiance = ctx_t.light_color * ctx_t.light_intensity
    bg = (0.04, 0.06, 0.1)
    jh, jst = resolve_fused_pallas(
        jnp.asarray(rec), jnp.asarray(vis), jnp.asarray(tid >= 0),
        jnp.asarray(tex), ctx_t.camera_pos, ctx_t.light_dir_ws, radiance,
        jnp.asarray(bg, jnp.float32), lights, cam.view, cam.proj, W, H,
        cap=256, chunk=chunk, sun_model=sun_model, interpret=True)
    th, tst = resolve_fused(
        _t(table), _t(tid), _t(vis), _t(tex), tct.camera_pos,
        tct.light_dir_ws, tct.light_color * tct.light_intensity, bg, tl,
        tcam.view, tcam.proj, W, H, cap=256, chunk=chunk,
        sun_model=sun_model)
    assert int(tst["max_count"]) == int(jst["max_count"]) > 0
    jh = np.asarray(jh)
    assert np.isfinite(jh).all() and jh.max() > 0.1
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=1e-4)


def test_reconstruct_world_pos_matches_jax(scene):
    """Within f32 rounding of lsr_tpu's (1e-6 relative to the scene's
    extent, 2e-5 absolute), on every pixel."""
    from lsr_tpu.raster.interp import reconstruct_world_pos as jrec

    from lsr_tpu_torch.raster.interp import reconstruct_world_pos

    _, _, _, _, cam, _ = scene["j"]
    _, _, _, _, tcam, _ = scene["t"]
    j = np.asarray(jrec(scene["depth"], cam.view, cam.proj, cam.zn, cam.zf,
                        W, H))
    t = reconstruct_world_pos(_t(scene["depth"]), tcam.view, tcam.proj,
                              tcam.zn, tcam.zf, W, H).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=2e-5)


@pytest.mark.parametrize("sun_model", ["pbr_mr", "blinn_phong"])
def test_resolve_forward_plus_matches_jax(scene, sun_model):
    """resolve_forward_plus with the ESM sun shadow, on lsr_tpu's setup,
    depth and tid: sun visibility within 1.3e-3 (one soft-map quantum) and
    HDR within 1e-4 on >= 99.9% of pixels, within 3e-3 everywhere (the
    visibility difference times the sun term)."""
    from lsr_tpu.passes.forward_plus import resolve_forward_plus as jres

    from lsr_tpu_torch.passes.forward_plus import resolve_forward_plus

    _, _, lights, _, cam, ctx_t = scene["j"]
    _, _, tl, _, tcam, tct = scene["t"]
    jctx = dataclasses.replace(ctx_t, shadow=scene["shadow"])
    tctx = dataclasses.replace(tct, shadow=scene["tshadow"])
    jh, jst = jres(scene["setup"], scene["depth"], scene["tid"], jctx, lights,
                   cam.view, cam.proj, cam.zn, cam.zf, W, H, cap=128,
                   sun_model=sun_model)
    th, tst = resolve_forward_plus(
        torch_setup(scene["setup"]), _t(scene["depth"]),
        _t(scene["tid"]).to(torch.int32), tctx, tl, tcam.view, tcam.proj,
        tcam.zn, tcam.zf, W, H, cap=128, sun_model=sun_model)
    assert int(tst["max_lights_per_bin"]) == int(jst["max_lights_per_bin"])
    assert float(tst["sun_vis"].min()) < 0.5          # the shadow shows
    d = np.abs(th.numpy() - np.asarray(jh)).max(-1)
    assert (d <= 1e-4).mean() >= 0.999, (d <= 1e-4).mean()
    assert d.max() <= 3e-3, d.max()


def test_resolve_route_matches_b2_route(scene):
    """The port's two routes on the same visibility buffer and ESM shadow:
    resolve_forward_plus against interpolate_gbuffer + shade_forward_plus
    at lsr_tpu's own bar (tests/test_resolve_kernel.py:96-97): mean |dHDR|
    < 5e-3 and < 1% of pixels over 0.05 (the resolve route samples the
    shadow at reconstructed positions with corner-0 normals)."""
    from lsr_tpu_torch.passes.forward_plus import (
        resolve_forward_plus, shade_forward_plus)
    from lsr_tpu_torch.raster.interp import interpolate_gbuffer

    _, _, tl, tc, tcam, tct = scene["t"]
    tctx = dataclasses.replace(tct, shadow=scene["tshadow"])
    setup = torch_setup(scene["setup"])
    depth, tid = _t(scene["depth"]), _t(scene["tid"]).to(torch.int32)
    hr, _ = resolve_forward_plus(setup, depth, tid, tctx, tl, tcam.view,
                                 tcam.proj, tcam.zn, tcam.zf, W, H, cap=128)
    gb = interpolate_gbuffer(setup, depth, tid, materials=tc.materials,
                             want_face_normal=False)
    hb, _ = shade_forward_plus(gb, tctx, tl, tcam.view, tcam.proj, tcam.zn,
                               tcam.zf, W, H, tile_size=16, cap=128,
                               mode="tiled")
    d = (hr - hb).abs().numpy()
    assert d.mean() < 5e-3, d.mean()
    assert (d.max(-1) > 0.05).mean() < 0.01, (d.max(-1) > 0.05).mean()


def test_resolve_rejects_unported_options(scene):
    """What the resolve route still refuses, never falling through: planes
    without their light -> plane index (or an index without planes), an
    unknown record layout or sun model."""
    from lsr_tpu_torch.lighting.resolve_kernel import resolve_fused

    _, _, tl, _, tcam, tct = scene["t"]
    tid = _t(scene["tid"]).to(torch.int32)
    ones = torch.ones((H, W))
    base = (torch.zeros((1, 56)), tid, ones, torch.ones((H, W, 3)),
            tct.camera_pos, tct.light_dir_ws, tct.light_color,
            (0.0, 0.0, 0.0), tl, tcam.view, tcam.proj, W, H)
    with pytest.raises(ValueError, match="light_shadow_index"):
        resolve_fused(*base, local_vis_planes=ones[None])
    with pytest.raises(ValueError, match="light_shadow_index"):
        resolve_fused(*base, light_shadow_index=torch.zeros(
            tl.count, dtype=torch.int64))
    with pytest.raises(ValueError, match="rec_layout"):
        resolve_fused(*base, rec_layout="rows")
    with pytest.raises(ValueError, match="sun_model"):
        resolve_fused(*base, sun_model="toon")


@pytest.mark.parametrize("lights_kind", ["flagship", "mixed"])
def test_resolve_fused_local_planes_match_pallas(scene, lights_kind):
    """Kernel variant B5a's plain version: test_resolve_fused_matches_pallas
    with seeded local-shadow planes (K = 3, plane 3 = 1.0) and a plane per
    light, into resolve_fused_pallas(local_vis_planes=...,
    light_shadow_index=..., interpret=True): HDR within 1e-4.  The planes
    change the result."""
    from lsr_tpu.lighting.resolve_kernel import resolve_fused_pallas
    from lsr_tpu.raster.interp import pack_interp_records

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.resolve_kernel import resolve_fused

    _, _, lights, ctx, cam, ctx_t = scene["j"]
    _, _, tl, _, tcam, tct = scene["t"]
    if lights_kind == "mixed":
        lights = _mixed_lights()
        tl = convert.lights_soa(lights, "cpu")
    rng = np.random.default_rng(4)
    vis = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    tex = rng.uniform(0.3, 1.0, (H, W, 3)).astype(np.float32)
    planes = rng.uniform(0.0, 1.0, (4, H, W)).astype(np.float32)
    planes[3] = 1.0
    idx = rng.integers(0, 4, tl.count).astype(np.int32)
    table = pack_interp_records(scene["setup"], ctx.materials)
    tid = np.asarray(scene["tid"])
    rec = np.asarray(table)[np.where(tid >= 0, tid, 0)]
    radiance = ctx_t.light_color * ctx_t.light_intensity
    bg = (0.04, 0.06, 0.1)
    jh, _ = resolve_fused_pallas(
        jnp.asarray(rec), jnp.asarray(vis), jnp.asarray(tid >= 0),
        jnp.asarray(tex), ctx_t.camera_pos, ctx_t.light_dir_ws, radiance,
        jnp.asarray(bg, jnp.float32), lights, cam.view, cam.proj, W, H,
        cap=256, chunk=8, sun_model="pbr_mr", interpret=True,
        local_vis_planes=jnp.asarray(planes),
        light_shadow_index=jnp.asarray(idx))
    args = (_t(table), _t(tid), _t(vis), _t(tex), tct.camera_pos,
            tct.light_dir_ws, tct.light_color * tct.light_intensity, bg, tl,
            tcam.view, tcam.proj, W, H)
    th, _ = resolve_fused(*args, cap=256, chunk=8, local_vis_planes=_t(planes),
                          light_shadow_index=_t(idx))
    jh = np.asarray(jh)
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=1e-4)
    plain, _ = resolve_fused(*args, cap=256, chunk=8)
    assert float((plain - th).abs().max()) > 0.05


def test_resolve_forward_plus_sun_vis_scale_matches_jax(scene):
    """resolve_forward_plus with sun_vis_scale=2 (strided sun visibility,
    bilinear upsampling; bench.py's ESM default): the tolerances of
    test_resolve_forward_plus_matches_jax."""
    from lsr_tpu.passes.forward_plus import resolve_forward_plus as jres

    from lsr_tpu_torch.passes.forward_plus import resolve_forward_plus

    _, _, lights, _, cam, ctx_t = scene["j"]
    _, _, tl, _, tcam, tct = scene["t"]
    jctx = dataclasses.replace(ctx_t, shadow=scene["shadow"])
    tctx = dataclasses.replace(tct, shadow=scene["tshadow"])
    jh, _ = jres(scene["setup"], scene["depth"], scene["tid"], jctx, lights,
                 cam.view, cam.proj, cam.zn, cam.zf, W, H, cap=128,
                 sun_vis_scale=2)
    th, tst = resolve_forward_plus(
        torch_setup(scene["setup"]), _t(scene["depth"]),
        _t(scene["tid"]).to(torch.int32), tctx, tl, tcam.view, tcam.proj,
        tcam.zn, tcam.zf, W, H, cap=128, sun_vis_scale=2)
    sv = tst["sun_vis"].numpy()
    assert sv.min() < 0.5 and ((sv > 0.01) & (sv < 0.99)).mean() > 0.01
    d = np.abs(th.numpy() - np.asarray(jh)).max(-1)
    assert (d <= 1e-4).mean() >= 0.999, (d <= 1e-4).mean()
    assert d.max() <= 3e-3, d.max()


def test_resolve_frame_matches_jax():
    """make_flagship_frame(use_resolve=True) at 192x108 with a 256^2 ESM sun
    map against lsr_tpu's same composition (sun map op by op, then setup,
    rasterize_direct, resolve_forward_plus, tonemap, FXAA): the sun map's
    light camera equal, tids on >= 99.5% of covered pixels, LDR within 1
    LSB on >= 99.9% of pixels."""
    from lsr_tpu.passes.post import fxaa_pass as jfx
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    from lsr_tpu_torch.frame import flagship_stages, make_flagship_frame

    w, h = 192, 108
    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, w, h)
    ref = jax_reference_stages(geom, objects, lights, ctx, cam, ctx_t, w, h,
                               shadow_size=S, use_resolve=True)
    jl = np.asarray(jfx(jtm(ref["hdr"])))
    tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam,
                                         ctx_t)
    frame = make_flagship_frame(tg, to, tl, tc, w, h, use_resolve=True,
                                shadow_size=S, with_cull=False,
                                with_local=False)
    ldr = frame(tcam, tct)[0].numpy()
    st = flagship_stages(tg, to, tl, tc, tcam, tct, w, h, use_resolve=True,
                         shadow_size=S, with_cull=False, with_local=False)
    np.testing.assert_array_equal(st["light_viewproj"].numpy(),
                                  np.asarray(ref["light_viewproj"]))
    assert st["gb"] is None and float(st["sun_vis"].min()) < 0.5
    tid_j, tid_t = np.asarray(ref["tid"]), st["tid"].numpy()
    covered = int((tid_j >= 0).sum())
    assert (tid_j != tid_t).sum() <= 0.005 * covered
    assert ldr.shape == (h, w, 3) and ldr.dtype == np.uint8
    d = np.abs(jl.astype(int) - ldr.astype(int)).max(-1)
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()


# ---------------------------------------------------------------------------
# What the light walk of kernels B2, B5 and B6 skips: light_live (its warps'
# vote) and lights_near_box (its warps' box test) against light_terms, on
# seeded records and pixels
# ---------------------------------------------------------------------------

TH, TW = 8, 32       # two warp rows of four 8x4 rectangles per tile


def _seeded_lights(seed, tiles=3, chunk=16):
    """(tiles, chunk, 32) packed records around the origin: point, spot,
    rect and tube lights, the three attenuation models, powers 0.7 to 2,
    a cutoff on a third, ranges 0.3 to 2.5; the last three slots of every
    tile are zero records (list slots past the count)."""
    rng = np.random.default_rng(seed)
    n = tiles * chunk
    f = np.zeros((n, 32), np.float32)
    f[:, 0] = rng.choice([1.0, 2.0, 3.0, 4.0], n)
    f[:, 1:4] = rng.uniform(-2.0, 2.0, (n, 3))
    f[:, 4:7] = rng.normal(0.0, 1.0, (n, 3))
    f[:, 7:10] = rng.normal(0.0, 1.0, (n, 3))
    f[:, 10:13] = rng.normal(0.0, 1.0, (n, 3))
    f[:, 13:16] = rng.uniform(0.1, 1.0, (n, 3))
    f[:, 16] = rng.uniform(0.5, 3.0, n)
    f[:, 17] = rng.uniform(0.3, 2.5, n)
    f[:, 18] = rng.uniform(0.1, 0.6, n)
    f[:, 19] = f[:, 18] + rng.uniform(0.0, 0.5, n)
    f[:, 20:23] = rng.uniform(0.05, 0.6, (n, 3))
    f[:, 24] = rng.choice([0.0, 1.0, 2.0], n)
    f[:, 25] = rng.choice([0.7, 1.0, 1.5, 2.0], n)
    f[:, 26] = 1e-3
    f[:, 27] = np.where(rng.random(n) < 1 / 3, rng.uniform(0.01, 0.2, n), 0.0)
    f = f.reshape(tiles, chunk, 32)
    f[:, -3:] = 0.0
    return torch.from_numpy(f)


def _seeded_pixels(seed, tiles=3, th=TH, tw=TW):
    """Pixel planes (tiles, 1, th * tw): positions in coherent patches per
    8x4 rectangle (as a surface gives them), unit normals and view vectors,
    a quarter of the pixels uncovered and one rectangle wholly so."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-2.0, 2.0, (tiles, th // 4, 1, tw // 8, 1, 3))
    p = (centre + rng.uniform(-0.15, 0.15, (tiles, th // 4, 4, tw // 8, 8, 3))
         ).reshape(tiles, 1, th * tw, 3).astype(np.float32)

    def unit():
        v = rng.normal(0.0, 1.0, (tiles, 1, th * tw, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    cov = rng.random((tiles, th // 4, 4, tw // 8, 8)) < 0.75
    cov[0, 0, :, 1, :] = False
    planes = [torch.from_numpy(np.ascontiguousarray(a[..., i]))
              for a in (p, unit(), unit()) for i in range(3)]
    return planes, torch.from_numpy(cov.reshape(tiles, 1, th * tw))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _live_case(seed, apow1, th=TH, tw=TW):
    from lsr_tpu_torch.lighting.fplus_kernel import ALL_KINDS
    from lsr_tpu_torch.lighting.shade_kernel import light_live, light_terms

    blk = _seeded_lights(seed)
    (px, py, pz, nx, ny, nz, vx, vy, vz), cov = _seeded_pixels(seed + 100,
                                                               th=th, tw=tw)
    _, wd, ws = light_terms(blk, px, py, pz, nx, ny, nz, vx, vy, vz, cov,
                            apow1, ALL_KINDS)
    live = light_live(blk, px, py, pz, nx, ny, nz, cov, ALL_KINDS)
    return blk, (px, py, pz, nx, ny, nz), cov, wd, ws, live


@pytest.mark.parametrize("seed,apow1", [(0, False), (1, False), (2, True)])
def test_light_terms_are_zero_outside_light_live(seed, apow1):
    """light_terms with every (light, pixel) pair outside light_live zeroed
    equals light_terms bit for bit (the skipped terms are +0, not -0 and
    not NaN): point, spot, rect and tube lights, the three attenuation
    models, cutoffs, zero records past the count and uncovered pixels.  So
    a warp of kernel B5 that finds no live pixel for a light may skip it.
    The sweep has enough dead and enough lit pairs to mean something."""
    _, _, cov, wd, ws, live = _live_case(seed, apow1)
    zero = torch.zeros_like(wd)
    assert torch.equal(_bits(torch.where(live, wd, zero)), _bits(wd))
    assert torch.equal(_bits(torch.where(live, ws, zero)), _bits(ws))
    assert not bool(live[:, -3:].any())            # zero records
    assert not bool((live & ~cov).any())
    lit = (wd > 0).float().mean()
    assert 0.3 < float((~live).float().mean()) and float(lit) > 0.01


def test_light_live_sweep_catches_an_eager_skip():
    """The test of the test: a live test that gives up at 90% of the range
    zeroes terms that light_terms does not."""
    from lsr_tpu_torch.lighting.fplus_kernel import ALL_KINDS
    from lsr_tpu_torch.lighting.shade_kernel import light_live

    blk, (px, py, pz, nx, ny, nz), cov, wd, _, _ = _live_case(0, False)
    eager = blk.clone()
    eager[..., 17] *= 0.9
    live = light_live(eager, px, py, pz, nx, ny, nz, cov, ALL_KINDS)
    assert not torch.equal(_bits(torch.where(live, wd, torch.zeros_like(wd))),
                           _bits(wd))


# The tile shapes of the kernels: this tiny one, then B6's 16x128, 32x128
# and 64x128 (B2 and B5 bin to 64x128 only).
@pytest.mark.parametrize("seed,th,tw", [
    pytest.param(0, TH, TW, id="0"), pytest.param(1, TH, TW, id="1"),
    pytest.param(2, TH, TW, id="2"), pytest.param(3, 16, 128, id="16x128"),
    pytest.param(4, 32, 128, id="32x128"),
    pytest.param(5, 64, 128, id="64x128")])
def test_lights_near_box_keeps_every_live_pair(seed, th, tw):
    """The walk's box test (each warp boxes the positions of its covered
    8x4 pixels and drops the point and spot lights whose range the box's
    nearest point misses) never drops a light with a live pixel in the
    rectangle, also with NaN positions and infinite colors in play; it
    keeps every rect and tube light; it does drop most of the rest."""
    from lsr_tpu_torch.lighting.light_walk import lights_near_box, rect_any

    blk, (px, py, pz, *_), cov, _, _, live = _live_case(seed, False, th, tw)
    px = px.clone()
    px[1, 0, 5] = float("nan")
    blk[2, 0, 13] = float("inf")
    blk[2, 0, 0] = 1.0
    near = lights_near_box(blk, px, py, pz, cov, th, tw)
    wanted = rect_any(live, th, tw, 8, 4)
    assert not bool((wanted & ~near).any())
    area = (blk[..., 0] == 3.0) | (blk[..., 0] == 4.0)
    assert bool(near[area].all()) and bool(near[2, 0].all())
    assert not bool(near[0, ~area[0], 0, 1].any())   # the uncovered rectangle
    assert float(near[~area].float().mean()) < 0.5
    assert int((wanted & ~area[..., None, None]).sum()) > 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walked_pairs_hold_every_term_that_is_not_zero(seed):
    """Every term color * wd and color * ws outside light_walk.walked_pairs
    (the pairs the light walk of B2, B5 and B6 evaluates: slots within the
    walk, kept by the warp's box test and its vote) is +0, bit for bit, on
    the seeded sweep with a light of infinite color, which every warp
    walks, covered or not (its 0 * inf terms are NaN).  The three zero
    records at the end of each tile lie past the walk."""
    from lsr_tpu_torch.lighting.fplus_kernel import ALL_KINDS
    from lsr_tpu_torch.lighting.light_walk import walked_pairs
    from lsr_tpu_torch.lighting.shade_kernel import light_terms

    blk = _seeded_lights(seed)
    (px, py, pz, nx, ny, nz, vx, vy, vz), cov = _seeded_pixels(seed + 100)
    blk[2, 0, 13] = float("inf")
    cols, wd, ws, reach = light_terms(blk, px, py, pz, nx, ny, nz, vx, vy, vz,
                                      cov, False, ALL_KINDS, want_reach=True)
    listed = torch.ones(blk.shape[:2], dtype=torch.bool)
    listed[:, -3:] = False
    keep = walked_pairs(blk, px, py, pz, cov, reach, listed, TH, TW)
    for c in cols:
        for t in (c * wd, c * ws):
            assert torch.equal(_bits(torch.where(keep, t, 0.0)), _bits(t))
    assert bool(keep[2, 0].all())                    # the infinite light
    uncovered = [r * TW + x for r in range(4) for x in range(8, 16)]
    assert not bool(keep[0][:, uncovered].any())
    assert float(keep.float().mean()) < 0.3


def test_lights_near_box_sweep_catches_a_tight_box():
    """The test of the test: with the box's range test 20% too tight the
    same sweep finds a dropped light that has a live pixel."""
    from lsr_tpu_torch.lighting.light_walk import lights_near_box, rect_any

    blk, (px, py, pz, *_), cov, _, _, live = _live_case(0, False)
    tight = blk.clone()
    tight[..., 17] *= 0.8
    near = lights_near_box(tight, px, py, pz, cov, TH, TW)
    assert bool((rect_any(live, TH, TW, 8, 4) & ~near).any())


def test_walk_counts_are_consistent(scene):
    """walk_counts (what chip_smoke.py reports of B5's light walk) on the
    grid-2 scene: live pairs within what a warp vote keeps, within what its
    box test keeps, within the walk; a block vote keeps at least a warp
    vote's lights; the binned pairs equal a direct count."""
    from lsr_tpu.raster.interp import pack_interp_records

    from lsr_tpu_torch.lighting import resolve_kernel as rk
    from lsr_tpu_torch.lighting.shade_kernel import bin_light_records

    _, _, _, ctx, _, _ = scene["j"]
    _, _, tl, _, tcam, _ = scene["t"]
    table = _t(pack_interp_records(scene["setup"], ctx.materials))
    tid = _t(scene["tid"])
    trec, cnts, _ = bin_light_records(tl, tcam.view, tcam.proj, W, H, 64, 128,
                                      256, None)
    c = rk.walk_counts(table, tid, torch.ones((H, W, 3)), trec, cnts, W, H,
                       64, 128, 8, tl.kinds)
    assert 0 < c["pairs_live"] <= c["pairs_after_warp_vote"] \
        <= c["pairs_after_warp_box"] <= c["pairs_walked"]
    assert c["pairs_after_warp_vote"] <= c["pairs_after_block_vote"]
    assert c["pairs_live"] <= c["pairs_after_row_vote"]
    assert c["pairs_live"] < c["pairs_binned"] <= c["pairs_walked"]
    cov = (tid >= 0)
    per_tile = [int(cov[y:y + 64, :128].sum()) for y in (0, 64)]
    assert c["pairs_binned"] == sum(int(n) * p for n, p in zip(cnts, per_tile))
    assert c["lights_live_per_warp_max"] <= c["lights_live_per_block_max"]


def test_walk_counts_split_the_live_pairs_by_plane(scene):
    """walk_counts' pairs_live_shadowed (the plane texels chip_smoke.py
    charges B2a / B5a) counts the live pairs whose record lane 28 is below
    n_shadowed: none for n_shadowed 0, all of them when every light has
    plane 0, and two complementary halves of the lights add up to all."""
    from lsr_tpu.raster.interp import pack_interp_records

    from lsr_tpu_torch.lighting import resolve_kernel as rk
    from lsr_tpu_torch.lighting.shade_kernel import bin_light_records

    _, _, _, ctx, _, _ = scene["j"]
    _, _, tl, _, tcam, _ = scene["t"]
    table = _t(pack_interp_records(scene["setup"], ctx.materials))
    tid = _t(scene["tid"])
    trec, cnts, _ = bin_light_records(tl, tcam.view, tcam.proj, W, H, 64, 128,
                                      256, None)

    def shadowed(rec, n):
        c = rk.walk_counts(table, tid, torch.ones((H, W, 3)), rec, cnts, W,
                           H, 64, 128, 8, tl.kinds, n_shadowed=n)
        return c["pairs_live"], c["pairs_live_shadowed"]

    rec = trec.clone()
    rec[..., 28] = 0.0
    live, all_ = shadowed(rec, 1)
    assert live > 0 and all_ == live and shadowed(rec, 0)[1] == 0
    odd = (torch.arange(rec.shape[1]) % 2).to(torch.float32)
    rec[..., 28] = odd
    _, even_half = shadowed(rec, 1)
    rec[..., 28] = 1.0 - odd
    _, odd_half = shadowed(rec, 1)
    assert 0 < even_half < live and 0 < odd_half < live
    assert even_half + odd_half == live
