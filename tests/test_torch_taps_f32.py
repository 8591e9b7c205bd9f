"""lsr_tpu's f32 PCF tap tables (its shadow_sample.TAPS_U16 False) in
lsr_tpu_torch (CPU): convert carries them, and the port renders with its
own flag (lsr_tpu_torch.lighting.shadow_sample.TAPS_U16) False as lsr_tpu
does with its own.

lsr_tpu's flag is set False inside each test and restored in `finally`, as
lsr_tpu's own tests do (tests/test_shadow_culling.py:188-204); the port's
likewise.  With both False:
- convert.shadow_context leaves the sun's taps_q16 None (the sun samples
  its f32 depth, which is what lsr_tpu's f32 anchor windows hold: packing
  the carried map again gives lsr_tpu's table bit for bit), and
  convert.local_shadow_maps carries each slot's (S, S) f32 depth the same
  way;
- the sun visibility equals lsr_tpu's exactly (tap counts are integers);
  the local planes agree as test_torch_local_shadows.py holds PCF planes
  (within 1e-6 on >= 99.9% of pixels, within 0.03 everywhere);
- a small PCF flagship frame (128x96, sun 128^2, slots 64^2, faces 32^2)
  is within C1's frame contract of lsr_tpu's, as
  test_torch_frame.py::test_whole_frame_matches_jax holds it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import (
    jax_camera,
    jax_flagship_scene,
    jax_local_atlas,
    jax_sun_shadow,
    to_torch,
)

W, H = 128, 96
S = 128
SPOT, POINT = 64, 32


@contextlib.contextmanager
def taps_f32():
    """Both packages' TAPS_U16 False inside, restored after."""
    from lsr_tpu.lighting import shadow_sample as jss

    from lsr_tpu_torch.lighting import shadow_sample as tss

    old = jss.TAPS_U16, tss.TAPS_U16
    jss.TAPS_U16 = tss.TAPS_U16 = False
    try:
        yield
    finally:
        jss.TAPS_U16, tss.TAPS_U16 = old


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """The grid-2 stand-in with 16 lights, camera 0 of the bench orbit and
    lsr_tpu's G-buffer of it (brute raster)."""
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.shading.models import _norm

    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials,
                             want_face_normal=False)
    n = np.asarray(gb.normal_ws)
    l_dir = -np.asarray(ctx.light_dir_ws)
    l_dir = l_dir / np.linalg.norm(l_dir)
    ndl = np.maximum((n * l_dir).sum(-1), 0.0).astype(np.float32)
    return dict(geom=geom, objects=objects, lights=lights, ctx=ctx, cam=cam,
                ctx_t=ctx_t, wp=gb.world_pos,
                nm=jnp.asarray(_norm(gb.normal_ws)), ndl=ndl,
                covered=np.asarray(gb.covered))


@pytest.fixture(scope="module")
def atlases(scene):
    """lsr_tpu's PCF atlas (slot by slot) with u16 tables and with f32
    tables, all lights shadowed, one point culled."""
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters

    ids = plan_shadow_casters(scene["lights"])
    en = np.ones(len(ids[0]) + len(ids[1]), bool)
    en[-1] = False

    def atlas():
        return jax_local_atlas(scene["geom"], scene["objects"],
                               scene["lights"], *ids, SPOT, POINT, "pcf",
                               caster_enabled=en)

    u16 = atlas()
    with taps_f32():
        f32 = atlas()
    return u16, f32


@pytest.mark.parametrize("radius", [1, 2])
def test_sun_f32_table_converts_and_samples_as_jax(scene, radius):
    """lsr_tpu's f32 PCF window table: convert leaves taps_q16 None and
    keeps the depth, which packs back into lsr_tpu's table bit for bit; the
    port's own context with its flag False has no taps either; the sun
    visibility equals lsr_tpu's exactly."""
    from lsr_tpu.lighting.shadow_sample import (
        make_shadow_context, pack_shadow_taps, shadow_visibility_dir as jvis)

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting import shadow_sample as tss

    jd, jvp, _ = jax_sun_shadow(scene["geom"], scene["objects"],
                                scene["ctx"], S, "pcf")
    with taps_f32():
        jsc = make_shadow_context(jd, jvp, pcf_radius=radius)
        tsc = convert.shadow_context(jsc, "cpu")
        own = tss.make_shadow_context(_t(jd), _t(jvp), pcf_radius=radius)
    assert jsc.depth_taps.dtype == jnp.float32
    assert tsc.taps_q16 is None and own.taps_q16 is None
    assert tsc.filter_mode == "pcf" and tsc.pcf_radius == radius
    np.testing.assert_array_equal(
        np.asarray(pack_shadow_taps(jnp.asarray(tsc.depth.numpy()), radius,
                                    int(jsc.tap_stride))),
        np.asarray(jsc.depth_taps))
    wp, ndl = np.asarray(scene["wp"]), scene["ndl"]
    jv = np.asarray(jvis(jsc, jnp.asarray(wp), jnp.asarray(ndl)))
    tv = tss.shadow_visibility_dir(tsc, _t(wp), _t(ndl)).numpy()
    assert ((jv < 1.0) & scene["covered"]).sum() >= 30
    np.testing.assert_array_equal(tv, jv)


def test_local_f32_tables_convert(atlases):
    """convert.local_shadow_maps carries lsr_tpu's f32 PCF tables as (n, S,
    S) f32 depth: each plane packs back into lsr_tpu's slot windows bit for
    bit, and quantized it is the plane convert carries from the u16
    tables."""
    from lsr_tpu.lighting.local_shadows import _TAP_STRIDE
    from lsr_tpu.lighting.shadow_sample import pack_shadow_taps

    from lsr_tpu_torch.convert import local_shadow_maps
    from lsr_tpu_torch.lighting.shadow_sample import quantize_q16

    u16, f32 = atlases
    t16, t32 = local_shadow_maps(u16, "cpu"), local_shadow_maps(f32, "cpu")
    for name, size in (("spot_taps", SPOT), ("point_taps", POINT)):
        a, b = getattr(t16, name), getattr(t32, name)
        assert a.dtype == torch.int32 and b.dtype == torch.float32
        assert b.shape == a.shape == (a.shape[0], size, size)
        assert torch.equal(quantize_q16(b), a)
        tab = np.asarray(getattr(f32, name))
        tab = tab.reshape(b.shape[0], -1, tab.shape[-1])
        for s in range(b.shape[0]):
            np.testing.assert_array_equal(
                np.asarray(pack_shadow_taps(jnp.asarray(b[s].numpy()), 2,
                                            _TAP_STRIDE)), tab[s])
    assert bool((t32.spot_taps < 1.0).any())


@pytest.mark.parametrize("vis_scale", [1, 2])
def test_local_planes_on_f32_tables_match_jax(scene, atlases, vis_scale):
    """The planes on f32 tables (convert, then the port's plain V1 / V2)
    against lsr_tpu's on its f32 tables, default cascade; the culled point
    and plane K stay 1.0; on the port's side the planes on u16 tables
    differ only where a tap sits within one quantum of its test."""
    from lsr_tpu.lighting.local_shadows import default_vis_crop
    from lsr_tpu.lighting.local_shadows import (
        local_shadow_vis_planes as jplanes)

    from lsr_tpu_torch.convert import local_shadow_maps
    from lsr_tpu_torch.lighting.local_shadows import local_shadow_vis_planes

    wp, nm = scene["wp"], scene["nm"]
    got = {}
    for name, ref in zip(("u16", "f32"), atlases):
        ref = dataclasses.replace(ref, vis_scale=vis_scale,
                                  vis_crop=default_vis_crop(H, W))
        sh = local_shadow_maps(ref, "cpu")
        got[name] = local_shadow_vis_planes(sh, _t(wp), _t(nm)).numpy()
    ref = dataclasses.replace(atlases[1], vis_scale=vis_scale,
                              vis_crop=default_vis_crop(H, W))
    with taps_f32():
        want = np.asarray(jplanes(ref, wp, nm))
    g = got["f32"]
    assert g.shape == want.shape == (11, H, W)
    assert (g[-1] == 1.0).all() and (g[-2] == 1.0).all()
    assert ((want[:-1] < 0.999) & scene["covered"]).sum() > 100
    d = np.abs(g - want)
    assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 0.03, d.max()
    assert (g == got["u16"]).mean() >= 0.999


def test_pcf_flagship_frame_on_f32_tables_matches_jax(scene):
    """bench.py's whole frame in its PCF control (cull, sun map, 8 + 2
    atlas, planes, B2 route, post; maps cut to 128^2 / 64^2 / 32^2) with
    both flags False: the port's sun context has no q16 taps and its slot
    tables are f32 depth; against lsr_tpu's frame on its f32 tables under
    C1's contract as test_torch_frame.py holds the whole frame (tids on >=
    99.5% of covered pixels, depth within 2e-3 where they agree, HDR within
    1e-4 on >= 99.5% and within 3e-3 on >= 99.9% of agreeing pixels, LDR
    within 1 LSB on >= 99.5% after FXAA)."""
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu.passes.post import fxaa_pass as jfx
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    from lsr_tpu_torch.frame import bench_config, flagship_stages
    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.tonemap import tonemap_pass
    from torch_scenes import jax_reference_cull, jax_reference_stages

    geom, objects, lights, ctx = (scene[k] for k in ("geom", "objects",
                                                     "lights", "ctx"))
    cam, ctx_t = jax_camera(3, ctx, W, H)
    cfg = bench_config("pcf", W, H)
    cfg.update(shadow_size=S, local_map=SPOT, local_point=POINT)
    cull = jax_reference_cull(geom, objects, lights, cam)
    ids = plan_shadow_casters(lights)
    en = np.asarray(cull[1].enabled)[list(ids[0]) + list(ids[1])]
    with taps_f32():
        local = jax_local_atlas(geom, objects, cull[1], *ids, SPOT, POINT,
                                "pcf", caster_enabled=en)
        ref = jax_reference_stages(
            geom, objects, lights, ctx, cam, ctx_t, W, H, shadow_size=S,
            shadow_filter="pcf", cull=cull, local=local)
        tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam,
                                             ctx_t)
        st = flagship_stages(tg, to, tl, tc, tcam, tct, W, H, **cfg)
    assert st["shadow"].taps_q16 is None
    assert st["local"].spot_taps.dtype == torch.float32
    assert st["local"].point_taps.dtype == torch.float32
    planes = st["local_vis"].permute(2, 0, 1)
    assert planes.shape == (11, H, W) and float(planes[:-1].min()) < 0.5
    tid_j, tid_t = np.asarray(ref["tid"]), st["tid"].numpy()
    same = tid_j == tid_t
    covered = max(int((tid_j >= 0).sum()), 1)
    assert covered > 0.3 * W * H
    assert (~same).sum() <= 0.005 * covered, ((~same).sum(), covered)
    d_depth = np.abs(np.asarray(ref["depth"]) - st["depth"].numpy())[same]
    assert d_depth.max() <= 2e-3, d_depth.max()
    d_hdr = np.abs(np.asarray(ref["hdr"]) - st["hdr"].numpy()).max(-1)[same]
    assert (d_hdr <= 1e-4).mean() >= 0.995, (d_hdr <= 1e-4).mean()
    assert (d_hdr <= 3e-3).mean() >= 0.999, (d_hdr <= 3e-3).mean()
    tm = tonemap_pass(st["hdr"])
    d_tm = np.abs(np.asarray(jtm(ref["hdr"])).astype(int)
                  - tm.numpy().astype(int)).max(-1)
    assert (d_tm <= 1).mean() >= 0.999, (d_tm <= 1).mean()
    d_ldr = np.abs(np.asarray(jfx(jtm(ref["hdr"]))).astype(int)
                   - fxaa_pass(tm).numpy().astype(int)).max(-1)
    assert (d_ldr <= 1).mean() >= 0.995, (d_ldr <= 1).mean()
