"""lsr_tpu_torch's sun shadow pieces vs lsr_tpu (CPU): the caster AABB and
light camera, the depth-only setup, the sun map, the ESM prefilter and the
three sampling filters, and the sun-only shading models with a shadow.

Both packages get the same procedural scene (tests/torch_scenes.py, 4
spheres + ground plane) and, for the sampling tests, the same map and
positions.  lsr_tpu runs op by op, as its own unjitted functions do; its
sun map through render_shadow_map.__wrapped__ (rasterize_direct in Pallas
interpret mode), because jit's fused arithmetic can move the light
camera's texel snap (see torch_scenes.jax_sun_shadow).  Each test states
its tolerance.
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
    jax_sun_shadow,
    to_torch,
)

W, H = 96, 64
S = 256


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t),
                t=to_torch(geom, objects, lights, ctx, cam, ctx_t))


@pytest.fixture(scope="module")
def jmap(scene):
    """lsr_tpu's 256^2 ESM sun map: (depth, light_viewproj, ShadowContext)."""
    geom, objects, _, ctx, _, _ = scene["j"]
    return jax_sun_shadow(geom, objects, ctx, S)


@pytest.fixture(scope="module")
def receivers(scene):
    """World positions and N.L of the camera view's covered pixels, from
    lsr_tpu's G-buffer (brute raster), shared by both samplers."""
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, _, ctx, cam, _ = scene["j"]
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
    return gb, np.asarray(gb.world_pos), ndl, np.asarray(gb.covered)


@pytest.mark.parametrize("grid,seed,size", [
    (2, 42, 256), (2, 42, 2048), (3, 1, 1000), (4, 7, 256), (5, 42, 2048)])
def test_light_camera_matches_jax(grid, seed, size):
    """shadow_caster_aabb exact; light view, projection and view-projection
    within 1e-6 (they are in fact bit-equal).  A texel-snap flip would move
    the projection's translation by 2 / size (>= 1e-3)."""
    from lsr_tpu.camera.light_camera import build_dir_light_camera as jcam
    from lsr_tpu.scene.scene import shadow_caster_aabb as jaabb

    from lsr_tpu_torch.camera.light_camera import build_dir_light_camera
    from lsr_tpu_torch.scene.scene import shadow_caster_aabb

    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=grid,
                                                    seed=seed)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    _, to, _, tc, _, _ = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    jmin, jmax = jaabb(objects)
    tmin, tmax = shadow_caster_aabb(to)
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    jm = jcam(jmin, jmax, ctx.light_dir_ws, size, depth_margin=10.0)
    tm = build_dir_light_camera(tmin, tmax, tc.light_dir_ws, size,
                                depth_margin=10.0)
    for name, a, b in zip(("view", "proj", "viewproj"), tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=name)


def _round_f32(x):
    """The float32 nearest the exact rational x, ties to even."""
    from fractions import Fraction

    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.uint32)) & 1))


def test_fma_rounds_once():
    """math3d.fma equals the exactly computed a * b + c rounded once to
    float32, on random triples and on sums that a float64 rounding would
    move onto a float32 midpoint (double rounding ties them the wrong
    way).  Exact: no tolerance."""
    from fractions import Fraction

    from lsr_tpu_torch.core.math3d import fma

    rng = np.random.default_rng(3)
    a = rng.normal(size=2000).astype(np.float32)
    b = rng.normal(size=2000).astype(np.float32)
    c = (-a * b * rng.uniform(0.5, 1.5, 2000)).astype(np.float32)
    one, e23 = np.float32(1.0), np.float32(2.0 ** -23)
    tricky = [(one + e23, np.float32(2.0 ** -24 - 2.0 ** -47), one + e23),
              (one + e23, np.float32(-(2.0 ** -24 - 2.0 ** -47)), one + e23),
              (one + e23, np.float32(2.0 ** -25 - 2.0 ** -48), one)]
    a = np.concatenate([a, [t[0] for t in tricky]]).astype(np.float32)
    b = np.concatenate([b, [t[1] for t in tricky]]).astype(np.float32)
    c = np.concatenate([c, [t[2] for t in tricky]]).astype(np.float32)
    got = fma(torch.as_tensor(a), torch.as_tensor(b),
              torch.as_tensor(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).any()     # the tricky triples do need round-to-odd


def test_shadow_caster_aabb_falls_back_to_unit_box(scene):
    """No visible caster: the unit box [-1, 1]^3, as lsr_tpu."""
    from lsr_tpu.scene.scene import shadow_caster_aabb as jaabb

    from lsr_tpu_torch.scene.scene import shadow_caster_aabb

    _, objects, _, _, _, _ = scene["j"]
    _, to, _, _, _, _ = scene["t"]
    jo = dataclasses.replace(objects, casts_shadow=jnp.zeros_like(
        objects.casts_shadow))
    to = dataclasses.replace(to, casts_shadow=torch.zeros_like(
        to.casts_shadow))
    for a, b in zip(shadow_caster_aabb(to), jaabb(jo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert np.abs(a.numpy()).tolist() == [1.0, 1.0, 1.0]


def test_scene_setup_depth_matches_jax(scene, jmap):
    """On lsr_tpu's light view-projection: every TriSetup field equal bit
    for bit (both packages compute the clip transform with the same
    explicit multiply-adds and no FMA), wp / nw / uv zero-width."""
    from lsr_tpu.raster.setup import CULL_NONE, scene_setup_depth as jsetup

    from lsr_tpu_torch.raster.setup import scene_setup_depth

    geom, objects, _, _, _, _ = scene["j"]
    tg, to, _, _, _, _ = scene["t"]
    _, light_vp, _ = jmap
    mask = objects.casts_shadow & objects.visible
    js = jsetup(geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
                objects.model, light_vp, S, S, cull_mode=CULL_NONE,
                obj_visible=mask)
    ts = scene_setup_depth(tg.positions, tg.indices, tg.vtx_obj, tg.tri_obj,
                           to.model, _t(light_vp), S, S,
                           obj_visible=to.casts_shadow & to.visible)
    for f in ("coef", "iw", "ziw", "bbox", "valid", "obj_id"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("wp", "nw", "uv"):
        assert getattr(ts, f).shape[-1] == 0, f
    assert int(ts.valid.sum()) > 0


def test_render_shadow_map_matches_jax(scene, jmap):
    """256^2 sun map: the same light view-projection; depth01 within B1's
    stated contract on the same setup (2e-5, ROADMAP C1: XLA:CPU fuses the
    edge functions into FMAs) on the texels both cover, and coverage equal
    on all but 0.2% of covered texels (triangle edges)."""
    from lsr_tpu_torch.passes.shadow import render_shadow_map

    tg, to, _, tc, _, _ = scene["t"]
    jd, jvp, _ = jmap
    td, tvp = render_shadow_map(tg, to, tc.light_dir_ws, map_size=S)
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp))
    jd, td = np.asarray(jd), td.numpy()
    jc, tcov = jd < 1.0, td < 1.0
    assert jc.sum() > 0.05 * S * S
    assert (jc != tcov).sum() <= 0.002 * jc.sum(), (jc != tcov).sum()
    both = jc & tcov
    assert np.abs(jd - td)[both].max() <= 2e-5


def test_prefilter_esm_matches_jax(jmap):
    """On the same map: the ESM soft map within 2e-6, and its q16 plane
    (lsr_tpu's pack_soft_u16 unpacked) equal on >= 99.9% of texels and
    within one quantum everywhere (exp / log differ by an ulp between
    XLA:CPU and torch)."""
    from lsr_tpu.lighting.shadow_sample import (
        pack_soft_u16, prefilter_esm as jpre)

    from lsr_tpu_torch.lighting.shadow_sample import (
        prefilter_esm, quantize_q16)

    jd = jmap[0]
    jsoft = np.asarray(jpre(jd, 2, 80.0))
    tsoft = prefilter_esm(_t(jd), 2, 80.0)
    assert np.abs(tsoft.numpy() - jsoft).max() <= 2e-6
    packed = np.asarray(pack_soft_u16(jpre(jd, 2, 80.0)))
    jq = np.stack([packed & 0xFFFF, packed >> 16], -1).reshape(S, S)
    d = np.abs(quantize_q16(tsoft).numpy().astype(np.int64) - jq)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                        (d == 0).mean())


@pytest.mark.parametrize("mode,radius,step", [
    ("pcf", 0, 1), ("pcf", 2, 1), ("pcf", 2, 2), ("esm", 2, 1)])
def test_shadow_visibility_matches_jax(jmap, receivers, mode, radius, step):
    """shadow_visibility_dir on the same map, light camera and receivers,
    with lsr_tpu's context carried over by convert.shadow_context (its u16
    tap windows or soft-map pairs unpacked into the q16 plane): hard, PCF
    (u16 taps) and strided PCF give the same tap counts exactly; ESM within
    1.3e-3 (one q16 quantum of the soft map is exp(80 / 65535) - 1)."""
    from lsr_tpu.lighting.shadow_sample import (
        make_shadow_context, shadow_visibility_dir as jvis)

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.shadow_sample import shadow_visibility_dir

    jd, jvp, _ = jmap
    _, wp, ndl, cov = receivers
    jsc = make_shadow_context(jd, jvp, pcf_radius=radius, pcf_step=step,
                              filter_mode=mode)
    tsc = convert.shadow_context(jsc, "cpu")
    jv = np.asarray(jvis(jsc, jnp.asarray(wp), jnp.asarray(ndl)))
    tv = shadow_visibility_dir(tsc, _t(wp), _t(ndl)).numpy()
    shadowed = (jv < 1.0) & cov
    assert shadowed.sum() >= 30            # the map does shadow the view
    if mode == "esm":
        assert np.abs(tv - jv).max() <= 1.3e-3
    else:
        np.testing.assert_array_equal(tv, jv)


def test_convert_pcf_taps_are_the_q16_depth(jmap):
    """lsr_tpu's u16 PCF window table, unpacked by convert.shadow_context,
    is the q16 plane of the map itself (window assembly is data movement)."""
    from lsr_tpu.lighting.shadow_sample import make_shadow_context

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.shadow_sample import quantize_q16

    jd, jvp, _ = jmap
    tsc = convert.shadow_context(make_shadow_context(jd, jvp, pcf_radius=2),
                                 "cpu")
    np.testing.assert_array_equal(tsc.taps_q16.numpy(),
                                  quantize_q16(_t(jd)).numpy())


@pytest.mark.parametrize("model", ["blinn_phong", "pbr_mr"])
def test_sun_models_with_shadow_match_jax(scene, jmap, receivers, model):
    """The sun-only shading models with a PCF sun shadow (render_forward's
    models): within 1e-4 of lsr_tpu's on covered pixels (the visibility
    counts are equal; the rest is the shade tests' f32 rounding)."""
    from lsr_tpu.lighting.shadow_sample import make_shadow_context
    from lsr_tpu.shading.models import SHADING_MODELS as JM

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.raster.interp import GBuffer
    from lsr_tpu_torch.shading.models import SHADING_MODELS

    _, _, _, _, _, ctx_t = scene["j"]
    _, _, _, tctx, _, _ = scene["t"]
    jd, jvp, _ = jmap
    gb, _, _, cov = receivers
    jsc = make_shadow_context(jd, jvp, pcf_radius=2)
    jctx = dataclasses.replace(ctx_t, shadow=jsc)
    tctx = dataclasses.replace(
        tctx, camera_pos=_t(ctx_t.camera_pos),
        shadow=convert.shadow_context(jsc, "cpu"))
    tgb = GBuffer(**{f.name: (None if getattr(gb, f.name, None) is None
                              else _t(getattr(gb, f.name)))
                     for f in dataclasses.fields(GBuffer)})
    j = np.asarray(JM[model](gb, jctx))
    t = SHADING_MODELS[model](tgb, tctx).numpy()
    plain = np.asarray(JM[model](gb, ctx_t))
    assert np.abs(j - plain)[cov].max() > 0.05     # the shadow shows
    assert np.abs(t - j)[cov].max() <= 1e-4
