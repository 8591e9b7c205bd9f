"""lsr_tpu_torch's general (non-fused) lighting vs lsr_tpu (CPU): the
nine stylized and debug shading models, Gouraud, the IBL ambient of
pbr_mr / blinn_phong, accumulate_local_lights (tiled and clustered, with
local-shadow planes), shade_forward_plus's general branch in each mode
(and its fused branch with surface maps and environment probes), on the
same inputs: lsr_tpu's G-buffer of the grid-2 flagship stand-in at 128x96
(tests/torch_scenes.py), converted field for field.

Tolerances: a shading model on the same G-buffer within 1e-5;
accumulate_local_lights within 1e-4 (it sums up to 128 lights a pixel in
chunks; XLA:CPU fuses multiply-adds, torch does not); a shaded frame from
the same G-buffer within 1e-4 on >= 99.9% of pixels and finite.  The JAX
side of a fused-branch comparison runs kernel B2 in Pallas interpret mode,
as lsr_tpu's own CPU tests do; the port runs B2's plain version.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu_torch import convert
from torch_scenes import (
    jax_camera,
    jax_flagship_scene,
    jax_local_atlas,
    jax_sun_shadow,
    to_torch,
    torch_gbuffer,
    torch_setup,
)

W, H = 128, 96
MODELS = ("flat", "lambert", "phong", "toon", "gooch", "oren_nayar",
          "debug_albedo", "debug_normal", "debug_depth")


def _ibl_maps():
    """Small IBL maps baked by lsr_tpu from its procedural sky."""
    from lsr_tpu.resources.ibl import (
        compute_irradiance_map, compute_prefiltered_specular)
    from lsr_tpu.sky.sky_models import procedural_sky_cubemap

    cube = procedural_sky_cubemap(16, sun_dir_ws=jnp.asarray(
        (0.35, -0.75, 0.45), jnp.float32))
    return (compute_irradiance_map(cube, out_size=4, samples=64),
            tuple(compute_prefiltered_specular(cube, out_size=8, samples=32,
                                               mips=3)))


@pytest.fixture(scope="module")
def scene():
    """The grid-2 scene on both sides, lsr_tpu's setup and G-buffer, its
    sun shadow context (128^2, PCF) and its local atlas (32^2 slots and
    faces), each converted."""
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    _, _, sc = jax_sun_shadow(geom, objects, ctx_t, 128, "pcf")
    spot_ids, point_ids = plan_shadow_casters(lights)
    local = jax_local_atlas(geom, objects, lights, spot_ids, point_ids, 32,
                            32, "pcf")
    t = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t), t=t, setup=setup,
                depth=depth, tid=tid, gb=gb, tgb=torch_gbuffer(gb), sc=sc,
                tsc=convert.shadow_context(sc, "cpu"), local=local,
                tlocal=convert.local_shadow_maps(local, "cpu"))


def _close(got, want, tol, frac=1.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= tol).mean() >= frac, (float(err.max()),
                                         float((err <= tol).mean()))


@pytest.mark.parametrize("model", MODELS)
def test_shading_model_matches_jax(scene, model):
    """Each stylized and debug model on the same G-buffer and context,
    within 1e-5 on covered pixels (the models shade covered pixels; the
    caller composites the background)."""
    from lsr_tpu.shading.models import SHADING_MODELS as J
    from lsr_tpu_torch.shading.models import SHADING_MODELS as T

    ctx_t, tct = scene["j"][5], scene["t"][5]
    cov = np.asarray(scene["gb"].covered)
    want = np.asarray(J[model](scene["gb"], ctx_t))
    got = T[model](scene["tgb"], tct).numpy()
    _close(got[cov], want[cov], 1e-5)


def test_gouraud_matches_jax(scene):
    """Vertex lighting at the winning triangle's corners on the same setup
    and G-buffer, within 1e-5 on covered pixels."""
    from lsr_tpu.shading.models import shade_gouraud as jg
    from lsr_tpu_torch.shading.models import shade_gouraud as tg

    cov = np.asarray(scene["gb"].covered)
    want = np.asarray(jg(scene["setup"], scene["gb"], scene["j"][5]))
    got = tg(torch_setup(scene["setup"]), scene["tgb"], scene["t"][5]).numpy()
    _close(got[cov], want[cov], 1e-5)


@pytest.mark.parametrize("model", ["pbr_mr", "blinn_phong"])
def test_ibl_ambient_matches_jax(scene, model):
    """pbr_mr / blinn_phong with real IBL maps in the context (the ambient
    is eval_ibl's), with the sun shadow: within 1e-5 on >= 99.9% of
    covered pixels and 1e-3 on all.  A reflection vector on a cube edge
    picks its face by a comparison that one ULP of the vector (XLA:CPU's
    fused multiply-adds) can flip; the faces' edge texels differ by up to
    ~1e-4 on these maps."""
    from lsr_tpu.shading.models import SHADING_MODELS as J
    from lsr_tpu_torch.shading.models import SHADING_MODELS as T

    maps = _ibl_maps()
    jctx = dataclasses.replace(scene["j"][5], ibl=maps, shadow=scene["sc"])
    tctx = dataclasses.replace(scene["t"][5], ibl=convert.ibl(maps, "cpu"),
                               shadow=scene["tsc"])
    cov = np.asarray(scene["gb"].covered)
    want = np.asarray(J[model](scene["gb"], jctx))
    got = T[model](scene["tgb"], tctx).numpy()
    _close(got[cov], want[cov], 1e-5, 0.999)
    _close(got[cov], want[cov], 1e-3)
    plain = T[model](scene["tgb"], scene["t"][5]).numpy()
    assert np.abs(got - plain)[cov].max() > 1e-3       # the maps are read


@pytest.mark.parametrize("binning", ["tiled", "clustered"])
def test_accumulate_local_lights_matches_jax(scene, binning):
    """The binned light sum over the framebuffer (tile 16, cap 16, chunk
    8; clustered with 8 slices), diffuse and specular within 1e-4, without
    and with the local-shadow planes.

    lsr_tpu's clustered form with planes raises NameError (its take_rows is
    imported only on the tiled path; ROADMAP C16).  The port's clustered
    form with planes is held to lsr_tpu's tiled form with planes instead,
    on the pixels where lsr_tpu's two binnings give the same planeless sum
    (within 1e-4; >= 99.9% of pixels): there the same lights reach the
    pixel, each scaled by its own plane."""
    from lsr_tpu.lighting.light_culling import (
        cull_lights_clustered as jcl, cull_lights_tiled as jct,
        view_depth_to_cluster_slice as jslice)
    from lsr_tpu.lighting.light_runtime import accumulate_local_lights as jacc
    from lsr_tpu.lighting.local_shadows import local_shadow_vis_stack as jvis
    from lsr_tpu.shading.models import _norm

    from lsr_tpu_torch.lighting.light_runtime import (
        accumulate_local_lights as tacc)

    _, _, lights, _, cam, ctx_t = scene["j"]
    _, _, tl, _, _, tct = scene["t"]
    gb, tgb = scene["gb"], scene["tgb"]
    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    I = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64))  # noqa: E731
    base = (gb.world_pos, gb.normal_ws, ctx_t.camera_pos, lights)
    tbase = (tgb.world_pos, tgb.normal_ws, tct.camera_pos, tl)
    vis = jvis(scene["local"], gb.world_pos, _norm(gb.normal_ws))
    idx = scene["local"].light_shadow_index
    pk = dict(shadow_vis_stack=vis, light_shadow_index=idx)
    tpk = dict(shadow_vis_stack=T(vis), light_shadow_index=I(idx))
    tiled, _, _ = jct(lights, cam.view, cam.proj, W, H, tile_size=16, cap=16)
    if binning == "tiled":
        lists, kw, kw_t = tiled, {}, {}
    else:
        lists, _, _ = jcl(lights, cam.view, cam.proj, cam.zn, cam.zf, W, H,
                          tile_size=16, cap=16, slices=8)
        cl = jslice(cam.zn + gb.depth01 * (cam.zf - cam.zn), cam.zn, cam.zf,
                    8)
        kw = dict(cluster_of_pixel=cl, slices=8)
        kw_t = dict(cluster_of_pixel=I(cl), slices=8)
    # Planeless, against lsr_tpu's own binning.
    jd0, js0 = jacc(*base, lists, W, H, tile_size=16, chunk=8, **kw)
    td0, ts0 = tacc(*tbase, I(lists), W, H, tile_size=16, chunk=8, **kw_t)
    _close(td0, jd0, 1e-4)
    _close(ts0, js0, 1e-4)
    # With the planes.
    td, ts = tacc(*tbase, I(lists), W, H, tile_size=16, chunk=8, **kw_t,
                  **tpk)
    jd, js = jacc(*base, tiled, W, H, tile_size=16, chunk=8, **pk)
    same = np.ones((H, W), bool)
    if binning == "clustered":
        jt0, st0 = jacc(*base, tiled, W, H, tile_size=16, chunk=8)
        same = ((np.abs(np.asarray(jt0) - np.asarray(jd0)).max(-1) <= 1e-4)
                & (np.abs(np.asarray(st0) - np.asarray(js0)).max(-1) <= 1e-4))
        assert same.mean() >= 0.999
    _close(td.numpy()[same], np.asarray(jd)[same], 1e-4)
    _close(ts.numpy()[same], np.asarray(js)[same], 1e-4)
    assert float(td.max()) > 0.1                    # lights reach the frame
    # The planes only take light away, and they do take some.
    assert float((td0 - td).min()) >= -1e-6 and float((td0 - td).max()) > 0


@pytest.mark.parametrize("mode", ["tiled", "tiled_depth_range", "clustered"])
def test_general_branch_matches_jax(scene, mode):
    """shade_forward_plus with use_kernel=False (the sun by pbr_mr with the
    sun shadow, the local lights binned per 16x16 tile or cluster with the
    local-shadow planes, accumulate_local_lights) from the same G-buffer:
    HDR within 1e-4 on >= 99.9% of pixels.  Clustered without the planes:
    lsr_tpu's raises with them (ROADMAP C16)."""
    from lsr_tpu.passes.forward_plus import shade_forward_plus as jsh
    from lsr_tpu_torch.passes.forward_plus import shade_forward_plus as tsh

    _, _, lights, _, cam, ctx_t = scene["j"]
    _, _, tl, _, tcam, tct = scene["t"]
    kw = dict(tile_size=16, cap=32, mode=mode, slices=8, use_kernel=False)
    planes = mode != "clustered"
    want, jst = jsh(scene["gb"], dataclasses.replace(ctx_t, shadow=scene["sc"]),
                    lights, cam.view, cam.proj, cam.zn, cam.zf, W, H,
                    local_shadows=scene["local"] if planes else None, **kw)
    got, tst = tsh(scene["tgb"], dataclasses.replace(tct, shadow=scene["tsc"]),
                   tl, tcam.view, tcam.proj, tcam.zn, tcam.zf, W, H,
                   local_shadows=scene["tlocal"] if planes else None, **kw)
    _close(got.numpy(), want, 1e-4, 0.999)
    assert int(tst["max_lights_per_bin"]) == int(jst["max_lights_per_bin"])
    assert int(tst["total_bins"]) == int(jst["total_bins"])


def _surface_ctx(jctx):
    """jctx with a texture array of (checker, bump normal map, ORM map,
    emissive map) and materials that use them: material 0 the normal map,
    1 the ORM map, 2 all three, 3 none."""
    from lsr_tpu.shading.common import (
        bump_normal_texture, checkerboard_texture, make_materials)
    from lsr_tpu.shading.models import make_shade_context

    from lsr_tpu_torch.shading.common import bump_normal_texture as tbump

    np.testing.assert_array_equal(tbump(32), bump_normal_texture(32))
    rng = np.random.default_rng(17)
    tex = np.stack([checkerboard_texture(32), bump_normal_texture(32),
                    rng.uniform(0.2, 1.0, (32, 32, 3)).astype(np.float32),
                    rng.uniform(0.0, 2.0, (32, 32, 3)).astype(np.float32)])
    m = jctx.materials
    mats = make_materials(
        base_color=np.asarray(m.base_color), metallic=np.asarray(m.metallic),
        roughness=np.asarray(m.roughness),
        emissive=np.full((5, 3), 0.05, np.float32),
        tex_id=[-1, -1, -1, -1, 0], normal_tex=[1, -1, 1, -1, 1],
        orm_tex=[-1, 2, 2, -1, -1], emissive_tex=[-1, -1, 3, -1, -1])
    return make_shade_context(
        mats, light_dir_ws=jctx.light_dir_ws, light_color=jctx.light_color,
        light_intensity=jctx.light_intensity, camera_pos=jctx.camera_pos,
        textures=jnp.asarray(tex))


@pytest.mark.parametrize("branch", ["fused", "general"])
def test_surface_maps_and_env_probes_match_jax(scene, branch):
    """Normal, ORM and emissive maps and two environment probes on both
    branches of shade_forward_plus, with real IBL maps, from the same
    G-buffer (its tangents): HDR within 1e-4 on >= 99.9% of pixels; the
    maps and the probes change the frame."""
    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.passes.forward_plus import shade_forward_plus as jsh
    from lsr_tpu_torch.passes.forward_plus import shade_forward_plus as tsh

    from lsr_tpu.raster.interp import interpolate_gbuffer

    _, _, lights, _, cam, ctx_t = scene["j"]
    _, _, _, _, tcam, tct = scene["t"]
    jctx = dataclasses.replace(_surface_ctx(ctx_t), ibl=_ibl_maps())
    assert jctx.surface_maps
    tctx = convert.shade_context(jctx, convert.materials_soa(
        jctx.materials, "cpu"), "cpu")
    assert tctx.surface_maps and tctx.ibl is not None
    # The scene's lights plus two probes.
    lb = LightSetBuilder()
    cols = {k: np.asarray(getattr(lights, k)) for k in (
        "position", "color", "intensity", "range")}
    for i in range(int(lights.type.shape[0])):
        lb.point(tuple(cols["position"][i].tolist()),
                 color=tuple(cols["color"][i].tolist()),
                 intensity=float(cols["intensity"][i]),
                 range=float(cols["range"][i]))
    lb.env_probe((0.0, 0.0, 0.0), color=(2.0, 1.5, 1.0), intensity=1.5,
                 range=3.0)
    lb.env_probe((1.5, 0.5, -1.0), color=(0.5, 1.0, 2.0), intensity=1.0,
                 range=2.0)
    jl = lb.build()
    tl = convert.lights_soa(jl, "cpu")
    # The G-buffer's material record carries the texture slots.
    gb = interpolate_gbuffer(scene["setup"], scene["depth"], scene["tid"],
                             materials=jctx.materials)
    tgb = torch_gbuffer(gb)
    kw = dict(tile_size=16, cap=32, mode="tiled",
              use_kernel=branch == "fused")
    args_j = (gb, jctx, jl, cam.view, cam.proj, cam.zn, cam.zf, W, H)
    args_t = (tgb, tctx, tl, tcam.view, tcam.proj, tcam.zn, tcam.zf, W, H)
    want, _ = jsh(*args_j, env_probes=True, **kw)
    got, _ = tsh(*args_t, env_probes=True, **kw)
    _close(got.numpy(), want, 1e-4, 0.999)
    # The maps and the probes each change the frame.
    cov = np.asarray(gb.covered)
    no_probes, _ = tsh(*args_t, **kw)
    no_maps, _ = tsh(scene["tgb"], dataclasses.replace(tct, ibl=tctx.ibl),
                     tl, *args_t[3:], env_probes=True, **kw)
    for other in (no_probes, no_maps):
        assert np.abs(got.numpy() - other.numpy())[cov].max() > 1e-2


def test_light_runtime_helpers_match_jax(scene):
    """The accumulation's helpers are data movement and equal bit for bit:
    unpack_light_records (with a live mask), _gather_light_columns on
    -1-padded indices, _to_tiles / _from_tiles (a frame that is not a
    whole number of tiles, round trip), combine_local_light."""
    from lsr_tpu.lighting import light_runtime as jr
    from lsr_tpu_torch.lighting import light_runtime as tr

    lights, tl = scene["j"][2], scene["t"][2]
    rec = np.asarray(jr.pack_light_records(lights))
    live = np.arange(rec.shape[0]) % 3 != 0
    want = jr.unpack_light_records(jnp.asarray(rec), jnp.asarray(live))
    got = tr.unpack_light_records(torch.as_tensor(rec), torch.as_tensor(live))
    idx = np.array([[3, -1, 0], [15, 2, -1]], np.int32)
    want_g = jr._gather_light_columns(lights, jnp.asarray(idx))
    got_g = tr._gather_light_columns(tl, torch.as_tensor(idx.astype(np.int64)))
    for w, g in ((want, got), (want_g, got_g)):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)
    x = np.random.default_rng(4).normal(size=(37, 50, 3)).astype(np.float32)
    jt = jr._to_tiles(jnp.asarray(x), 16, 3, 4)
    tt = tr._to_tiles(torch.as_tensor(x), 16, 3, 4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tr._from_tiles(tt, 16, 3, 4, 37, 50).numpy(),
                                  x)
    a, d, s = (np.random.default_rng(k).uniform(size=(4, 5, 3)).astype(
        np.float32) for k in (1, 2, 3))
    np.testing.assert_array_equal(
        tr.combine_local_light(*(torch.as_tensor(v) for v in (a, d, s))).numpy(),
        np.asarray(jr.combine_local_light(a, d, s)))
