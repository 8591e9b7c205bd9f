"""The flagship frame, lsr_tpu_torch vs lsr_tpu (CPU): the cut frame (B2
route, sun map, no cull or local atlas) and bench.py's whole frame
(cull, local atlas, planes; both routes, both filters, all atlas
strategies), and the rule that the port's entry points run on the card.

lsr_tpu_torch.frame.make_flagship_frame (plain versions on CPU tensors)
against lsr_tpu's own stages composed the same way (bench.py:179-288 with
the ESM sun map and no scene culling or local atlas; the sun map op by op,
rasterize_direct and shade_fused_pallas in Pallas interpret mode), on the
same procedural scene, lights, materials, texture and camera.  128x96, a
128^2 sun map, 4 spheres + ground plane, 16 lights.

Tolerances: each package builds its own triangle setup, and XLA:CPU fuses
the JAX package's multiply-adds into FMAs where torch rounds twice.  The
edge functions of these sub-pixel triangles are ill-conditioned in f32, so
depth01 may differ by up to 2e-3 and a winning triangle may flip on edge or
tie pixels (<= 0.5% allowed).  Where both pick the same triangle, HDR
agrees within 1e-4 on >= 99.9% of pixels and within 2e-3 everywhere (GGX
highlight peaks, see test_torch_shade.py; an ESM soft-map quantum moves the
sun visibility by at most 1.2e-3); LDR after tonemap + FXAA agrees within 1
LSB on >= 99.9% of pixels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_scenes import (
    jax_camera,
    jax_flagship_scene,
    jax_reference_stages,
    to_torch,
)

W, H = 128, 96
S = 128
CUT = dict(with_cull=False, with_local=False)   # no cull, no local atlas


@pytest.fixture(scope="module")
def jax_scene():
    return jax_flagship_scene(n_lights=16, grid=2)


@pytest.fixture(scope="module", params=[0, 9])
def rendered(request, jax_scene):
    """(JAX reference stages + LDR, port stages + frame outputs) for orbit
    frame i of the bench camera."""
    from lsr_tpu.passes.post import fxaa_pass as jfx
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    from lsr_tpu_torch.frame import flagship_stages, make_flagship_frame

    geom, objects, lights, ctx = jax_scene
    cam, ctx_t = jax_camera(request.param, ctx, W, H)
    ref = jax_reference_stages(geom, objects, lights, ctx, cam, ctx_t, W, H,
                               shadow_size=S)
    ref["ldr"] = np.asarray(jfx(jtm(ref["hdr"])))
    tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    out = make_flagship_frame(tg, to, tl, tc, W, H, shadow_size=S,
                              **CUT)(tcam, tct)
    st = flagship_stages(tg, to, tl, tc, tcam, tct, W, H, shadow_size=S,
                         **CUT)
    return ref, st, out


def test_frame_hdr_and_ldr_match_jax(rendered):
    ref, st, out = rendered
    np.testing.assert_array_equal(st["light_viewproj"].numpy(),
                                  np.asarray(ref["light_viewproj"]))
    assert float(st["sun_vis"].min()) < 0.5           # the sun map shadows
    tid_j, tid_t = np.asarray(ref["tid"]), st["tid"].numpy()
    same = tid_j == tid_t
    covered = max(int((tid_j >= 0).sum()), 1)
    assert (~same).sum() <= 0.005 * covered, ((~same).sum(), covered)
    assert covered > 0.3 * W * H
    d_depth = np.abs(np.asarray(ref["depth"]) - st["depth"].numpy())[same]
    assert d_depth.max() <= 2e-3, d_depth.max()

    d_hdr = np.abs(np.asarray(ref["hdr"]) - st["hdr"].numpy()).max(-1)[same]
    assert (d_hdr <= 1e-4).mean() >= 0.999, (d_hdr <= 1e-4).mean()
    assert d_hdr.max() <= 2e-3, d_hdr.max()

    ldr = out[0].numpy()
    assert ldr.shape == (H, W, 3) and ldr.dtype == np.uint8
    d_ldr = np.abs(ref["ldr"].astype(int) - ldr.astype(int)).max(-1)
    assert (d_ldr <= 1).mean() >= 0.999, (d_ldr <= 1).mean()


def test_frame_stats_match_jax(rendered):
    """n_valid, max supers per tile, max lights per bin and overflowing
    bins: the same integers."""
    ref, _, out = rendered
    _, n_valid, max_sup, max_lights, overflow = out
    assert int(n_valid) == int(np.asarray(ref["setup"].valid).sum())
    assert int(max_sup) == int(ref["max_sup"])
    assert int(max_lights) == int(ref["stats"]["max_lights_per_bin"])
    assert int(overflow) == int(ref["stats"]["overflow_bins"])


def test_frame_is_deterministic(jax_scene):
    """Two calls of the frame on the same camera give identical bytes."""
    from lsr_tpu_torch.frame import make_flagship_frame

    geom, objects, lights, ctx = jax_scene
    cam, ctx_t = jax_camera(3, ctx, W, H)
    tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    frame = make_flagship_frame(tg, to, tl, tc, W, H, shadow_size=S, **CUT)
    a = frame(tcam, tct)[0]
    b = frame(tcam, tct)[0]
    assert (a == b).all()


# ---------------------------------------------------------------------------
# The whole frame: per-frame cull, local shadow atlas, planes (bench.py's
# with_cull=True, with_local=True)
# ---------------------------------------------------------------------------

LOCAL_SPOT, LOCAL_POINT = 64, 32


def _whole_config(shadow_filter):
    """bench.py main()'s configuration (frame.bench_config) with the maps
    cut to the test's size: sun 128^2, spot slots 64^2, cube faces 32^2."""
    from lsr_tpu_torch.frame import bench_config

    cfg = bench_config(shadow_filter, W, H)
    cfg.update(shadow_size=S, local_map=LOCAL_SPOT, local_point=LOCAL_POINT)
    return cfg


@pytest.fixture(scope="module")
def whole_view(jax_scene):
    """Orbit frame 3: lsr_tpu's per-frame cull and its camera raster of the
    culled objects (op by op), shared by both filters and routes."""
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct

    from torch_scenes import jax_reference_cull

    geom, objects, lights, ctx = jax_scene
    cam, ctx_t = jax_camera(3, ctx, W, H)
    cull = jax_reference_cull(geom, objects, lights, cam)
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, cam.viewproj, W, H,
        obj_visible=cull[0].visible)
    raster = (setup,) + tuple(rasterize_direct(setup, W, H, cam.zn, cam.zf,
                                               spatial_sort=True))
    return cam, ctx_t, cull, raster


@pytest.fixture(scope="module", params=["esm", "pcf"])
def whole(request, jax_scene, whole_view):
    """lsr_tpu's whole frame on both routes (its sun map and atlas shared)
    and the port's stages, frames on the "map" atlas."""
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu.passes.post import fxaa_pass as jfx
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    from lsr_tpu_torch.frame import flagship_stages
    from torch_scenes import jax_local_atlas, jax_sun_shadow

    cfg = _whole_config(request.param)
    geom, objects, lights, ctx = jax_scene
    cam, ctx_t, cull, raster = whole_view
    ids = plan_shadow_casters(lights)
    en = np.asarray(cull[1].enabled)[list(ids[0]) + list(ids[1])]
    local = jax_local_atlas(geom, objects, cull[1], *ids, LOCAL_SPOT,
                            LOCAL_POINT, request.param,
                            vis_scale=cfg["vis_scale"], caster_enabled=en)
    sun = jax_sun_shadow(geom, objects, ctx_t, S, request.param)
    tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam,
                                         ctx_t)
    out = {}
    for route in (False, True):
        ref = jax_reference_stages(
            geom, objects, lights, ctx, cam, ctx_t, W, H, shadow_size=S,
            use_resolve=route, shadow_filter=request.param,
            sun_vis_scale=cfg["sun_vis_scale"], cull=cull, local=local,
            sun=sun, raster=raster)
        ref["ldr"] = np.asarray(jfx(jtm(ref["hdr"])))
        st = flagship_stages(tg, to, tl, tc, tcam, tct, W, H,
                             use_resolve=route, **cfg)
        out[route] = (ref, st)
    return request.param, cull, en, out, (tg, to, tl, tc, tcam, tct, cfg)


def test_whole_frame_cull_matches_jax(whole):
    """The culled object and light masks and the casters' enable mask are
    lsr_tpu's; the occluder depth follows C1 (as test_torch_cull)."""
    _, cull, en, out, _ = whole
    st = out[False][1]
    np.testing.assert_array_equal(st["obj_visible"].numpy(),
                                  np.asarray(cull[0].visible))
    np.testing.assert_array_equal(st["light_enabled"].numpy(),
                                  np.asarray(cull[1].enabled))
    np.testing.assert_array_equal(st["local"].caster_enabled.numpy(), en)
    occ_w, occ_g = np.asarray(cull[2]), st["occ_depth"].numpy()
    cov = occ_w < 1.0
    assert ((occ_g < 1.0) != cov).sum() <= 0.005 * cov.sum()


@pytest.mark.parametrize("route", ["b2", "resolve"])
def test_whole_frame_matches_jax(whole, route):
    """bench.py's whole frame (cull, sun map, 8 + 2 local atlas, planes,
    B2 or B5, post) against lsr_tpu's, under C1's frame contract: tids on
    >= 99.5% of covered pixels, depth within 2e-3 where they agree, HDR
    within 1e-4 on >= 99.5% of agreeing pixels and within 3e-3 on >= 99.9%
    (ESM visibility, sun and local, may differ by one soft-map quantum,
    1.3e-3, times a light term; a PCF plane by one tap of 25, 0.72 / 25,
    where a projection rounded with a fused multiply-add picks the
    neighbouring texel), LDR within 1 LSB on >= 99.9% of pixels after the
    tonemap and on >= 99.5% after FXAA, whose luma decisions can amplify a
    1-LSB difference (chip_smoke.py's small reference holds the same).
    The local planes shadow some pixels."""
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.tonemap import tonemap_pass

    mode, _, _, out, _ = whole
    ref, st = out[route == "resolve"]
    tm = tonemap_pass(st["hdr"])
    ldr = fxaa_pass(tm).numpy()
    planes = st["local_vis"]
    if route == "b2":
        planes = planes.permute(2, 0, 1)
    assert planes.shape == (11, H, W)
    assert float(planes[:-1].min()) < 0.5 and (planes[-1] == 1.0).all()
    tid_j, tid_t = np.asarray(ref["tid"]), st["tid"].numpy()
    same = tid_j == tid_t
    covered = max(int((tid_j >= 0).sum()), 1)
    assert covered > 0.3 * W * H
    assert (~same).sum() <= 0.005 * covered, ((~same).sum(), covered)
    d_depth = np.abs(np.asarray(ref["depth"]) - st["depth"].numpy())[same]
    assert d_depth.max() <= 2e-3, d_depth.max()
    d_hdr = np.abs(np.asarray(ref["hdr"]) - st["hdr"].numpy()).max(-1)[same]
    assert (d_hdr <= 1e-4).mean() >= 0.995, (mode, (d_hdr <= 1e-4).mean())
    assert (d_hdr <= 3e-3).mean() >= 0.999, (mode, (d_hdr <= 3e-3).mean())
    assert ldr.shape == (H, W, 3) and ldr.dtype == np.uint8
    d_tm = np.abs(np.asarray(jtm(ref["hdr"])).astype(int)
                  - tm.numpy().astype(int)).max(-1)
    assert (d_tm <= 1).mean() >= 0.999, (mode, (d_tm <= 1).mean())
    d_ldr = np.abs(ref["ldr"].astype(int) - ldr.astype(int)).max(-1)
    assert (d_ldr <= 1).mean() >= 0.995, (mode, (d_ldr <= 1).mean())


def test_whole_frame_atlas_strategies_agree(whole):
    """make_flagship_frame with the "packed" atlas (one banded B1 launch a
    stack) gives the bytes of the "map" stages, tonemapped and FXAA'd."""
    from lsr_tpu_torch.frame import make_flagship_frame
    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.tonemap import tonemap_pass

    _, _, _, out, (tg, to, tl, tc, tcam, tct, cfg) = whole
    ldr = make_flagship_frame(tg, to, tl, tc, W, H, atlas_packed=True,
                              **cfg)(tcam, tct)[0]
    np.testing.assert_array_equal(
        ldr.numpy(), fxaa_pass(tonemap_pass(out[False][1]["hdr"])).numpy())


def _entry_points():
    """(name, call(device)) of the port's builders and constructors."""
    from lsr_tpu_torch.frame import build_flagship_scene, flagship_camera
    from lsr_tpu_torch.highpoly import build_highpoly_scene, highpoly_camera
    from lsr_tpu_torch.io.obj import make_uv_sphere
    from lsr_tpu_torch.lighting.light_types import LightSetBuilder
    from lsr_tpu_torch.render import simple_camera, upload_mesh
    from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
    from lsr_tpu_torch.shading.common import make_materials
    from lsr_tpu_torch.shading.models import make_shade_context

    def scene(device):
        sb = SceneBuilder()
        sb.add(make_uv_sphere(rings=4, sectors=8), np.eye(4, dtype=np.float32))
        return sb.build(device)

    def lights(device):
        b = LightSetBuilder()
        b.point((0.0, 1.0, 0.0))
        return b.build(device)

    def ctx(device):
        return make_shade_context(make_materials(device=device),
                                  device=device)

    def preset_frame(device, how=None):
        """forward_plus's frame 0 at 32x24 with tiny maps, through
        build_preset_pipelines' frame function or PluggablePipeline.<how>
        on scene_state(device=device)."""
        from lsr_tpu_torch.pipeline.executor import RenderContext
        from lsr_tpu_torch.render_paths import (
            build_preset_pipelines, scene_state)

        fns, pipes = build_preset_pipelines(
            32, 24, {"forward_plus"}, local_map=16, local_point=16,
            device=device, with_pipes=True)
        pipe, fp, state_fn = pipes["forward_plus"]
        fp.pass_params.shadow.map_size = 32
        fp.pass_params.culling.occ_width = 32
        fp.pass_params.culling.occ_height = 18
        if how is None:
            return fns["forward_plus"](0)
        state = scene_state(32, 24, device=device)
        state["camera"] = state_fn(0)["camera"]
        return getattr(pipe, how)(RenderContext(), state, fp)["ldr"]

    def full_frame(device):
        """Config #5's frame 0 at 32x24 (sun map 32^2), IBL baked on
        `device`."""
        from lsr_tpu_torch.full_pipeline import build_full_pipeline

        frame_fn, _, fp = build_full_pipeline(32, 24, device=device)
        fp.pass_params.shadow.map_size = 32
        return frame_fn(0)["ldr"]

    def full_stack_frame(device):
        from lsr_tpu_torch.render_paths import build_forward_plus_full

        fns, pipes = build_forward_plus_full(
            32, 24, local_map=16, local_point=16, device=device,
            with_pipes=True)
        fp = pipes["forward_plus+full"][1]
        fp.pass_params.shadow.map_size = 32
        fp.pass_params.culling.occ_width = 32
        fp.pass_params.culling.occ_height = 18
        return fns["forward_plus+full"](0)

    from lsr_tpu_torch.full_pipeline import full_scene
    from lsr_tpu_torch.sky.sky_models import procedural_sky_cubemap

    cpu_ctx = build_flagship_scene(n_lights=16, grid=1, device="cpu")[3]
    return {
        "build_full_pipeline": full_frame,
        "full_scene": lambda d: full_scene(32, 24, device=d),
        "build_forward_plus_full": full_stack_frame,
        "procedural_sky_cubemap": lambda d: procedural_sky_cubemap(
            8, device=d),
        "build_preset_pipelines": preset_frame,
        "PluggablePipeline.execute": lambda d: preset_frame(d, "execute"),
        "build_flagship_scene": lambda d: build_flagship_scene(
            n_lights=16, grid=1, device=d),
        "flagship_camera": lambda d: flagship_camera(0, cpu_ctx, W, H,
                                                     device=d),
        "build_highpoly_scene": lambda d: build_highpoly_scene(
            1, n_lights=16, device=d),
        "highpoly_camera": lambda d: highpoly_camera(cpu_ctx, W, H, 1,
                                                     device=d),
        "make_camera": lambda d: make_camera(W, H, (0, 1, -3), (0, 0, 0),
                                             device=d),
        "SceneBuilder.build": scene,
        "LightSetBuilder.build": lights,
        "make_materials": lambda d: make_materials(device=d),
        "make_shade_context": ctx,
        "upload_mesh": lambda d: upload_mesh(make_uv_sphere(4, 8), device=d),
        "simple_camera": lambda d: simple_camera(W, H, (0, 1, -3), (0, 0, 0),
                                                 device=d),
    }


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for f in x.__dataclass_fields__:
            yield from _tensors(getattr(x, f))


ENTRY_POINTS = ["build_flagship_scene", "flagship_camera",
                "build_highpoly_scene", "highpoly_camera", "make_camera",
                "SceneBuilder.build", "LightSetBuilder.build",
                "make_materials", "make_shade_context", "upload_mesh",
                "simple_camera", "build_preset_pipelines",
                "PluggablePipeline.execute", "build_forward_plus_full",
                "full_scene", "build_full_pipeline",
                "procedural_sky_cubemap"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_run_on_the_card_by_default(monkeypatch, name):
    """Called with no device on a machine without CUDA, an entry point
    raises (it never returns CPU tensors); with device="cpu" it works and
    every tensor it returns lies on the CPU."""
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(None)
    out = list(_tensors(call("cpu")))
    assert out and all(t.device.type == "cpu" for t in out)
