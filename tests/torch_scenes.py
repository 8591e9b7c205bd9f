"""Shared fixtures of the lsr_tpu_torch parity tests (tests/test_torch_*.py).

Builds the procedural flagship stand-in (a grid of UV spheres + ground
plane, bench-style lights, materials and checkerboard texture) with the JAX
package, renders lsr_tpu's reference for the flagship frame (sun shadow
map, optionally the per-frame cull and the local shadow atlas; the B2 or
the resolve route), and hands the same scene state to lsr_tpu_torch
through lsr_tpu_torch.convert.
Inputs come from numpy seeds only.
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import torch

from lsr_tpu.core import math3d as m3
from lsr_tpu.io.obj import make_plane, make_uv_sphere
from lsr_tpu.lighting.light_types import LightSetBuilder
from lsr_tpu.scene.scene import SceneBuilder, make_camera
from lsr_tpu.shading.common import checkerboard_texture, make_materials
from lsr_tpu.shading.models import make_shade_context
from lsr_tpu_torch import convert

EYE0 = (6.0, 6.5, -10.0)
FOV = np.pi / 3.2

# The test shapes are small, and under pytest-xdist several workers share the
# host's cores with XLA's own thread pools: torch's spinning OpenMP workers
# would then slow every process several-fold.  One intra-op thread is enough.
torch.set_num_threads(1)


def jax_flagship_scene(n_lights=256, seed=42, grid=5, rings=16, sectors=32):
    """lsr_tpu twin of lsr_tpu_torch.frame.build_flagship_scene (same rng
    draws in the same order).  Returns (geom, objects, lights, ctx)."""
    rng = np.random.default_rng(seed)
    sphere = make_uv_sphere(rings=rings, sectors=sectors)
    sb = SceneBuilder()
    for i in range(grid * grid):
        x = (i % grid - grid // 2) * 2.4
        z = (i // grid - grid // 2) * 2.4
        rot = float(rng.uniform(0, 2 * np.pi))
        sb.add(sphere, np.asarray(m3.translate([x, 0.0, z]) @ m3.rotate_y(rot)),
               material=i % 4)
    sb.add(make_plane(10.0, y=-1.0), material=4, casts_shadow=False)
    geom, objects = sb.build()
    lb = LightSetBuilder()
    for _ in range(8):
        x, z = float(rng.uniform(-5, 5)), float(rng.uniform(-5, 5))
        color = tuple(rng.uniform(0.2, 1.0, 3).tolist())
        lb.spot((x, 3.0, z), (0, -1, 0), color=color, intensity=2.4,
                range=5.0, inner_angle=0.4, outer_angle=0.7)
    for _ in range(2):
        x, z = float(rng.uniform(-3, 3)), float(rng.uniform(-3, 3))
        lb.point((x, 1.2, z), color=tuple(rng.uniform(0.2, 1.0, 3).tolist()),
                 intensity=1.8, range=3.5)
    for i in range(max(0, n_lights - 10)):
        x = float(rng.uniform(-7, 7))
        z = float(rng.uniform(-7, 7))
        y = float(rng.uniform(0.2, 2.2))
        color = tuple(rng.uniform(0.2, 1.0, 3).tolist())
        if i % 4 == 0:
            lb.spot((x, y + 1.0, z), (0, -1, 0), color=color, intensity=2.0,
                    range=3.5, inner_angle=0.35, outer_angle=0.6)
        else:
            lb.point((x, y, z), color=color, intensity=1.5, range=2.5)
    lights = lb.build()
    mats = make_materials(
        base_color=[(0.85, 0.5, 0.3), (0.4, 0.65, 0.85), (0.6, 0.8, 0.45),
                    (0.9, 0.85, 0.5), (0.5, 0.5, 0.55)],
        metallic=[0.05, 0.4, 0.0, 0.8, 0.0],
        roughness=[0.4, 0.25, 0.7, 0.35, 0.9],
        tex_id=[-1, -1, -1, -1, 0],
    )
    ctx = make_shade_context(
        mats, light_dir_ws=(0.35, -0.75, 0.45), light_color=(1.0, 0.96, 0.9),
        light_intensity=2.0, camera_pos=EYE0,
        textures=jnp.asarray(checkerboard_texture(128))[None])
    return geom, objects, lights, ctx


def jax_highpoly_scene(grid=3, seed=7, n_lights=16):
    """lsr_tpu twin of lsr_tpu_torch.highpoly.build_highpoly_scene: a grid
    of UV spheres at 1.2 spacing (bench_highpoly.py:28-43 with the sphere
    for the monkey), the flagship's lights and shade context."""
    rng = np.random.default_rng(seed)
    sphere = make_uv_sphere(rings=16, sectors=32)
    sb = SceneBuilder()
    for i in range(grid * grid):
        x = (i % grid - grid // 2) * 1.2
        z = (i // grid - grid // 2) * 1.2
        rot = float(rng.uniform(0, 2 * np.pi))
        sb.add(sphere, np.asarray(m3.translate([x, 0.0, z]) @ m3.rotate_y(rot)),
               material=i % 4)
    geom, objects = sb.build()
    _, _, lights, ctx = jax_flagship_scene(n_lights=n_lights, seed=42)
    return geom, objects, lights, ctx


def jax_highpoly_camera(ctx, width, height, grid):
    """The high, oblique bench view (bench_highpoly.py:61-64)."""
    import dataclasses

    ext = grid * 1.2 * 0.72
    eye = (ext, ext * 0.9, -ext)
    cam = make_camera(width, height, eye, (0, 0, 0), fov=np.pi / 3.0)
    return cam, dataclasses.replace(ctx, camera_pos=jnp.asarray(eye, jnp.float32))


def jax_camera(i, ctx, width, height):
    """Frame i of the bench orbit (bench.py:346-354) on the JAX side."""
    import dataclasses

    ang = 0.02 * i
    eye = (float(EYE0[0] * np.cos(ang) - EYE0[2] * np.sin(ang)),
           float(EYE0[1]),
           float(EYE0[0] * np.sin(ang) + EYE0[2] * np.cos(ang)))
    cam = make_camera(width, height, eye, (0, 0, 0), fov=FOV)
    return cam, dataclasses.replace(ctx, camera_pos=jnp.asarray(eye, jnp.float32))


def to_torch(geom, objects, lights, ctx, cam, ctx_t, device="cpu"):
    """The JAX scene state as lsr_tpu_torch dataclasses (ctx_t's camera_pos
    replaces ctx's).  Returns (geom, objects, lights, ctx, cam, ctx_t)."""
    import dataclasses

    g, o, lt, _, c, cm = convert.from_numpy_state(
        geom, objects, lights, ctx.materials, ctx, cam, device)
    c_t = dataclasses.replace(c, camera_pos=torch.as_tensor(
        np.array(ctx_t.camera_pos), device=device))
    return g, o, lt, c, cm, c_t


def jax_sun_shadow(geom, objects, ctx, size, filter_mode="esm"):
    """lsr_tpu's sun map and its sampling context as bench.py builds them
    (bench.py:226-240).  render_shadow_map runs op by op (__wrapped__): its
    light camera's texel snap sits on a knife edge (the window corner is
    -S/2 texels in exact arithmetic), and jit's fused arithmetic may move
    the whole map by a texel where the op-by-op form does not.
    Returns (depth (S, S), light_viewproj, ShadowContext)."""
    from lsr_tpu.core.frame import ShadowPassParams
    from lsr_tpu.lighting.shadow_sample import make_shadow_context
    from lsr_tpu.passes.shadow import render_shadow_map

    params = ShadowPassParams(map_size=size, pcf_radius=2)
    depth, light_vp = render_shadow_map.__wrapped__(
        geom, objects, ctx.light_dir_ws, map_size=size)
    sc = make_shadow_context(
        depth, light_vp, bias_const=params.bias_const,
        bias_slope=params.bias_slope, strength=params.strength,
        pcf_radius=params.pcf_radius, pcf_step=params.pcf_step,
        filter_mode=filter_mode)
    return depth, light_vp, sc


def jax_reference_cull(geom, objects, lights, cam, occ_w=320, occ_h=180):
    """lsr_tpu's per-frame cull of bench.py:188-210, op by op (its occluder
    raster, occ_w x occ_h, through the brute kernel).  Returns (objects with
    the culled visibility, lights with the culled enable mask, occluder
    depth)."""
    import dataclasses

    from lsr_tpu.geometry.occlusion import (
        occlusion_cull_aabbs, render_occluder_depth)
    from lsr_tpu.geometry.volumes import frustum_cull_objects
    from lsr_tpu.lighting.light_culling import cull_lights_camera
    from lsr_tpu.scene.scene import object_world_aabbs

    wmin, wmax = object_world_aabbs(objects)
    vis = objects.visible & frustum_cull_objects(cam.viewproj, wmin, wmax)
    occ = render_occluder_depth(geom, objects, cam.viewproj, cam.zn, cam.zf,
                                occ_w, occ_h, occluder_mask=vis,
                                kernel="brute")
    vis = vis & occlusion_cull_aabbs.__wrapped__(occ, cam.viewproj, wmin,
                                                 wmax, cam.zn, cam.zf)
    lmask = cull_lights_camera(lights, cam.viewproj, occ_depth=occ,
                               zn=cam.zn, zf=cam.zf)
    return (dataclasses.replace(objects, visible=vis),
            dataclasses.replace(lights, enabled=lights.enabled & lmask), occ)


def jax_reference_stages(geom, objects, lights, ctx, cam, ctx_t, width, height,
                         shadow_size=None, use_resolve=False,
                         shadow_filter="esm", sun_vis_scale=1, cull=None,
                         local=None, sun=None, raster=None):
    """lsr_tpu's flagship frame (bench.py:179-288): the sun map
    (shadow_size^2; none when None) -> setup -> rasterize_direct
    (spatial_sort) -> interp + fused shade, or the fused resolve.  cull:
    jax_reference_cull's (objects, lights) to render with; local: the
    local shadow atlas (jax_local_atlas).  sun (jax_sun_shadow's result) and
    raster ((setup, depth, tid, max_sup)) reuse stages another call
    rendered."""
    import dataclasses

    from lsr_tpu.passes.forward_plus import (
        resolve_forward_plus, shade_forward_plus)
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.raster.tiled import rasterize_direct

    out = {}
    if shadow_size is not None:
        if sun is None:
            sun = jax_sun_shadow(geom, objects, ctx_t, shadow_size,
                                 shadow_filter)
        out["sun_depth"], out["light_viewproj"], sc = sun
        ctx_t = dataclasses.replace(ctx_t, shadow=sc)
    objs, lights_f = (objects, lights) if cull is None else cull[:2]
    if raster is None:
        setup = scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objs.model, objs.normal_mat,
            cam.viewproj, width, height, obj_visible=objs.visible)
        raster = (setup,) + tuple(rasterize_direct(
            setup, width, height, cam.zn, cam.zf, spatial_sort=True))
    setup, depth, tid, max_sup = raster
    gb = None
    if use_resolve:
        hdr, stats = resolve_forward_plus(
            setup, depth, tid, ctx_t, lights_f, cam.view, cam.proj, cam.zn,
            cam.zf, width, height, cap=128, sun_model="pbr_mr",
            rec_layout="lanes", local_shadows=local,
            sun_vis_scale=sun_vis_scale)
    else:
        gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials,
                                 want_face_normal=False)
        hdr, stats = shade_forward_plus(
            gb, ctx_t, lights_f, cam.view, cam.proj, cam.zn, cam.zf, width,
            height, tile_size=16, cap=128, mode="tiled_depth_range",
            sun_model="pbr_mr", local_shadows=local,
            sun_vis_scale=sun_vis_scale)
    out.update(setup=setup, depth=depth, tid=tid, max_sup=max_sup, gb=gb,
               hdr=hdr, stats=stats)
    return out


def torch_setup(s):
    """lsr_tpu's TriSetup as an lsr_tpu_torch TriSetup on the CPU."""
    from lsr_tpu_torch.raster.setup import TriSetup

    def t(name):
        a = np.asarray(getattr(s, name))
        return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32
                               else np.array(a))

    return TriSetup(**{f: t(f) for f in ("coef", "iw", "ziw", "bbox", "valid",
                                         "obj_id", "wp", "nw", "uv")})


def jax_local_atlas(geom, objects, lights, spot_ids, point_ids, map_size,
                    point_size, filter_mode, vis_scale=1, caster_enabled=None,
                    pcf_radius=2):
    """lsr_tpu's local shadow atlas (render_local_shadow_maps), its slots
    rendered op by op: per slot lsr_tpu's frustum_cull_objects,
    scene_setup_depth and rasterize_brute, one call at a time, then its own
    table packing, with pcf_radius (the PCF / ESM filter radius, 2 in
    bench.py's frame).  Its jitted form and its lax.map over slots (which
    __wrapped__ still compiles) move a triangle of a grid-2 point face on
    the edge of a texel centre (68 texels of face 1 at 32^2), as jit moves
    the sun map's snap (ROADMAP C11).  A culled light's slots stay all far,
    as its lax.cond makes them.  PCF tables follow lsr_tpu's TAPS_U16 as
    its packing does (local_shadows.py:400).  Returns lsr_tpu's
    LocalShadowMaps."""
    from lsr_tpu.geometry.volumes import frustum_cull_objects
    from lsr_tpu.lighting import local_shadows as jls
    from lsr_tpu.lighting import shadow_sample as jss
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.setup import CULL_NONE, DEPTH_NDC01, scene_setup_depth
    from lsr_tpu.scene.scene import object_world_aabbs

    (kinds, base_slots, caster_pos, caster_range, strengths, spot_vp,
     point_vp) = jls.plan_slot_stacks(lights, spot_ids, point_ids)
    wmin, wmax = object_world_aabbs(objects)
    caster_mask = objects.casts_shadow & objects.visible
    en = (np.ones(len(kinds), bool) if caster_enabled is None
          else np.asarray(caster_enabled, bool))
    n_spot = len(spot_ids)
    slot_en = list(en[:n_spot]) + list(np.repeat(en[n_spot:], 6))
    fars = np.maximum(np.asarray(caster_range), np.float32(0.25))
    slot_far = list(fars[:n_spot]) + list(np.repeat(fars[n_spot:], 6))

    def table(vps, size, first):
        tabs = []
        for s in range(vps.shape[0]):
            d = jnp.ones((size, size), jnp.float32)
            if slot_en[first + s]:
                sm = caster_mask & frustum_cull_objects(vps[s], wmin, wmax)
                st = scene_setup_depth(
                    geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
                    objects.model, vps[s], size, size, cull_mode=CULL_NONE,
                    obj_visible=sm)
                d, _ = rasterize_brute(st, size, size, jnp.float32(0.0),
                                       jnp.float32(1.0),
                                       depth_mode=DEPTH_NDC01)
            if filter_mode == "esm":
                lin = jls._linearize01(d, jnp.float32(0.05),
                                       jnp.float32(slot_far[first + s]))
                tabs.append(jss.pack_soft_u16(jss.prefilter_esm(
                    lin, pcf_radius, 80.0)))
            else:
                pack = (jss.pack_shadow_taps_u16 if jss.TAPS_U16
                        else jss.pack_shadow_taps)
                tabs.append(pack(d, pcf_radius, jls._TAP_STRIDE))
        return jnp.concatenate(tabs, 0) if tabs else None

    return jls.LocalShadowMaps(
        spot_taps=table(spot_vp, map_size, 0),
        point_taps=table(point_vp, point_size, n_spot),
        spot_viewproj=spot_vp.reshape(-1, 16),
        point_viewproj=point_vp.reshape(-1, 16),
        caster_pos=jnp.stack(caster_pos), caster_range=jnp.stack(caster_range),
        light_shadow_index=jls.shadow_index_for_lights(lights, spot_ids,
                                                       point_ids),
        strength=jnp.asarray(strengths, jnp.float32),
        bias_const=jnp.float32(2e-3), bias_slope=jnp.float32(6e-3),
        caster_enabled=(None if caster_enabled is None
                        else jnp.asarray(en)),
        spot_size=map_size, point_size=point_size, pcf_radius=pcf_radius,
        kinds=tuple(kinds), base_slots=tuple(base_slots), vis_scale=vis_scale,
        vis_crop=(), filter_mode=filter_mode, esm_c=80.0)


def torch_gbuffer(gb):
    """lsr_tpu's GBuffer as an lsr_tpu_torch GBuffer on the CPU, field for
    field (absent fields stay None; integer planes as int64)."""
    import dataclasses

    from lsr_tpu_torch.raster.interp import GBuffer

    def t(name):
        a = getattr(gb, name, None)
        if a is None:
            return None
        a = np.asarray(a)
        return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32
                               else np.array(a))

    return GBuffer(**{f.name: t(f.name) for f in dataclasses.fields(GBuffer)})


def jax_full_scene(width, height, ibl=True):
    """lsr_tpu twin of lsr_tpu_torch.full_pipeline.full_scene (Config #5,
    demos/hello_full_pipeline.py:40-102 with a UV sphere for each monkey),
    same rng draws in the same order; the IBL baked from the procedural sky
    when ibl.  Returns the frame state dict."""
    from lsr_tpu.resources.ibl import (
        compute_irradiance_map, compute_prefiltered_specular)
    from lsr_tpu.sky.sky_models import procedural_sky_cubemap

    sun = (0.35, -0.7, 0.5)
    eye = (0.8, 1.6, -4.5)
    monkey = make_uv_sphere(rings=16, sectors=32)
    b = SceneBuilder()
    cur = np.asarray(m3.translate([0.3, 0.3, 0.0]) @ m3.rotate_y(0.6))
    prev = np.asarray(m3.translate([-0.3, 0.3, 0.0]) @ m3.rotate_y(0.45))
    b.add(monkey, cur, material=0, prev_model=prev)
    b.add(monkey, np.asarray(m3.translate([-2.2, 0.3, 2.0])
                             @ m3.rotate_y(2.2)), material=2)
    b.add(make_uv_sphere(0.7), np.asarray(m3.translate([2.0, 0.0, 1.5])),
          material=3)
    b.add(make_plane(8.0, y=-0.9), material=1, casts_shadow=False)
    geom, objects = b.build()
    cam = make_camera(width, height, eye, (0, 0, 0.5))
    lb = LightSetBuilder()
    rng = np.random.default_rng(9)
    for _ in range(48):
        lb.point(tuple(rng.uniform([-4, 0.0, -3], [4, 2.2, 4]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.2, range=2.2)
    maps = None
    if ibl:
        cube = procedural_sky_cubemap(32, sun_dir_ws=jnp.asarray(sun,
                                                                 jnp.float32))
        maps = (compute_irradiance_map(cube, out_size=8, samples=128),
                tuple(compute_prefiltered_specular(cube, out_size=16,
                                                   samples=64, mips=4)))
    mats = make_materials(
        base_color=[(0.85, 0.55, 0.35), (0.55, 0.56, 0.6), (0.4, 0.6, 0.85),
                    (0.95, 0.9, 0.6)],
        metallic=[0.1, 0.0, 0.3, 0.9], roughness=[0.4, 0.7, 0.35, 0.2],
        tex_id=[-1, 0, -1, -1])
    ctx = make_shade_context(
        mats, light_dir_ws=sun, light_color=(1.0, 0.96, 0.9),
        light_intensity=2.6, camera_pos=eye,
        textures=jnp.asarray(checkerboard_texture(128))[None], ibl=maps)
    return {"geom": geom, "objects": objects, "camera": cam,
            "lights": lb.build(), "shade_ctx": ctx}


def state_to_torch(js, device="cpu"):
    """A frame state dict of lsr_tpu's ({"geom", "objects", "camera",
    "lights", "shade_ctx"}) as lsr_tpu_torch's."""
    g, o, lt, _, c, cam = convert.from_numpy_state(
        js["geom"], js["objects"], js["lights"], js["shade_ctx"].materials,
        js["shade_ctx"], js["camera"], device)
    return {"geom": g, "objects": o, "camera": cam, "lights": lt,
            "shade_ctx": c}


def jax_gbuffer(js, width, height, obj_visible=None):
    """lsr_tpu's camera raster of a frame state (scene_setup ->
    rasterize_brute -> interpolate_gbuffer).  Returns (setup, depth, tid,
    gbuffer)."""
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, cam = js["geom"], js["objects"], js["camera"]
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, width, height,
                        obj_visible=objects.visible if obj_visible is None
                        else obj_visible)
    depth, tid = rasterize_brute(setup, width, height, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid,
                             materials=js["shade_ctx"].materials)
    return setup, depth, tid, gb


def jax_render_path_scene(width, height, n_lights=48, seed=4):
    """lsr_tpu twin of render_paths.scene_state (run_phases.py:51-92 with
    the UV sphere for the monkey), same rng draws in the same order."""
    sphere = make_uv_sphere(rings=16, sectors=32)
    sb = SceneBuilder()
    sb.add(sphere, np.asarray(m3.translate([0, 0.2, 0]) @ m3.rotate_y(0.5)))
    sb.add(sphere, np.asarray(
        m3.translate([-2.0, 0.2, 1.5]) @ m3.rotate_y(2.0)), material=1)
    sb.add(make_plane(6.0, y=-1.0), material=2, casts_shadow=False)
    geom, objects = sb.build()
    cam = make_camera(width, height, (0.6, 1.6, -4.5), (0, 0, 0))
    lb = LightSetBuilder()
    rng = np.random.default_rng(seed)
    for _ in range(8):
        p = rng.uniform([-3, 2.0, -3], [3, 3.2, 3])
        lb.spot(tuple(p.tolist()), (0, -1, 0),
                color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                intensity=2.0, range=4.5, inner_angle=0.4, outer_angle=0.7)
    for _ in range(2):
        lb.point(tuple(rng.uniform([-2, 0.8, -2], [2, 1.6, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.6, range=3.5)
    for _ in range(max(0, n_lights - 10)):
        lb.point(tuple(rng.uniform([-3, 0.2, -3], [3, 2, 3]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.4, range=2.4)
    mats = make_materials(
        base_color=[(0.85, 0.5, 0.3), (0.4, 0.65, 0.85), (0.55, 0.56, 0.6)],
        roughness=[0.4, 0.3, 0.8], metallic=[0.05, 0.4, 0.0])
    ctx = make_shade_context(mats, light_dir_ws=(0.35, -0.7, 0.5),
                             camera_pos=(0.6, 1.6, -4.5), light_intensity=2.2)
    return {"geom": geom, "objects": objects, "camera": cam,
            "lights": lb.build(), "shade_ctx": ctx}


_BAKED = ("scene_cull", "shadow_map", "local_shadows", "depth_prepass")


def jax_chain_frame(js, fp, chain, width, height, occ=(160, 90), sun=128,
                    slot=64, face=32, history=None, keep=()):
    """lsr_tpu's frame for a pass chain (the pass ids of a port pipeline's
    plan, in order) composed op by op: the cull (jax_reference_cull), the
    sun map (jax_sun_shadow, PCF), the local atlas slot by slot
    (jax_local_atlas) and the camera raster (scene_setup on the view mask
    -> rasterize_brute) as those passes' products, then every other pass
    of the chain by lsr_tpu's own RenderPass classes, on fp (a port
    FrameParams, carried into lsr_tpu's field by field).  history: TAA's
    history_color of the previous frame.  Returns the final state, with
    state["hdr@" + pid] the HDR after each pass id in keep."""
    from lsr_tpu.core.frame import FrameParams as JFrameParams
    from lsr_tpu.passes.standard_passes import make_standard_registry
    from lsr_tpu.pipeline.executor import RenderContext
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.setup import scene_setup

    jfp = convert._dataclass_like(JFrameParams, fp)
    geom, objects, cam = js["geom"], js["objects"], js["camera"]
    state = dict(js)
    vis = objects.visible
    if "scene_cull" in chain:
        objs, state["lights"], _ = jax_reference_cull(
            geom, objects, js["lights"], cam, *occ)
        vis = objs.visible
        state["view_mask"] = vis
    if "shadow_map" in chain:
        state["shadow_ctx"] = jax_sun_shadow(geom, objects, js["shade_ctx"],
                                             sun, "pcf")[2]
    p = fp.pass_params.local_shadow
    ids = list(p.spot_ids) + list(p.point_ids)
    if "local_shadows" in chain and not ids:
        state["local_shadow_maps"] = None      # no casters: lsr_tpu's pass
    elif "local_shadows" in chain:
        state["local_shadow_maps"] = jax_local_atlas(
            geom, objects, state["lights"], p.spot_ids, p.point_ids, slot,
            face, "pcf",
            caster_enabled=np.asarray(state["lights"].enabled)[ids])
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, width, height,
                        obj_visible=vis)
    state["depth"], state["tid"] = rasterize_brute(setup, width, height,
                                                   cam.zn, cam.zf)
    state["setup"] = setup
    if history is not None:
        state["history_color"] = history
    reg = make_standard_registry()
    for pid in chain:
        if pid not in _BAKED:
            state = reg.create(pid).execute_resolved(RenderContext(), state,
                                                     jfp, None)
        if pid in keep:
            state["hdr@" + pid] = state["hdr"]
    return state


def frame_contract(t_tid, j_tid, t_hdr, j_hdr, t_ldr, j_ldr,
                   hdr_share=0.999):
    """ROADMAP C1's whole-frame contract: tids equal on >= 99.5% of covered
    pixels, HDR within 1e-4 on >= hdr_share (99.9%) of agreeing pixels, LDR
    within 1 LSB on >= 99.9%.  Returns (tid match, HDR share, LDR
    share)."""
    j_tid = np.asarray(j_tid)
    same = np.asarray(t_tid) == j_tid
    tid_ok = float((same | (j_tid < 0)).mean())
    err = np.abs(np.asarray(t_hdr) - np.asarray(j_hdr)).max(-1)
    hdr_ok = float((err[same] <= 1e-4).mean())
    d = np.abs(np.asarray(t_ldr).astype(int)
               - np.asarray(j_ldr).astype(int)).max(-1)
    ldr_ok = float((d <= 1).mean())
    assert np.isfinite(np.asarray(t_hdr)).all()
    assert tid_ok >= 0.995 and hdr_ok >= hdr_share and ldr_ok >= 0.999, (
        tid_ok, hdr_ok, float(err[same].max()), ldr_ok)
    return tid_ok, hdr_ok, ldr_ok


def preset_pipeline(name, width, height, post=("fxaa",)):
    """(pipeline, fp, state_fn) of a render-path preset on the CPU with
    the render-path tests' cut maps (sun 128^2, slots 64^2, faces 32^2,
    occluders 160x90)."""
    from lsr_tpu_torch.render_paths import build_preset_pipelines

    _, pipes = build_preset_pipelines(width, height, {name}, post=post,
                                      local_map=64, local_point=32,
                                      device="cpu", with_pipes=True)
    pipe, fp, state_fn = pipes[name]
    fp.pass_params.shadow.map_size = 128
    fp.pass_params.culling.occ_width, fp.pass_params.culling.occ_height = \
        160, 90
    return pipe, fp, state_fn


# ---------------------------------------------------------------------------
# A recording fake card: utils.jit's graph route on CPU tensors
# ---------------------------------------------------------------------------

_EMPTY = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default}


def _tensor_leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensor_leaves(v)]
    return []


def _refill(outs, news):
    """Copies each new tensor into the recorded one it stands for, unless
    the two share their memory already (an alias)."""
    for o, n in zip(_tensor_leaves(outs), _tensor_leaves(news)):
        if o is n or (o.untyped_storage().data_ptr()
                      == n.untyped_storage().data_ptr()
                      and o.storage_offset() == n.storage_offset()):
            continue
        o.copy_(n)


class TapeGraph:
    """A CUDA graph's stand-in that replays what was captured without
    running the captured function's Python: every aten op dispatched
    while capturing is recorded with its tensors (the graph's static
    memory) and run again on replay, its result copied into the tensor it
    made at the capture; a kernel's plain version (RecordingCard.kernel)
    is recorded whole, as one launch.  reset() frees it."""

    def __init__(self):
        self.tape, self.was_reset = [], False

    def replay(self):
        assert not self.was_reset, "replay of a released graph"
        for entry in self.tape:
            if callable(entry):
                entry()
                continue
            func, args, kwargs, out = entry
            new = func(*args, **kwargs)
            if (func in _EMPTY or func.is_view
                    or func._schema.is_mutable):
                continue       # in place / out=, an alias, or undefined
            _refill(out, new)

    def reset(self):
        self.tape, self.was_reset = [], True


class RecordingCard:
    """jit's graph route on the CPU (install(monkeypatch)): CPU leaves count
    as the card's, torch.cuda's graph, streams and memory are stand-ins,
    and a capture records into a TapeGraph.  kernel(owner, name) turns a
    kernel's plain version into a fake kernel: counted in its own launches
    (band_launches too, for a screen band: y_offset or full_height given),
    run with the capture's check paused, and recorded whole."""

    def __init__(self):
        self.graph = self.check = None
        self.paused = False
        self.counters = []

    def install(self, monkeypatch):
        from torch.utils._python_dispatch import TorchDispatchMode

        from lsr_tpu_torch.utils import jit as jm

        card = self

        class Tape(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not card.paused:
                    card.graph.tape.append((func, args, kwargs, out))
                return out

        class Check(jm.CaptureCheck):
            def __enter__(self):
                card.check = self
                return super().__enter__()

        class Stream:
            def __init__(self, *a):
                pass

            def wait_stream(self, other):
                pass

        @contextlib.contextmanager
        def capture(graph):
            card.graph = graph
            try:
                with Tape():
                    yield
            finally:
                card.graph = card.check = None

        monkeypatch.setattr(jm, "_card_device",
                            lambda leaves: leaves[0].device)
        monkeypatch.setattr(jm, "launch_counters", lambda: card.counters)
        monkeypatch.setattr(jm, "CaptureCheck", Check)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", TapeGraph)
        monkeypatch.setattr(torch.cuda, "graph", capture)
        monkeypatch.setattr(torch.cuda, "Stream", Stream)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: Stream())
        monkeypatch.setattr(torch.cuda, "stream",
                            lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
        monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
        return self

    def kernel(self, monkeypatch, owner, name):
        """Makes owner.name a fake kernel; returns it (its launches and
        band_launches are jit's launch counters)."""
        plain = getattr(owner, name)
        card = self

        def fake(*args, **kwargs):
            fake.launches += 1
            if (kwargs.get("y_offset")
                    or kwargs.get("full_height") not in (
                        None, args[2] if len(args) > 2 else None)):
                fake.band_launches += 1
            if card.graph is None:
                return plain(*args, **kwargs)
            graph = card.graph
            card.paused = True
            try:
                with card.check.pause():
                    out = plain(*args, **kwargs)
            finally:
                card.paused = False
            graph.tape.append(lambda: _refill(out, plain(*args, **kwargs)))
            return out

        fake.launches = fake.band_launches = 0
        monkeypatch.setattr(owner, name, fake)
        self.counters += [(fake, "launches"), (fake, "band_launches")]
        return fake
