"""The flagship forward+ frame: the composition of
bench.py:make_flagship_frame (:179-288), with its arguments and defaults.

  with_cull: frustum_cull_objects -> render_occluder_depth (320x180,
             view-z, depth only)                          [kernel B1]
             -> occlusion_cull_aabbs -> cull_lights_camera
  with_local: render_local_shadow_maps (8 spot + 2 point lights, caster_en
             from the light cull; "map": a B1 launch a slot, "packed": one
             B1a launch a stack)                          [kernel B1 / B1a]
  -> render_shadow_map (NDC01, depth only)                [kernel B1]
  -> make_shadow_context (ESM: prefilter_esm + q16 soft map, or PCF)
  -> scene_setup (culled objects) -> rasterize_direct(spatial_sort=True)
                                                          [kernel B1]
  -> use_resolve=False: interpolate_gbuffer(materials)
                        -> shade_forward_plus(tiled_depth_range, 16 px,
                           cap 128, pbr_mr, local-shadow planes)
                                                          [kernel B2 / B2a]
     use_resolve=True:  resolve_forward_plus(cap 128, pbr_mr, planes)
                                                          [kernel B5 / B5a]
  -> tonemap_pass -> fxaa_pass

bench_config gives the arguments of bench.py main()'s two configurations:
the ESM default and the exact-PCF control.

The scene is the procedural stand-in for the bench's monkey grid: a 5x5
grid of make_uv_sphere(rings=16, sectors=32) (1,024 triangles each) plus the
ground plane, with the bench's 256-light set, materials and checkerboard
texture drawn from default_rng(seed) in the bench's order (bench.py:44-95).
Everything lives on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.frame import ShadowPassParams
from lsr_tpu_torch.core.util import device_const, resolve_device
from lsr_tpu_torch.geometry.occlusion import (
    occlusion_cull_aabbs,
    render_occluder_depth,
)
from lsr_tpu_torch.geometry.volumes import frustum_cull_objects
from lsr_tpu_torch.io.fast_obj import load_obj_fast
from lsr_tpu_torch.io.obj import make_plane, make_uv_sphere
from lsr_tpu_torch.lighting.light_culling import cull_lights_camera
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.lighting.local_shadows import (
    default_vis_crop,
    plan_shadow_casters,
    render_local_shadow_maps,
)
from lsr_tpu_torch.passes.forward_plus import (
    resolve_forward_plus,
    shade_forward_plus,
)
from lsr_tpu_torch.passes.post import fxaa_pass
from lsr_tpu_torch.passes.shadow import make_sun_shadow
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import scene_setup
from lsr_tpu_torch.raster.tiled import rasterize_direct
from lsr_tpu_torch.scene.scene import (
    SceneBuilder,
    make_camera,
    object_world_aabbs,
)
from lsr_tpu_torch.shading.common import checkerboard_texture, make_materials
from lsr_tpu_torch.shading.models import make_shade_context
from lsr_tpu_torch.utils import trace

EYE0 = (6.0, 6.5, -10.0)
FOV = np.pi / 3.2


def build_flagship_scene(n_lights: int = 256, seed: int = 42, grid: int = 5,
                         device=None, mesh_path: str | None = None):
    """Procedural flagship scene on `device` (default: the card,
    core.util.default_device).  Returns (geom, objects, lights, ctx).
    The grid's mesh is the OBJ at mesh_path, loaded with the native loader
    as bench.py loads the monkey, or by default the UV sphere (16 rings,
    32 sectors) that stands in for the monkey."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    sphere = (load_obj_fast(mesh_path) if mesh_path
              else make_uv_sphere(rings=16, sectors=32))
    sb = SceneBuilder()
    for i in range(grid * grid):
        x = (i % grid - grid // 2) * 2.4
        z = (i // grid - grid // 2) * 2.4
        rot = float(rng.uniform(0, 2 * np.pi))
        model = (m3.translate([x, 0.0, z]) @ m3.rotate_y(rot)).numpy()
        sb.add(sphere, model, material=i % 4)
    sb.add(make_plane(10.0, y=-1.0), material=4, casts_shadow=False)
    geom, objects = sb.build(device)

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
    lights = lb.build(device)

    mats = make_materials(
        base_color=[(0.85, 0.5, 0.3), (0.4, 0.65, 0.85), (0.6, 0.8, 0.45),
                    (0.9, 0.85, 0.5), (0.5, 0.5, 0.55)],
        metallic=[0.05, 0.4, 0.0, 0.8, 0.0],
        roughness=[0.4, 0.25, 0.7, 0.35, 0.9],
        tex_id=[-1, -1, -1, -1, 0],
        device=device,
    )
    ctx = make_shade_context(
        mats, light_dir_ws=(0.35, -0.75, 0.45), light_color=(1.0, 0.96, 0.9),
        light_intensity=2.0, camera_pos=EYE0,
        textures=torch.as_tensor(checkerboard_texture(128),
                                 device=device)[None],
        device=device,
    )
    return geom, objects, lights, ctx


def flagship_camera(i: int, ctx, width: int, height: int, device=None):
    """Frame i of the bench's orbit (bench.py:346-354): (cam, ctx_i)."""
    device = resolve_device(device)
    ang = 0.02 * i
    eye = (float(EYE0[0] * np.cos(ang) - EYE0[2] * np.sin(ang)),
           float(EYE0[1]),
           float(EYE0[0] * np.sin(ang) + EYE0[2] * np.cos(ang)))
    cam = make_camera(width, height, eye, (0, 0, 0), fov=FOV, device=device)
    return cam, dataclasses.replace(
        ctx, camera_pos=torch.as_tensor(eye, dtype=torch.float32,
                                        device=device))


def bench_config(shadow_filter: str = "esm", width: int = 1920,
                 height: int = 1080) -> dict:
    """make_flagship_frame's arguments in bench.py main()'s configurations
    (:312-331, :413-418): "esm", the default (sun 1024^2, spot slots 512^2,
    point faces 256^2, visibility planes and sun visibility at half
    resolution), or "pcf", the exact control (2048^2 / 1024^2 / 512^2, full
    resolution); both with the cull, the local atlas and vis_crop auto."""
    esm = shadow_filter == "esm"
    return dict(shadow_size=1024 if esm else 2048,
                local_map=512 if esm else 1024,
                local_point=256 if esm else 512, with_local=True,
                with_cull=True, vis_scale=2 if esm else 1,
                sun_vis_scale=2 if esm else 1,
                vis_crop=default_vis_crop(height, width),
                shadow_filter=shadow_filter)


def cull_frame(geom, objects, lights, cam):
    """The per-frame cull (bench.py:188-207): the objects inside the camera
    frustum, their depth raster at 320x180 as the occluders, the objects
    and lights (range spheres) that the occluders do not hide.  Returns
    (objects with the visibility mask, lights with the enable mask, the
    occluder depth (180, 320))."""
    wmin, wmax = object_world_aabbs(objects)
    vis = objects.visible & frustum_cull_objects(cam.viewproj, wmin, wmax)
    occ = render_occluder_depth(geom, objects, cam.viewproj, cam.zn, cam.zf,
                                320, 180, occluder_mask=vis)
    vis = vis & occlusion_cull_aabbs(occ, cam.viewproj, wmin, wmax, cam.zn,
                                     cam.zf)
    lmask = cull_lights_camera(lights, cam.viewproj, occ_depth=occ, zn=cam.zn,
                               zf=cam.zf)
    return (dataclasses.replace(objects, visible=vis),
            dataclasses.replace(lights, enabled=lights.enabled & lmask), occ)


def flagship_stages(geom, objects, lights, ctx, cam, ctx_t, width: int,
                    height: int, use_resolve: bool = False,
                    shadow_size: int = 2048, shadow_filter: str = "esm",
                    sun_vis_scale: int = 1, with_cull: bool = True,
                    with_local: bool = True, local_map: int = 1024,
                    local_point: int = 512, vis_scale: int = 1,
                    vis_crop: tuple = (), atlas_packed=False, casters=None):
    """One flagship frame's stages (bench.py:185-288); returns the
    intermediates: obj_visible (O,) and light_enabled (L,) after the cull,
    occ_depth (180, 320) (None without the cull), local (LocalShadowMaps or
    None), local_vis (the planes the shade kernel took), setup, depth, tid,
    max_sup, gb (None on the resolve route), hdr, stats, sun_depth (S, S),
    light_viewproj (4, 4), shadow (the ShadowContext) and sun_vis (H, W).
    casters: plan_shadow_casters(lights), computed here (a host read) when
    not given."""
    objs, lights_f, caster_en, occ = objects, lights, None, None
    spot_ids, point_ids = ((), ())
    if with_local:
        spot_ids, point_ids = (plan_shadow_casters(lights) if casters is None
                               else casters)
    if with_cull:
        with trace.stage("cull"):
            objs, lights_f, occ = cull_frame(geom, objects, lights, cam)
            ids = list(spot_ids) + list(point_ids)
            if ids:
                caster_en = lights_f.enabled[device_const(
                    ids, lights.enabled.device, torch.int64)]
    local = None
    if spot_ids or point_ids:
        with trace.stage("local_atlas"):
            local = render_local_shadow_maps(
                geom, objects, lights_f, spot_ids, point_ids,
                map_size=local_map, point_size=local_point, pcf_radius=2,
                vis_scale=vis_scale, vis_crop=tuple(vis_crop),
                caster_enabled=caster_en, filter_mode=shadow_filter,
                atlas_packed=atlas_packed)

    with trace.stage("sun_shadow"):
        shadow = make_sun_shadow(geom, objects, ctx_t.light_dir_ws,
                                 ShadowPassParams(map_size=shadow_size,
                                                  pcf_radius=2,
                                                  filter_mode=shadow_filter))
    ctx_sh = dataclasses.replace(ctx_t, shadow=shadow)

    gb = None
    with trace.stage("camera_raster"):
        setup = scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objs.model, objs.normal_mat,
            cam.viewproj, width, height, obj_visible=objs.visible)
        depth, tid, max_sup = rasterize_direct(setup, width, height, cam.zn,
                                               cam.zf, spatial_sort=True)
        if not use_resolve:
            gb = interpolate_gbuffer(setup, depth, tid,
                                     materials=ctx.materials,
                                     want_face_normal=False)
    with trace.stage("lighting"):
        if use_resolve:
            hdr, stats = resolve_forward_plus(
                setup, depth, tid, ctx_sh, lights_f, cam.view, cam.proj,
                cam.zn, cam.zf, width, height, cap=128, sun_model="pbr_mr",
                rec_layout="lanes", local_shadows=local,
                sun_vis_scale=sun_vis_scale)
        else:
            hdr, stats = shade_forward_plus(
                gb, ctx_sh, lights_f, cam.view, cam.proj, cam.zn, cam.zf,
                width, height, tile_size=16, cap=128,
                mode="tiled_depth_range", sun_model="pbr_mr",
                local_shadows=local, sun_vis_scale=sun_vis_scale)
    return dict(obj_visible=objs.visible, light_enabled=lights_f.enabled,
                occ_depth=occ, local=local, local_vis=stats["local_vis"],
                setup=setup, depth=depth, tid=tid, max_sup=max_sup, gb=gb,
                hdr=hdr, stats=stats, sun_depth=shadow.depth,
                light_viewproj=shadow.light_viewproj, shadow=shadow,
                sun_vis=stats["sun_vis"])


def make_flagship_frame(geom, objects, lights, ctx, width: int, height: int,
                        shadow_size: int = 2048, local_map: int = 1024,
                        local_point: int = 512, with_local: bool = True,
                        with_cull: bool = True, vis_scale: int = 1,
                        vis_crop: tuple = (), use_resolve: bool = False,
                        shadow_filter: str = "esm", sun_vis_scale: int = 1,
                        atlas_packed=False):
    """frame(cam, ctx_t) -> (ldr_u8 (H, W, 3), n_valid, max_sup,
    max_lights_per_bin, overflow_bins), all tensors on the scene's device.
    The arguments and defaults are bench.py's make_flagship_frame's
    (:98-105; shadow_filter "esm", sun_vis_scale 1 and atlas_packed False,
    the "map" strategy, are its environment defaults): use_resolve picks
    kernel B5's route over interp + B2; the sun map is shadow_size^2 with
    PCF radius 2; with_cull culls objects and lights per frame; with_local
    renders the local atlas (local_map^2 spot slots, local_point^2 cube
    faces) and its visibility planes (every vis_scale-th pixel, each in the
    smallest window of the vis_crop cascade that holds its light's
    footprint this frame, chosen on the device by kernel V1).  The shadow
    casters are planned once here, as in bench.py.

    The frame is eager; jit(make_flagship_frame(...)) (utils.jit) runs it
    as one program, captured once into a CUDA graph on the card and
    replayed, as bench.py:344 runs it under jax.jit.  Everything that
    changes from frame to frame reaches it as a tensor of cam / ctx_t.

    Float32 products on the card run in full precision: TF32 is switched
    off here for matmuls (the vertex transform) and cuDNN.  The frame's
    stages are flagship_stages' and post (tonemap, FXAA)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    casters = plan_shadow_casters(lights) if with_local else ((), ())

    def frame(cam, ctx_t):
        st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, width,
                             height, use_resolve=use_resolve,
                             shadow_size=shadow_size,
                             shadow_filter=shadow_filter,
                             sun_vis_scale=sun_vis_scale, with_cull=with_cull,
                             with_local=with_local, local_map=local_map,
                             local_point=local_point, vis_scale=vis_scale,
                             vis_crop=vis_crop, atlas_packed=atlas_packed,
                             casters=casters)
        with trace.stage("post"):
            ldr = fxaa_pass(tonemap_pass(st["hdr"]))
        return (ldr, st["setup"].valid.sum(), st["max_sup"],
                st["stats"]["max_lights_per_bin"],
                st["stats"]["overflow_bins"])

    return frame
