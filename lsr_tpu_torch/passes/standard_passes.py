"""The standard render passes (port of lsr_tpu/passes/standard_passes.py):
the camera raster (with motion vectors), the lighting passes, and the
RenderPass classes and registry of the render-path pipeline
(lsr_tpu_torch/pipeline).

Frame state is a dict of named tensors; scene inputs come under "geom",
"objects", "lights", "shade_ctx" and "camera".  make_standard_registry
registers every pass id of lsr_tpu's with the same descriptors, so a recipe
compiles to the same chain, and every one of them runs.  The lighting
passes take lsr_tpu's fused branch (kernel B2 in the technique's mode) for
the pbr_mr / blinn_phong sun models with no debug view and no SSAO mask,
and its general branch otherwise: the shading model for the sun, the local
lights binned per tile (internally when the chain has no culling pass) and
summed by accumulate_local_lights, the SSAO mask over covered pixels.  The
post passes (motion blur, light shafts, depth of field, bloom, TAA) are
pass-throughs while their enable flag is off, as in lsr_tpu.

Two repairs against lsr_tpu, both following lsr_tpu's own contracts:
- a compact setup that overflowed its caps falls back to scene_setup (the
  scene_setup_compact docstring), instead of rasterizing with dropped rows;
- the binned raster's list cap is raised to the scene's largest bin before
  the launch (scripts/bench_highpoly.py:94-103), instead of dropping
  triangles past raster_cap.
Both are recorded in state["raster_stats"] (compact_fallback,
raster_cap_used).  Eagerly both read the data on the host; with
state["capacities"] (utils.capacity.Capacities, a one-program frame) both
come from the capacities, nothing is read on the host, and
raster_stats["capacity_exceeded"] flags a frame that exceeded them.
"""

from __future__ import annotations

import dataclasses

import torch

from lsr_tpu_torch.core.frame import (
    DebugViewMode,
    FrameParams,
    LightCullingMode,
    TechniqueMode,
)
from lsr_tpu_torch.core.util import device_const
from lsr_tpu_torch.geometry.occlusion import (
    occlusion_cull_aabbs,
    render_occluder_depth,
)
from lsr_tpu_torch.geometry.volumes import (
    frustum_cull_objects,
    update_visibility_history,
)
from lsr_tpu_torch.lighting.light_culling import (
    cluster_slice_bounds,
    count_occupancy,
    cull_lights_camera,
    cull_lights_clustered,
    cull_lights_tiled,
    tile_depth_ranges_from_buffer,
)
from lsr_tpu_torch.lighting.light_runtime import (
    accumulate_local_lights,
    combine_local_light,
)
from lsr_tpu_torch.lighting.local_shadows import (
    local_shadow_vis_stack,
    render_local_shadow_maps,
)
from lsr_tpu_torch.passes.forward_plus import (
    _cluster_of_pixel,
    shade_forward_plus,
)
from lsr_tpu_torch.passes.post import (
    bloom_pass,
    depth_of_field_pass,
    fxaa_pass,
    light_shafts_pass,
    motion_blur_pass,
    motion_vectors_pass,
    taa_pass,
)
from lsr_tpu_torch.passes.shadow import make_sun_shadow
from lsr_tpu_torch.passes.ssao import ssao_depth_pass
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.pipeline.contracts import STANDARD_CONTRACTS
from lsr_tpu_torch.pipeline.registry import PassDescriptor, PassFactoryRegistry
from lsr_tpu_torch.pipeline.render_pass import RenderPass
from lsr_tpu_torch.raster import tiled
from lsr_tpu_torch.raster.brute import rasterize_brute
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import scene_setup, scene_setup_compact
from lsr_tpu_torch.scene.scene import object_world_aabbs
from lsr_tpu_torch.shading.common import (
    gather_materials,
    sample_texture_bilinear,
)
from lsr_tpu_torch.shading.models import (
    SHADING_MODELS,
    _norm,
    composite_over_background,
)
from lsr_tpu_torch.sky.sky_models import render_sky
from lsr_tpu_torch.utils.capacity import binned_raster


def _with_gbuffer(out, setup, depth, tid, fp: FrameParams):
    """Adds the G-buffer and the velocity plane (motion vectors with
    fp.enable_motion_vectors, zero otherwise) to the state dict."""
    gb = interpolate_gbuffer(setup, depth, tid,
                             materials=out["shade_ctx"].materials)
    out["gbuffer"] = gb
    if fp.enable_motion_vectors:
        cam = out["camera"]
        out["velocity"] = motion_vectors_pass(
            gb, out["objects"], cam.viewproj, cam.prev_viewproj, fp.width,
            fp.height)
    else:
        out["velocity"] = torch.zeros((fp.height, fp.width, 2),
                                      dtype=torch.float32,
                                      device=depth.device)
    return out


def _raster(state, fp: FrameParams, depth_only: bool = False):
    """Camera raster: setup (compact above fp.compact_setup_threshold input
    triangles) -> B1 up to tiled.DIRECT_ROW_LIMIT setup rows, B3 above ->
    G-buffer.  Returns a new state dict.

    Without state["capacities"] the compact overflow and B3's largest bin
    are read on the host (the eager route).  With them (utils.capacity),
    the compact-or-full choice, B3's list width and its pair slots come
    from the capacities, and raster_stats["capacity_exceeded"] (a device
    flag) is set where the frame exceeded them."""
    # Reuse an earlier raster of the same frame (a depth prepass): the
    # visibility buffer is complete, so only interpolation runs.
    if ("depth" in state and "tid" in state and "setup" in state
            and not depth_only):
        return _with_gbuffer(dict(state), state["setup"], state["depth"],
                             state["tid"], fp)
    geom, objects, cam = state["geom"], state["objects"], state["camera"]
    caps = state.get("capacities")
    view_mask = state.get("view_mask", objects.visible)
    args = (geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, fp.width, fp.height)
    stats = {"tri_input": geom.indices.shape[0]}
    setup = over = None
    if geom.indices.shape[0] > fp.compact_setup_threshold:
        fallback = caps is not None and not caps.compact
        if not fallback:
            setup, cstats = scene_setup_compact(
                *args, cull_mode=fp.cull_mode, obj_visible=view_mask,
                cap_fraction=fp.compact_cap_fraction)
            stats.update(compact_overflow=cstats.overflow,
                         compact_n_direct=cstats.n_direct,
                         compact_n_clip=cstats.n_clip)
            if caps is None:
                fallback = bool(cstats.overflow)
            else:
                over = cstats.overflow
        stats["compact_fallback"] = fallback
        if fallback:
            setup = None
    if setup is None:
        setup = scene_setup(*args, cull_mode=fp.cull_mode,
                            obj_visible=view_mask)
    if not fp.use_tiled_raster:
        depth, tid = rasterize_brute(setup, fp.width, fp.height, cam.zn,
                                     cam.zf)
    elif setup.count <= tiled.DIRECT_ROW_LIMIT:
        depth, tid, _ = tiled.rasterize_direct(
            setup, fp.width, fp.height, cam.zn, cam.zf,
            tile_h=fp.raster_tile_h, tile_w=fp.raster_tile_w,
            chunk=fp.raster_chunk, spatial_sort=True)
    else:
        depth, tid, b3 = binned_raster(
            setup, fp.width, fp.height, cam.zn, cam.zf, caps, fp.raster_cap,
            fp.raster_tile_h, fp.raster_tile_w, fp.raster_chunk)
        b3_over = b3.pop("capacity_exceeded", None)
        if b3_over is not None:
            over = b3_over if over is None else over | b3_over
        stats.update(b3)
    if over is not None:
        stats["capacity_exceeded"] = over
    stats["tri_after_clip"] = setup.valid.sum()
    out = dict(state)
    out.update(setup=setup, depth=depth, tid=tid, raster_stats=stats)
    if depth_only:
        return out
    return _with_gbuffer(out, setup, depth, tid, fp)


def _background(state, fp: FrameParams):
    if "sky" in state:
        return state["sky"]
    dev = state["gbuffer"].depth01.device
    return device_const(fp.background, dev).expand(fp.height, fp.width, 3)


def fused_ok(state, fp: FrameParams) -> bool:
    """Whether lsr_tpu's lighting passes take their fused branch
    (_LightingBase._fused_kernel_ok, standard_passes.py:473-483, for the
    passes with local lights): the pbr_mr / blinn_phong sun model, no debug
    view, no SSAO mask."""
    return (fp.debug_view == DebugViewMode.NONE
            and fp.shading_model in ("pbr_mr", "blinn_phong")
            and state.get("ssao_mask") is None)


def fused_lighting(state, fp: FrameParams):
    """The fused branch of lsr_tpu's lighting passes (sun + binned local
    lights through kernel B2, ambient, emissive, the frame's background).
    Returns a new state dict with "hdr"."""
    t = fp.technique
    if not fused_ok(state, fp):
        raise ValueError("fused_lighting: the frame takes the general "
                         "branch (general_lighting)")
    gb = state["gbuffer"]
    sctx = state["shade_ctx"]
    if state.get("shadow_ctx") is not None and fp.enable_shadows:
        sctx = dataclasses.replace(sctx, shadow=state["shadow_ctx"])
    cam = state["camera"]
    clustered = (t.mode == TechniqueMode.CLUSTERED_FORWARD
                 or t.light_culling == LightCullingMode.CLUSTERED)
    mode = "clustered" if clustered else (
        "tiled_depth_range"
        if t.light_culling == LightCullingMode.TILED_DEPTH_RANGE else "tiled")
    hdr, _ = shade_forward_plus(
        gb, sctx, state["lights"], cam.view, cam.proj, cam.zn, cam.zf,
        fp.width, fp.height, tile_size=t.tile_size,
        cap=t.max_lights_per_tile, mode=mode, slices=t.cluster_slices,
        sun_model=fp.shading_model, use_kernel=True,
        local_shadows=state.get("local_shadow_maps"),
        sun_vis_scale=fp.pass_params.shadow.sun_vis_scale)
    # shade_forward_plus composites a constant background; the frame's own
    # background plane replaces it.
    out = dict(state)
    out["hdr"] = torch.where(gb.covered[..., None], hdr,
                             _background(state, fp))
    return out


def _sun_shade(state, fp: FrameParams):
    """The sun (and ambient) by the frame's shading model (its debug view's
    model when one is set) over the frame's background."""
    gb = state["gbuffer"]
    ctx = state["shade_ctx"]
    model = (f"debug_{fp.debug_view.value}"
             if fp.debug_view != DebugViewMode.NONE else fp.shading_model)
    if state.get("shadow_ctx") is not None and fp.enable_shadows:
        ctx = dataclasses.replace(ctx, shadow=state["shadow_ctx"])
    return composite_over_background(SHADING_MODELS[model](gb, ctx), gb,
                                     _background(state, fp))


def _local_lights(state, fp: FrameParams):
    """The binned local lights of state["light_grid"] (tiled, or clustered
    when it has slices), with the local-shadow planes, combined with the
    albedo over covered pixels."""
    gb = state["gbuffer"]
    cam = state["camera"]
    sctx = state["shade_ctx"]
    grid = state["light_grid"]
    cluster = None
    if grid["slices"] > 1:
        cluster = _cluster_of_pixel(gb.depth01, cam.zn, cam.zf,
                                    grid["slices"])
    vis_stack = shadow_index = None
    sh = state.get("local_shadow_maps")
    if sh is not None:
        vis_stack = local_shadow_vis_stack(sh, gb.world_pos,
                                           _norm(gb.normal_ws))
        shadow_index = sh.light_shadow_index
    diff, spec = accumulate_local_lights(
        gb.world_pos, gb.normal_ws, sctx.camera_pos, state["lights"],
        grid["lists"], fp.width, fp.height, tile_size=fp.technique.tile_size,
        cluster_of_pixel=cluster, slices=grid["slices"],
        shadow_vis_stack=vis_stack, light_shadow_index=shadow_index)
    base, _, _, _, _, tex_id = gather_materials(sctx.materials, gb.obj_id,
                                                mat_rec=gb.mat)
    if sctx.textures is not None:
        base = base * sample_texture_bilinear(sctx.textures, tex_id, gb.uv,
                                              quads=sctx.texture_quads)
    local = combine_local_light(torch.clamp(base, min=0.0), diff, spec)
    return torch.where(gb.covered[..., None], local, torch.zeros_like(local))


def general_lighting(ctx, state, fp: FrameParams, request):
    """The general branch of lsr_tpu's lighting passes
    (standard_passes.py:520-533): the sun by the shading model, the binned
    local lights (binned here by LightCullingPass when the chain has no
    culling pass), the SSAO mask over covered pixels.  Returns a new state
    dict with "hdr"."""
    hdr = _sun_shade(state, fp)
    if state.get("light_grid") is None:
        state = LightCullingPass().execute_resolved(ctx, state, fp, request)
    hdr = hdr + _local_lights(state, fp)
    if state.get("ssao_mask") is not None:
        gb = state["gbuffer"]
        hdr = torch.where(gb.covered[..., None],
                          hdr * state["ssao_mask"][..., None], hdr)
    out = dict(state)
    out["hdr"] = hdr
    return out


class SceneCullPass(RenderPass):
    """Per-frame scene and light culling (lsr_tpu's SceneCullPass): object
    world AABBs against the camera frustum, then against the occluder depth
    proxy (occ_width x occ_height through kernel B1) by HiZ, the visibility
    hysteresis (persistent 'vis_history') and the camera cull of the local
    lights (lights.enabled).  Writes 'view_mask', which only the camera
    raster reads: shadow passes keep objects.visible."""

    def __init__(self):
        super().__init__("scene_cull",
                         reads=("geom", "objects", "camera"),
                         writes=("view_mask", "lights", "vis_history"),
                         contract=STANDARD_CONTRACTS["scene_cull"])

    def execute_resolved(self, ctx, state, fp, request):
        p = fp.pass_params.culling
        out = dict(state)
        objects, cam = state["objects"], state["camera"]
        vis = objects.visible
        wmin, wmax = object_world_aabbs(objects)
        if p.frustum:
            vis = vis & frustum_cull_objects(cam.viewproj, wmin, wmax)
        occ_depth = None
        if p.occlusion:
            occ_depth = render_occluder_depth(
                state["geom"], objects, cam.viewproj, cam.zn, cam.zf,
                p.occ_width, p.occ_height, occluder_mask=vis)
            vis = vis & occlusion_cull_aabbs(occ_depth, cam.viewproj, wmin,
                                             wmax, cam.zn, cam.zf)
        hist = state.get("vis_history")
        if hist is None:
            # Start at hold_frames: an object never seen is not "recently
            # visible".
            hist = torch.full(vis.shape, p.hold_frames, dtype=torch.int64,
                              device=vis.device)
        new_hist, effective = update_visibility_history(
            hist, vis, hold_frames=p.hold_frames)
        out["vis_history"] = new_hist
        out["view_mask"] = effective & objects.visible
        if p.cull_lights and "lights" in state:
            lights = state["lights"]
            lmask = cull_lights_camera(lights, cam.viewproj,
                                       occ_depth=occ_depth, zn=cam.zn,
                                       zf=cam.zf)
            out["lights"] = dataclasses.replace(
                lights, enabled=lights.enabled & lmask)
        return out


class LocalShadowsPass(RenderPass):
    """The local shadow atlas: the budgeted spot slots and point cube faces
    (one kernel B1 launch a slot), their tables and the per-light planes'
    sampling data.  A light the camera cull disabled keeps all-far slots."""

    def __init__(self):
        super().__init__("local_shadows",
                         reads=("geom", "objects", "lights"),
                         writes=("local_shadow_maps",),
                         contract=STANDARD_CONTRACTS["local_shadows"])

    def execute_resolved(self, ctx, state, fp, request):
        p = fp.pass_params.local_shadow
        out = dict(state)
        if not (fp.enable_shadows and p.enabled
                and (p.spot_ids or p.point_ids)):
            out["local_shadow_maps"] = None
            return out
        lights = state["lights"]
        ids = list(p.spot_ids) + list(p.point_ids)
        caster_en = lights.enabled[device_const(
            ids, lights.enabled.device, torch.int64)]
        out["local_shadow_maps"] = render_local_shadow_maps(
            state["geom"], state["objects"], lights,
            spot_ids=tuple(p.spot_ids), point_ids=tuple(p.point_ids),
            map_size=p.map_size, point_size=p.point_size,
            pcf_radius=p.pcf_radius, bias_const=p.bias_const,
            bias_slope=p.bias_slope, vis_scale=p.vis_scale,
            vis_crop=tuple(p.vis_crop), caster_enabled=caster_en,
            filter_mode=p.filter_mode)
        return out


class SkyPass(RenderPass):
    """The procedural sky behind the scene: the frame's background plane
    ("sky"), which the lighting passes composite the covered pixels
    over."""

    def __init__(self):
        super().__init__("sky", reads=("camera",), writes=("sky",),
                         contract=STANDARD_CONTRACTS["sky"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        out["sky"] = render_sky(state["camera"].viewproj, fp.width,
                                fp.height, kind="procedural",
                                sun_dir_ws=state["shade_ctx"].light_dir_ws)
        return out


class ShadowMapPass(RenderPass):
    def __init__(self):
        super().__init__("shadow_map", reads=("geom", "objects"),
                         writes=("shadow_ctx",),
                         contract=STANDARD_CONTRACTS["shadow_map"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        out["shadow_ctx"] = None
        if fp.enable_shadows:
            out["shadow_ctx"] = make_sun_shadow(
                state["geom"], state["objects"],
                state["shade_ctx"].light_dir_ws, fp.pass_params.shadow)
        return out


class DepthPrepass(RenderPass):
    def __init__(self):
        super().__init__("depth_prepass", reads=("geom", "objects", "camera"),
                         writes=("depth", "tid", "setup"),
                         contract=STANDARD_CONTRACTS["depth_prepass"])

    def execute_resolved(self, ctx, state, fp, request):
        return _raster(state, fp, depth_only=True)


class GBufferPass(RenderPass):
    def __init__(self):
        super().__init__("gbuffer", reads=("geom", "objects", "camera"),
                         writes=("gbuffer", "depth", "tid", "velocity",
                                 "setup"),
                         contract=STANDARD_CONTRACTS["gbuffer"])

    def execute_resolved(self, ctx, state, fp, request):
        return _raster(state, fp)


class LightCullingPass(RenderPass):
    """Tiled light lists at technique.tile_size (with the tile depth range
    of the frame's depth buffer in TILED_DEPTH_RANGE mode).  The fused
    lighting bins its own 64x128 lists; the grid is the pass's product, as
    in lsr_tpu."""

    def __init__(self):
        super().__init__("light_culling",
                         reads=("lights", "camera"),
                         writes=("light_grid",),
                         contract=STANDARD_CONTRACTS["light_culling"])

    def execute_resolved(self, ctx, state, fp, request):
        cam = state["camera"]
        t = fp.technique
        tdr = None
        if (t.light_culling == LightCullingMode.TILED_DEPTH_RANGE
                and state.get("depth") is not None):
            tdr = tile_depth_ranges_from_buffer(
                state["depth"], cam.zn, cam.zf, fp.width, fp.height,
                t.tile_size)
        lists, counts, bin_stats = cull_lights_tiled(
            state["lights"], cam.view, cam.proj, fp.width, fp.height,
            tile_size=t.tile_size, cap=t.max_lights_per_tile,
            tile_depth_range=tdr)
        out = dict(state)
        out["light_grid"] = {"lists": lists, "counts": counts,
                             "max_count": bin_stats["max_count"],
                             "overflow_bins": bin_stats["overflow_bins"],
                             "slices": 1}
        return out


class ClusterBuildPass(RenderPass):
    """The cluster geometry (log-Z slice bounds); assignment comes next."""

    def __init__(self):
        super().__init__("cluster_build", reads=("camera",),
                         writes=("cluster_geom",),
                         contract=STANDARD_CONTRACTS["cluster_build"])

    def execute_resolved(self, ctx, state, fp, request):
        cam = state["camera"]
        out = dict(state)
        out["cluster_geom"] = {
            "bounds": cluster_slice_bounds(cam.zn, cam.zf,
                                           fp.technique.cluster_slices,
                                           cam.view.device),
            "slices": fp.technique.cluster_slices,
        }
        return out


class ClusterLightAssignPass(RenderPass):
    def __init__(self):
        super().__init__("cluster_light_assign",
                         reads=("lights", "camera", "cluster_geom"),
                         writes=("light_grid",),
                         contract=STANDARD_CONTRACTS["cluster_light_assign"])

    def execute_resolved(self, ctx, state, fp, request):
        cam = state["camera"]
        t = fp.technique
        lists, counts, bin_stats = cull_lights_clustered(
            state["lights"], cam.view, cam.proj, cam.zn, cam.zf, fp.width,
            fp.height, tile_size=t.tile_size, cap=t.max_lights_per_tile,
            slices=t.cluster_slices)
        count_occupancy("cluster_grid", counts, t.max_lights_per_tile,
                        bin_stats)
        out = dict(state)
        out["light_grid"] = {"lists": lists, "counts": counts,
                             "max_count": bin_stats["max_count"],
                             "overflow_bins": bin_stats["overflow_bins"],
                             "slices": t.cluster_slices}
        return out


class SsaoPass(RenderPass):
    """Depth-only AO after the depth prepass; reads "tid" so that it runs
    after the prepass raster (lsr_tpu's SsaoPass)."""

    def __init__(self):
        super().__init__("ssao", reads=("tid",), writes=("ssao_mask",),
                         contract=STANDARD_CONTRACTS["ssao"])

    def execute_resolved(self, ctx, state, fp, request):
        cam = state["camera"]
        out = dict(state)
        out["ssao_mask"] = ssao_depth_pass(state["depth"], state["tid"] >= 0,
                                           cam.zn, cam.zf)
        return out


class _LightingBase(RenderPass):
    """Sun + ambient + binned local lights: the fused branch (kernel B2 in
    the technique's mode: tiled, tiled depth range or clustered) or the
    general one (other sun models, debug views, SSAO modulation)."""

    def execute_resolved(self, ctx, state, fp, request):
        if fused_ok(state, fp):
            return fused_lighting(state, fp)
        return general_lighting(ctx, state, fp, request)


class ForwardPass(_LightingBase):
    def __init__(self):
        # optional ssao_mask: orders an ssao pass before the lighting when
        # the chain has one, without gating the chains that have none.
        super().__init__("pbr_forward",
                         reads=("geom", "objects", "camera", "shade_ctx"),
                         writes=("hdr", "gbuffer", "depth", "velocity"),
                         contract=STANDARD_CONTRACTS["pbr_forward"],
                         optional_reads=("ssao_mask",))

    def execute_resolved(self, ctx, state, fp, request):
        return super().execute_resolved(ctx, _raster(state, fp), fp, request)


class ForwardPlusPass(_LightingBase):
    def __init__(self, pass_id="pbr_forward_plus"):
        super().__init__(pass_id,
                         reads=("geom", "objects", "camera", "shade_ctx",
                                "light_grid"),
                         writes=("hdr", "gbuffer", "depth", "velocity"),
                         contract=STANDARD_CONTRACTS[pass_id])

    def execute_resolved(self, ctx, state, fp, request):
        return super().execute_resolved(ctx, _raster(state, fp), fp, request)


class ForwardClusteredPass(ForwardPlusPass):
    def __init__(self):
        super().__init__("pbr_forward_clustered")


class DeferredLightingPass(_LightingBase):
    def __init__(self, pass_id="deferred_lighting"):
        super().__init__(pass_id,
                         reads=("gbuffer", "shade_ctx", "camera"),
                         writes=("hdr",),
                         contract=STANDARD_CONTRACTS[pass_id])

    def execute_resolved(self, ctx, state, fp, request):
        if state.get("light_grid") is None:
            # Plain deferred bins internally, as lsr_tpu does.
            state = LightCullingPass().execute_resolved(ctx, state, fp,
                                                        request)
        return super().execute_resolved(ctx, state, fp, request)


class DeferredLightingTiledPass(DeferredLightingPass):
    def __init__(self):
        super().__init__("deferred_lighting_tiled")
        self._io = dataclasses.replace(
            self._io, reads=self._io.reads + ("light_grid",))


class TonemapPass(RenderPass):
    def __init__(self):
        super().__init__("tonemap", reads=("hdr",), writes=("ldr",),
                         contract=STANDARD_CONTRACTS["tonemap"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        out["ldr"] = tonemap_pass(state["hdr"],
                                  exposure=fp.pass_params.tonemap.exposure,
                                  gamma=fp.pass_params.tonemap.gamma)
        return out


class FxaaPass(RenderPass):
    def __init__(self):
        super().__init__("fxaa", reads=("ldr",), writes=("ldr",),
                         contract=STANDARD_CONTRACTS["fxaa"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if fp.enable_fxaa:
            out["ldr"] = fxaa_pass(state["ldr"])
        return out


class MotionBlurPass(RenderPass):
    """Velocity blur of the HDR frame (with fp.enable_motion_blur)."""

    def __init__(self):
        super().__init__("motion_blur", reads=("hdr", "velocity", "depth"),
                         writes=("hdr",),
                         contract=STANDARD_CONTRACTS["motion_blur"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_motion_blur:
            return out
        p = fp.pass_params.motion_blur
        out["hdr"] = motion_blur_pass(
            state["hdr"], state["depth"], state["velocity"], fp.dt,
            samples=p.samples, strength=p.strength,
            depth_reject=p.depth_reject)
        return out


class LightShaftsPass(RenderPass):
    """God rays toward the sun on the HDR frame (with
    fp.enable_light_shafts), lsr_tpu's default zoom-compose march."""

    def __init__(self):
        super().__init__("light_shafts", reads=("hdr", "depth"),
                         writes=("hdr",),
                         contract=STANDARD_CONTRACTS["light_shafts"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_light_shafts:
            return out
        sctx = state["shade_ctx"]
        p = fp.pass_params.light_shafts
        out["hdr"] = light_shafts_pass(
            state["hdr"], state["depth"], sctx.camera_pos, sctx.light_dir_ws,
            state["camera"].viewproj, steps=p.steps, density=p.density,
            weight=p.weight, decay=p.decay)
        return out


class DepthOfFieldPass(RenderPass):
    """Autofocus depth of field on the HDR frame (with fp.enable_dof)."""

    def __init__(self):
        super().__init__("depth_of_field", reads=("hdr", "depth"),
                         writes=("hdr",),
                         contract=STANDARD_CONTRACTS["depth_of_field"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_dof:
            return out
        p = fp.pass_params.dof
        out["hdr"] = depth_of_field_pass(
            state["hdr"], state["depth"], focus_depth=p.focus_depth,
            focus_range=p.focus_range, blur_radius=p.blur_radius)
        return out


class BloomPass(RenderPass):
    """Bright-pass bloom on the HDR frame (with fp.enable_bloom)."""

    def __init__(self):
        super().__init__("bloom", reads=("hdr",), writes=("hdr",),
                         contract=STANDARD_CONTRACTS["bloom"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_bloom:
            return out
        p = fp.pass_params.bloom
        out["hdr"] = bloom_pass(state["hdr"], threshold=p.threshold,
                                intensity=p.intensity,
                                blur_radius=p.blur_passes + 1)
        return out


class TaaPass(RenderPass):
    """Temporal AA (with fp.enable_taa).  The history is frame state under
    "history_color", a persistent key the pipeline carries to the next
    frame; the first frame's history is its own HDR."""

    def __init__(self):
        super().__init__("taa", reads=("hdr", "velocity"), writes=("hdr",),
                         contract=STANDARD_CONTRACTS["taa"])

    def execute_resolved(self, ctx, state, fp, request):
        out = dict(state)
        if not fp.enable_taa:
            return out
        hist = state.get("history_color")
        if hist is None:
            hist = state["hdr"]
        out["hdr"], out["history_color"] = taa_pass(
            state["hdr"], hist, state["velocity"],
            blend=fp.pass_params.taa.blend)
        return out


def make_standard_registry() -> PassFactoryRegistry:
    """Every pass id of lsr_tpu's make_standard_registry
    (standard_passes.py:747-782), with the same descriptors."""
    reg = PassFactoryRegistry()
    fp_modes = TechniqueMode.FORWARD_PLUS | TechniqueMode.TILED_DEFERRED
    reg.register("sky", SkyPass)
    reg.register("scene_cull", SceneCullPass)
    reg.register("shadow_map", ShadowMapPass)
    reg.register("local_shadows", LocalShadowsPass)
    reg.register("depth_prepass", DepthPrepass)
    reg.register("gbuffer", GBufferPass,
                 PassDescriptor(modes=TechniqueMode.DEFERRED
                                | TechniqueMode.TILED_DEFERRED))
    reg.register("light_culling", LightCullingPass,
                 PassDescriptor(modes=fp_modes))
    reg.register("cluster_build", ClusterBuildPass,
                 PassDescriptor(modes=TechniqueMode.CLUSTERED_FORWARD))
    reg.register("cluster_light_assign", ClusterLightAssignPass,
                 PassDescriptor(modes=TechniqueMode.CLUSTERED_FORWARD))
    reg.register("ssao", SsaoPass)
    reg.register("pbr_forward", ForwardPass,
                 PassDescriptor(modes=TechniqueMode.FORWARD))
    reg.register("pbr_forward_plus", ForwardPlusPass,
                 PassDescriptor(modes=TechniqueMode.FORWARD_PLUS))
    reg.register("pbr_forward_clustered", ForwardClusteredPass,
                 PassDescriptor(modes=TechniqueMode.CLUSTERED_FORWARD))
    reg.register("deferred_lighting", DeferredLightingPass,
                 PassDescriptor(modes=TechniqueMode.DEFERRED))
    reg.register("deferred_lighting_tiled", DeferredLightingTiledPass,
                 PassDescriptor(modes=TechniqueMode.TILED_DEFERRED))
    reg.register("tonemap", TonemapPass)
    reg.register("fxaa", FxaaPass)
    reg.register("motion_blur", MotionBlurPass)
    reg.register("light_shafts", LightShaftsPass)
    reg.register("depth_of_field", DepthOfFieldPass)
    reg.register("bloom", BloomPass)
    reg.register("taa", TaaPass)
    return reg
