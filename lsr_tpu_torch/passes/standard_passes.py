"""The camera raster and the fused forward+ lighting of the standard passes
(port of lsr_tpu/passes/standard_passes.py: _raster, _background and the
fused branch of _LightingBase.execute_resolved, :24-132 and :484-515).

Frame state is a dict of named tensors; scene inputs come under "geom",
"objects", "lights", "shade_ctx" and "camera".  The RenderPass / registry
framework around these functions is not ported yet (ROADMAP A13).

Two repairs against lsr_tpu, both following lsr_tpu's own contracts:
- a compact setup that overflowed its caps falls back to scene_setup (the
  scene_setup_compact docstring), instead of rasterizing with dropped rows;
- the binned raster's list cap is raised to the scene's largest bin before
  the launch (scripts/bench_highpoly.py:94-103), instead of dropping
  triangles past raster_cap.
Both are recorded in state["raster_stats"] (compact_fallback,
raster_cap_used).
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
from lsr_tpu_torch.passes.forward_plus import shade_forward_plus
from lsr_tpu_torch.raster import tiled
from lsr_tpu_torch.raster.brute import rasterize_brute
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import scene_setup, scene_setup_compact


def _with_gbuffer(out, setup, depth, tid, fp: FrameParams):
    """Adds the G-buffer and a zero velocity plane to the state dict."""
    if fp.enable_motion_vectors:
        raise NotImplementedError("motion vectors are not ported yet "
                                  "(ROADMAP A14)")
    out["gbuffer"] = interpolate_gbuffer(
        setup, depth, tid, materials=out["shade_ctx"].materials)
    out["velocity"] = torch.zeros((fp.height, fp.width, 2),
                                  dtype=torch.float32, device=depth.device)
    return out


def _raster(state, fp: FrameParams, depth_only: bool = False):
    """Camera raster: setup (compact above fp.compact_setup_threshold input
    triangles) -> B1 up to tiled.DIRECT_ROW_LIMIT setup rows, B3 above ->
    G-buffer.  Returns a new state dict."""
    # Reuse an earlier raster of the same frame (a depth prepass): the
    # visibility buffer is complete, so only interpolation runs.
    if ("depth" in state and "tid" in state and "setup" in state
            and not depth_only):
        return _with_gbuffer(dict(state), state["setup"], state["depth"],
                             state["tid"], fp)
    geom, objects, cam = state["geom"], state["objects"], state["camera"]
    view_mask = state.get("view_mask", objects.visible)
    args = (geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, fp.width, fp.height)
    stats = {"tri_input": geom.indices.shape[0]}
    setup = None
    if geom.indices.shape[0] > fp.compact_setup_threshold:
        setup, cstats = scene_setup_compact(
            *args, cull_mode=fp.cull_mode, obj_visible=view_mask,
            cap_fraction=fp.compact_cap_fraction)
        fallback = bool(cstats.overflow)
        stats.update(compact_overflow=cstats.overflow,
                     compact_n_direct=cstats.n_direct,
                     compact_n_clip=cstats.n_clip,
                     compact_fallback=fallback)
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
        depth, tid, max_bin = tiled.rasterize_tiled(
            setup, fp.width, fp.height, cam.zn, cam.zf,
            tile_h=fp.raster_tile_h, tile_w=fp.raster_tile_w,
            cap=fp.raster_cap, chunk=fp.raster_chunk, fit_cap=True)
        stats.update(raster_cap_used=tiled.fitted_cap(fp.raster_cap,
                                                      int(max_bin)),
                     raster_max_bin=max_bin)
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


def fused_lighting(state, fp: FrameParams):
    """The fused branch of lsr_tpu's lighting passes (sun + binned local
    lights through kernel B2, ambient, emissive, the frame's background).
    Returns a new state dict with "hdr"."""
    t = fp.technique
    if (fp.debug_view != DebugViewMode.NONE
            or fp.shading_model not in ("pbr_mr", "blinn_phong")
            or state.get("ssao_mask") is not None):
        raise NotImplementedError(
            "lighting: only the fused forward+ branch (pbr_mr / blinn_phong, "
            "no debug view, no SSAO) is ported (ROADMAP A13, A14)")
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
