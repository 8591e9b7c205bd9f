"""Forward+ lighting passes (port of lsr_tpu/passes/forward_plus.py:
shade_forward_plus, both branches; the reference holds no resolve route).

shade_forward_plus shades a G-buffer.  Its fused branch computes sun BRDF x
sun shadow visibility + binned local lights x their local-shadow planes in
kernel B2 (lighting/shade_kernel.py); ambient (fake or real IBL), emissive,
the environment probes and the background stay torch ops.  Its general
branch (other sun models, use_kernel=False) is torch ops throughout: the
shading model for the sun, accumulate_local_lights for the local lights.
Both take local_shadows, a lighting.local_shadows.LocalShadowMaps.
"""

from __future__ import annotations

import dataclasses

import torch

from renderbench.reference.core.image import resize_bilinear
from renderbench.reference.core.util import device_const, f32_on
from renderbench.reference.lighting.light_culling import (
    cull_lights_clustered,
    cull_lights_tiled,
    tile_depth_ranges_from_buffer,
    view_depth_to_cluster_slice,
)
from renderbench.reference.lighting.light_runtime import (
    accumulate_local_lights,
    eval_env_probes,
)
from renderbench.reference.lighting.local_shadows import (
    local_shadow_vis_planes,
    local_shadow_vis_stack,
)
from renderbench.reference.lighting.shade_kernel import SUN_MODELS, shade_fused
from renderbench.reference.lighting.shadow_sample import shadow_visibility_dir
from renderbench.reference.raster.interp import (
    pack_interp_records,
    reconstruct_world_pos,
)
from renderbench.reference.shading.common import (
    apply_surface_maps,
    gather_material_texture_slots,
    gather_materials,
    sample_texture_bilinear,
)
from renderbench.reference.shading.models import (
    SHADING_MODELS,
    _ambient,
    _norm,
    composite_over_background,
)


def _sun_visibility(ctx, world_pos, n, like, sun_vis_scale):
    """Sun visibility per pixel: the shadow map sampled where N.L > 0, 1
    elsewhere and without a shadow context.  sun_vis_scale > 1 samples
    every sc-th pixel of every sc-th row and upsamples bilinearly
    (lsr_tpu/passes/forward_plus.py:99-107, :349-355)."""
    if ctx.shadow is None:
        return torch.ones_like(like)
    l_dir = _norm(-ctx.light_dir_ws)
    ndl = torch.clamp((n * l_dir[None, None]).sum(-1), min=0.0)
    sc = int(sun_vis_scale)
    if sc > 1:
        vis = resize_bilinear(shadow_visibility_dir(
            ctx.shadow, world_pos[::sc, ::sc], ndl[::sc, ::sc]), ndl.shape)
    else:
        vis = shadow_visibility_dir(ctx.shadow, world_pos, ndl)
    return torch.where(ndl > 0.0, vis, torch.ones_like(vis))


def _fused_ok(use_kernel, mode, sun_model):
    """Whether shade_forward_plus takes lsr_tpu's fused branch (kernel
    B2) or its general one (lsr_tpu/passes/forward_plus.py:68-71)."""
    return (use_kernel and mode in ("tiled", "tiled_depth_range", "clustered")
            and sun_model in SUN_MODELS)


def shade_forward_plus(gb, ctx, lights, view, proj, zn, zf, width: int,
                       height: int, tile_size: int = 16, cap: int = 128,
                       chunk: int = 8, mode: str = "tiled", slices: int = 16,
                       sun_model: str = "pbr_mr",
                       background=(0.04, 0.06, 0.1), use_kernel: bool = True,
                       local_shadows=None, env_probes: bool = False,
                       sun_vis_scale: int = 1):
    """Full lit HDR frame from a G-buffer + light set.
    Returns (hdr (H, W, 3), stats dict of tensors; on the fused branch
    stats["sun_vis"] is the (H, W) sun visibility, else None).

    The fused branch (use_kernel, mode "tiled", "tiled_depth_range" or
    "clustered", sun model pbr_mr or blinn_phong) lights in kernel B2: it
    bins lights per 64x128 tile with twice the per-16px-tile cap (cap * 2),
    as lsr_tpu does; mode "clustered" bins them per (64x128 tile, log-Z
    slice) of `slices` slices and shades each pixel with its own slice's
    lights (B2's variant B2b).  Otherwise the general branch shades the sun
    with SHADING_MODELS[sun_model] and sums the local lights binned per
    tile_size tile (per cluster in mode "clustered") with
    accumulate_local_lights, `chunk` list slots at a time.  Both apply the
    context's surface maps and, with env_probes, the environment probes."""
    if _fused_ok(use_kernel, mode, sun_model):
        return _shade_fused_branch(gb, ctx, lights, view, proj, zn, zf,
                                   width, height, cap, mode, slices,
                                   sun_model, background, local_shadows,
                                   env_probes, sun_vis_scale)
    return _shade_general_branch(gb, ctx, lights, view, proj, zn, zf, width,
                                 height, tile_size, cap, chunk, mode, slices,
                                 sun_model, background, local_shadows,
                                 env_probes)


def _materials(gb, ctx):
    """(albedo (textured, >= 0), metal, rough, ao, emissive, tex_id) per
    pixel."""
    base, metal, rough, ao, emissive, tex_id = gather_materials(
        ctx.materials, gb.obj_id, mat_rec=gb.mat)
    if ctx.textures is not None:
        base = base * sample_texture_bilinear(ctx.textures, tex_id, gb.uv,
                                              quads=ctx.texture_quads)
    return torch.clamp(base, min=0.0), metal, rough, ao, emissive


def _surface_maps(gb, ctx, n, metal, rough, ao, emissive):
    """The normal / ORM / emissive texture slots applied to n and the
    material factors (shading.common.apply_surface_maps)."""
    ntex, otex, etex = gather_material_texture_slots(
        ctx.materials, gb.obj_id, mat_rec=gb.mat)
    return apply_surface_maps(ctx.textures, ctx.texture_quads, gb.uv,
                              gb.tangent, n, ntex, otex, etex, metal, rough,
                              ao, emissive)


def _shade_fused_branch(gb, ctx, lights, view, proj, zn, zf, width, height,
                        cap, mode, slices, sun_model, background,
                        local_shadows, env_probes, sun_vis_scale):
    """lsr_tpu/passes/forward_plus.py:68-176: sun and binned local lights
    in kernel B2; ambient, emissive, the probes and the background in
    torch."""
    albedo, metal, rough, ao, emissive = _materials(gb, ctx)
    n = _norm(gb.normal_ws)
    if ctx.surface_maps:
        n, metal, rough, ao, emissive = _surface_maps(gb, ctx, n, metal,
                                                      rough, ao, emissive)
    vis = _sun_visibility(ctx, gb.world_pos, n, gb.depth01, sun_vis_scale)

    tdr = slice_plane = None
    if mode == "tiled_depth_range":
        tdr = tile_depth_ranges_from_buffer(gb.depth01, zn, zf, width, height,
                                            128, tile_h=64)
    if mode == "clustered":
        slice_plane = _cluster_of_pixel(gb.depth01, zn, zf, slices)
    local_vis = shadow_idx = None
    if local_shadows is not None:
        local_vis = local_shadow_vis_stack(local_shadows, gb.world_pos, n)
        shadow_idx = local_shadows.light_shadow_index
    lit, bin_stats = shade_fused(
        gb.world_pos, n, gb.covered, albedo, metal[..., 0], rough[..., 0], vis,
        ctx.camera_pos, ctx.light_dir_ws, ctx.light_color * ctx.light_intensity,
        lights, view, proj, width, height, tile_h=64, tile_w=128,
        cap=cap * 2, chunk=8, tile_depth_range=tdr, sun_model=sun_model,
        local_vis_stack=local_vis, light_shadow_index=shadow_idx,
        cluster_slice_plane=slice_plane,
        slices=slices if mode == "clustered" else 0, zn=zn, zf=zf)
    v = _norm(ctx.camera_pos[None, None, :] - gb.world_pos)
    amb = _ambient(ctx, n, v, albedo, metal, rough, ao) + emissive
    if env_probes:
        amb = amb + eval_env_probes(lights, gb.world_pos, amb - emissive)
    hdr = lit + torch.where(gb.covered[..., None], amb, torch.zeros_like(amb))
    bg = device_const(background, hdr.device).expand(hdr.shape)
    hdr = composite_over_background(hdr, gb, bg)
    return hdr, {"max_lights_per_bin": bin_stats["max_count"],
                 "overflow_bins": bin_stats["overflow_bins"],
                 "total_bins": 0, "sun_vis": vis, "local_vis": local_vis}


def _cluster_of_pixel(depth01, zn, zf, slices):
    """The log-Z slice of each pixel's view depth (zn / zf: 0-d f32
    tensors, or host numbers as memoised constants)."""
    zn_t, zf_t = f32_on(zn, depth01.device), f32_on(zf, depth01.device)
    return view_depth_to_cluster_slice(zn_t + depth01 * (zf_t - zn_t), zn_t,
                                       zf_t, slices)


def _shade_general_branch(gb, ctx, lights, view, proj, zn, zf, width, height,
                          tile_size, cap, chunk, mode, slices, sun_model,
                          background, local_shadows, env_probes):
    """lsr_tpu/passes/forward_plus.py:179-287: the sun by the shading model,
    the local lights binned per tile_size tile (or cluster) and summed by
    accumulate_local_lights, all torch ops."""
    if ctx.surface_maps:
        # The mapped normal replaces the G-buffer's, and the mapped
        # material reaches the sun model and the combine through
        # ctx.mat_override, as on the fused branch.
        base, metal, rough, ao, emissive = _materials(gb, ctx)
        n, metal, rough, ao, emissive = _surface_maps(
            gb, ctx, _norm(gb.normal_ws), metal, rough, ao, emissive)
        gb = dataclasses.replace(gb, normal_ws=n)
        ctx = dataclasses.replace(ctx, mat_override=(
            base, metal, rough, ao, emissive))
    base_hdr = SHADING_MODELS[sun_model](gb, ctx)

    vis_stack = shadow_index = None
    if local_shadows is not None:
        vis_stack = local_shadow_vis_stack(local_shadows, gb.world_pos,
                                           gb.normal_ws)
        shadow_index = local_shadows.light_shadow_index
    if mode == "clustered":
        lists, counts, bin_stats = cull_lights_clustered(
            lights, view, proj, zn, zf, width, height, tile_size=tile_size,
            cap=cap, slices=slices)
        cluster = _cluster_of_pixel(gb.depth01, zn, zf, slices)
    else:
        tdr = None
        if mode == "tiled_depth_range":
            tdr = tile_depth_ranges_from_buffer(gb.depth01, zn, zf, width,
                                                height, tile_size)
        lists, counts, bin_stats = cull_lights_tiled(
            lights, view, proj, width, height, tile_size=tile_size, cap=cap,
            tile_depth_range=tdr)
        cluster, slices = None, 1
    diff, spec = accumulate_local_lights(
        gb.world_pos, gb.normal_ws, ctx.camera_pos, lights, lists, width,
        height, tile_size=tile_size, chunk=chunk, cluster_of_pixel=cluster,
        slices=slices, shadow_vis_stack=vis_stack,
        light_shadow_index=shadow_index)
    if ctx.mat_override is not None:
        albedo, metal, rough, ao = ctx.mat_override[:4]
    else:
        albedo, metal, rough, ao, _ = _materials(gb, ctx)
    hdr = base_hdr + (albedo * diff + spec)
    if env_probes:
        n = _norm(gb.normal_ws)
        v = _norm(ctx.camera_pos[None, None, :] - gb.world_pos)
        probe = eval_env_probes(lights, gb.world_pos,
                                _ambient(ctx, n, v, albedo, metal, rough, ao))
        hdr = hdr + torch.where(gb.covered[..., None], probe,
                                torch.zeros_like(probe))
    bg = device_const(background, hdr.device).expand(hdr.shape)
    hdr = composite_over_background(hdr, gb, bg)
    return hdr, {"max_lights_per_bin": bin_stats["max_count"],
                 "overflow_bins": bin_stats["overflow_bins"],
                 "total_bins": counts.shape[0], "sun_vis": None,
                 "local_vis": vis_stack}
