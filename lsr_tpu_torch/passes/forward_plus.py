"""Forward+ lighting pass, fused path (port of the fused branch of
lsr_tpu/passes/forward_plus.py:shade_forward_plus, :68-176).

Sun BRDF + binned local lights run in kernel B2 (lighting/shade_kernel.py);
ambient (fake IBL), emissive and the background stay torch ops.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import device_const
from lsr_tpu_torch.lighting.light_culling import tile_depth_ranges_from_buffer
from lsr_tpu_torch.lighting.shade_kernel import SUN_MODELS, shade_fused
from lsr_tpu_torch.shading.common import gather_materials, sample_texture_bilinear
from lsr_tpu_torch.shading.models import _ambient, _norm, composite_over_background


def shade_forward_plus(gb, ctx, lights, view, proj, zn, zf, width: int,
                       height: int, tile_size: int = 16, cap: int = 128,
                       chunk: int = 8, mode: str = "tiled", slices: int = 16,
                       sun_model: str = "pbr_mr",
                       background=(0.04, 0.06, 0.1), use_kernel: bool = True,
                       local_shadows=None, env_probes: bool = False,
                       sun_vis_scale: int = 1):
    """Full lit HDR frame from a G-buffer + light set.
    Returns (hdr (H, W, 3), stats dict of tensors).

    The fused kernel bins lights per 64x128 tile with twice the per-16px-tile
    cap (cap * 2), as lsr_tpu does; tile_size / chunk / slices belong to the
    paths not ported yet."""
    if not use_kernel:
        raise NotImplementedError("shade_forward_plus: the XLA accumulation "
                                  "path (use_kernel=False) is not ported")
    if mode == "clustered":
        raise NotImplementedError("shade_forward_plus: mode='clustered' is "
                                  "not ported yet")
    if mode not in ("tiled", "tiled_depth_range"):
        raise ValueError(f"shade_forward_plus: unknown mode {mode!r}")
    if sun_model not in SUN_MODELS:
        raise NotImplementedError(f"shade_forward_plus: sun_model "
                                  f"{sun_model!r} is not on the fused path")
    if ctx.surface_maps:
        raise NotImplementedError("shade_forward_plus: normal/ORM/emissive "
                                  "surface maps are not ported yet")
    if env_probes:
        raise NotImplementedError("shade_forward_plus: env_probes are not "
                                  "ported yet")
    if local_shadows is not None:
        raise NotImplementedError("shade_forward_plus: local_shadows are not "
                                  "ported yet")
    if ctx.shadow is not None:
        raise NotImplementedError("shade_forward_plus: sun shadow maps are "
                                  "not ported yet (ctx.shadow must be None)")

    mat_base, metal, rough, ao, emissive, tex_id = gather_materials(
        ctx.materials, gb.obj_id, mat_rec=gb.mat)
    albedo = mat_base
    if ctx.textures is not None:
        albedo = albedo * sample_texture_bilinear(
            ctx.textures, tex_id, gb.uv, quads=ctx.texture_quads)
    albedo = torch.clamp(albedo, min=0.0)
    n = _norm(gb.normal_ws)
    vis = torch.ones_like(gb.depth01)      # no sun shadow map: visibility 1

    tdr = None
    if mode == "tiled_depth_range":
        tdr = tile_depth_ranges_from_buffer(gb.depth01, zn, zf, width, height,
                                            128, tile_h=64)
    lit, bin_stats = shade_fused(
        gb.world_pos, n, gb.covered, albedo, metal[..., 0], rough[..., 0], vis,
        ctx.camera_pos, ctx.light_dir_ws, ctx.light_color * ctx.light_intensity,
        lights, view, proj, width, height, tile_h=64, tile_w=128,
        cap=cap * 2, chunk=8, tile_depth_range=tdr, sun_model=sun_model)
    v = _norm(ctx.camera_pos[None, None, :] - gb.world_pos)
    amb = _ambient(ctx, n, v, albedo, metal, rough, ao) + emissive
    hdr = lit + torch.where(gb.covered[..., None], amb, torch.zeros_like(amb))
    bg = device_const(background, hdr.device).expand(hdr.shape)
    hdr = composite_over_background(hdr, gb, bg)
    return hdr, {"max_lights_per_bin": bin_stats["max_count"],
                 "overflow_bins": bin_stats["overflow_bins"],
                 "total_bins": 0}
