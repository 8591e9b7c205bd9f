"""Shade context and the sun-only shading models (port of
lsr_tpu/shading/models.py): ShadeContext, make_shade_context, _ambient,
_norm, the blinn_phong and pbr_mr models that render_forward calls,
SHADING_MODELS and composite_over_background.

A sun shadow context (lighting/shadow_sample.py) in ShadeContext.shadow
scales the sun term by its visibility.  The stylized and debug models raise
NotImplementedError (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.lighting.shadow_sample import (
    ShadowContext,
    shadow_visibility_dir,
)
from lsr_tpu_torch.shading.common import (
    MaterialsSoA,
    eval_fake_ibl,
    gather_materials,
    pack_texture_quads,
    sample_texture_bilinear,
)

_PI = 3.14159265358979


@dataclasses.dataclass(frozen=True)
class ShadeContext:
    """Frame-level shading uniforms."""

    light_dir_ws: torch.Tensor     # (3,) direction FROM light TOWARD scene
    light_color: torch.Tensor      # (3,)
    light_intensity: torch.Tensor  # () scalar
    camera_pos: torch.Tensor       # (3,)
    materials: MaterialsSoA
    textures: torch.Tensor | None = None       # (NT, S, S, 3) linear
    shadow: ShadowContext | None = None        # sun shadow map, sampling
    texture_quads: torch.Tensor | None = None  # pack_texture_quads(textures)
    ibl: tuple | None = None                   # real IBL maps (not ported)
    surface_maps: bool = False  # host: any normal/ORM/emissive slot used


def make_shade_context(materials: MaterialsSoA, light_dir_ws=(0.0, -1.0, 0.0),
                       light_color=(1.0, 1.0, 1.0), light_intensity=1.0,
                       camera_pos=(0.0, 0.0, 0.0), textures=None,
                       device=None) -> ShadeContext:
    device = resolve_device(device)
    surface_maps = textures is not None and bool(
        (materials.normal_tex >= 0).any() or (materials.orm_tex >= 0).any()
        or (materials.emissive_tex >= 0).any())
    t = lambda x: torch.as_tensor(  # noqa: E731
        np.array(x, np.float32), device=device)
    return ShadeContext(
        light_dir_ws=t(light_dir_ws),
        light_color=t(light_color),
        light_intensity=t(light_intensity),
        camera_pos=t(camera_pos),
        materials=materials,
        textures=textures,
        texture_quads=None if textures is None else pack_texture_quads(textures),
        surface_maps=surface_maps,
    )


def _norm(v, eps=1e-12):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=eps)


def _ambient(ctx, n, v, albedo, metal, rough, ao):
    """Fake-IBL ambient (the reference's no-PMREM fallback).  Real IBL maps
    are not ported yet."""
    if ctx.ibl is not None:
        raise NotImplementedError("image-based lighting (ctx.ibl) is not "
                                  "ported to lsr_tpu_torch yet")
    return eval_fake_ibl(n, v, albedo, metal, rough, ao)


def _gather_material(gb, ctx):
    base, metal, rough, ao, emissive, tex_id = gather_materials(
        ctx.materials, gb.obj_id, mat_rec=gb.mat)
    if ctx.textures is not None:
        base = base * sample_texture_bilinear(ctx.textures, tex_id, gb.uv,
                                              quads=ctx.texture_quads)
    return torch.clamp(base, min=0.0), metal, rough, ao, emissive


def _common_vectors(gb, ctx):
    n = _norm(gb.normal_ws)
    l = _norm(-ctx.light_dir_ws)[None, None, :]  # noqa: E741
    v = _norm(ctx.camera_pos[None, None, :] - gb.world_pos)
    h = _norm(l + v)
    ndl = torch.clamp((n * l).sum(-1, keepdim=True), min=0.0)
    return n, l.expand(n.shape), v, h, ndl


def _shadow_term(gb, ctx, ndl):
    """Sun visibility (H, W, 1), sampled only where N.L > 0 (the shading
    is zero elsewhere anyway); 1 without a shadow context."""
    if ctx.shadow is None:
        return 1.0
    vis = shadow_visibility_dir(ctx.shadow, gb.world_pos, ndl[..., 0])
    return torch.where(ndl[..., 0] > 0.0, vis, torch.ones_like(vis))[..., None]


def shade_blinn_phong(gb, ctx: ShadeContext):
    """Normalized Blinn-Phong sun + fake IBL + emissive
    (lsr_tpu/shading/models.py:145-163)."""
    albedo, metal, rough, ao, emissive = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    ndh = torch.clamp((n * h).sum(-1, keepdim=True), min=0.0)
    rough_c = torch.clamp(rough, 0.0, 1.0)
    metal_c = torch.clamp(metal, 0.0, 1.0)
    spec_pow = torch.clamp(8.0 + (1.0 - rough_c) * 120.0, min=4.0)
    spec_norm = (spec_pow + 2.0) / (2.0 * _PI)
    spec_f0 = 0.04 + 0.96 * metal_c
    spec = torch.pow(ndh, spec_pow) * spec_norm * spec_f0 * ndl
    diffuse = (1.0 - metal_c) * albedo * (ndl / _PI)
    radiance = ctx.light_color[None, None, :] * ctx.light_intensity
    direct = (diffuse + spec) * radiance * _shadow_term(gb, ctx, ndl)
    return direct + _ambient(ctx, n, v, albedo, metal, rough, ao) + emissive


def shade_pbr_mr(gb, ctx: ShadeContext):
    """Cook-Torrance GGX / Smith-Schlick / Schlick metal-rough sun + fake
    IBL + emissive (lsr_tpu/shading/models.py:166-196)."""
    albedo, metal, rough, ao, emissive = _gather_material(gb, ctx)
    n, l, v, h, ndl = _common_vectors(gb, ctx)  # noqa: E741
    ndv = torch.clamp((n * v).sum(-1, keepdim=True), min=0.0)
    ndh = torch.clamp((n * h).sum(-1, keepdim=True), min=0.0)
    vdh = torch.clamp((v * h).sum(-1, keepdim=True), min=0.0)
    rough_c = torch.clamp(rough, 0.04, 1.0)
    metal_c = torch.clamp(metal, 0.0, 1.0)
    f0 = 0.04 + (albedo - 0.04) * metal_c
    a = rough_c * rough_c
    a2 = a * a
    denom_d = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / (_PI * denom_d * denom_d + 1e-7)
    k = (a + 1.0) * (a + 1.0) * 0.125

    def g1(ndx):
        return ndx / (ndx * (1.0 - k) + k + 1e-7)

    f = f0 + (1.0 - f0) * torch.pow(1.0 - vdh, 5.0)
    spec = (d * (g1(ndv) * g1(ndl))) * f \
        / torch.clamp(4.0 * ndl * ndv, min=1e-6)
    diff = (1.0 - f) * (1.0 - metal_c) * albedo * (1.0 / _PI)
    radiance = ctx.light_color[None, None, :] * ctx.light_intensity
    vis = _shadow_term(gb, ctx, ndl)
    lit = (ndl > 0.0) & (ndv > 0.0)
    direct = torch.where(lit, (diff + spec) * radiance * ndl * vis,
                         torch.zeros_like(diff))
    return direct + _ambient(ctx, n, v, albedo, metal_c, rough_c, ao) \
        + emissive


def _not_ported(name):
    def shade(gb, ctx):
        raise NotImplementedError(f"shading model {name!r} is not ported "
                                  "yet (ROADMAP A14)")
    return shade


SHADING_MODELS = {
    "blinn_phong": shade_blinn_phong,
    "pbr_mr": shade_pbr_mr,
    **{name: _not_ported(name) for name in (
        "flat", "lambert", "phong", "toon", "gooch", "oren_nayar",
        "debug_albedo", "debug_normal", "debug_depth")},
}


def composite_over_background(shaded, gb, background):
    """Covered pixels take the shaded color; others the background."""
    return torch.where(gb.covered[..., None], shaded, background)
