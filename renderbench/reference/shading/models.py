"""Shade context and the sun-only shading models (port of
lsr_tpu/shading/models.py): ShadeContext, make_shade_context, _ambient,
the blinn_phong and pbr_mr models, the stylized family (flat, lambert,
phong, toon, gooch, oren_nayar, and gouraud, which render_forward calls
with the setup), the debug views, SHADING_MODELS and
composite_over_background.

A sun shadow context (lighting/shadow_sample.py) in ShadeContext.shadow
scales the sun term of blinn_phong and pbr_mr by its visibility; real IBL
maps in ShadeContext.ibl (resources/ibl.py) replace the fake-IBL ambient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from renderbench.reference.core.util import device_const, resolve_device
from renderbench.reference.lighting.shadow_sample import (
    ShadowContext,
    shadow_visibility_dir,
)
from renderbench.reference.resources.ibl import eval_ibl
from renderbench.reference.shading.common import (
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
    ibl: tuple | None = None    # (irradiance faces, (prefiltered mips...))
    mat_override: tuple | None = None  # per-pixel (albedo, metal, rough,
                                # ao, emissive) after the surface maps, read
                                # by every model in place of the materials
    surface_maps: bool = False  # host: any normal/ORM/emissive slot used


def make_shade_context(materials: MaterialsSoA, light_dir_ws=(0.0, -1.0, 0.0),
                       light_color=(1.0, 1.0, 1.0), light_intensity=1.0,
                       camera_pos=(0.0, 0.0, 0.0), textures=None,
                       shadow=None, ibl=None, device=None) -> ShadeContext:
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
        shadow=shadow,
        texture_quads=None if textures is None else pack_texture_quads(textures),
        ibl=ibl,
        surface_maps=surface_maps,
    )


def _norm(v, eps=1e-12):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=eps)


def _ambient(ctx, n, v, albedo, metal, rough, ao):
    """Real IBL when the context has maps, the fake approximation (the
    reference's no-PMREM fallback) otherwise."""
    if ctx.ibl is not None:
        irr, pref = ctx.ibl
        return eval_ibl(irr, list(pref), n, v, albedo, metal, rough, ao)
    return eval_fake_ibl(n, v, albedo, metal, rough, ao)


def _gather_material(gb, ctx):
    if ctx.mat_override is not None:
        return ctx.mat_override
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


def shade_flat(gb, ctx: ShadeContext):
    """Lambert from the triangle's face normal (constant per face)."""
    albedo = _gather_material(gb, ctx)[0]
    n = _norm(gb.face_normal)
    l = _norm(-ctx.light_dir_ws)[None, None, :]  # noqa: E741
    ndl = torch.clamp((n * l).sum(-1, keepdim=True), min=0.0)
    return albedo * ndl * ctx.light_color * ctx.light_intensity


def shade_lambert(gb, ctx: ShadeContext):
    albedo = _gather_material(gb, ctx)[0]
    ndl = _common_vectors(gb, ctx)[4]
    return albedo * ndl * ctx.light_color * ctx.light_intensity


def shade_phong(gb, ctx: ShadeContext, shininess: float = 32.0,
                ambient: float = 0.08, spec_strength: float = 0.5):
    albedo = _gather_material(gb, ctx)[0]
    n, l, v, _, ndl = _common_vectors(gb, ctx)  # noqa: E741
    r = _norm(2.0 * (n * l).sum(-1, keepdim=True) * n - l)
    rdv = torch.clamp((r * v).sum(-1, keepdim=True), min=0.0)
    spec = spec_strength * torch.pow(rdv, shininess)
    return ((ambient + ndl) * albedo + spec) * ctx.light_color * ctx.light_intensity


def shade_toon(gb, ctx: ShadeContext, bands: int = 4, ambient: float = 0.12):
    albedo = _gather_material(gb, ctx)[0]
    ndl = _common_vectors(gb, ctx)[4]
    q = torch.ceil(ndl * bands) / bands
    return (ambient + q) * albedo * ctx.light_color * ctx.light_intensity


def shade_gooch(gb, ctx: ShadeContext, alpha: float = 0.25,
                beta: float = 0.5):
    albedo = _gather_material(gb, ctx)[0]
    n, l, v, _, _ = _common_vectors(gb, ctx)  # noqa: E741
    ndl_s = (n * l).sum(-1, keepdim=True)    # signed
    t = (ndl_s + 1.0) * 0.5
    cool = device_const([0.0, 0.0, 0.55], albedo.device) + alpha * albedo
    warm = device_const([0.3, 0.3, 0.0], albedo.device) + beta * albedo
    r = _norm(2.0 * ndl_s * n - l)
    rdv = torch.clamp((r * v).sum(-1, keepdim=True), min=0.0)
    return cool + (warm - cool) * t + torch.pow(rdv, 32.0)


def shade_gouraud(setup, gb, ctx: ShadeContext, shininess: float = 24.0,
                  ambient: float = 0.08, spec_strength: float = 0.35):
    """Blinn-Phong at the winning triangle's corners, interpolated with the
    pixel's perspective-correct barycentrics (vertex lighting)."""
    rows = torch.clamp(gb.tri_id.to(torch.int64), 0, setup.wp.shape[0] - 1)
    wp_c = setup.wp[rows]                     # (H, W, 3, 3)
    nw_c = _norm(setup.nw[rows])
    l = _norm(-ctx.light_dir_ws)[None, None, None, :]  # noqa: E741
    v = _norm(ctx.camera_pos[None, None, None, :] - wp_c)
    h = _norm(l + v)
    ndl = torch.clamp((nw_c * l).sum(-1, keepdim=True), min=0.0)
    ndh = torch.clamp((nw_c * h).sum(-1, keepdim=True), min=0.0)
    albedo = _gather_material(gb, ctx)[0]
    corner = (ambient + ndl) * albedo[..., None, :] \
        + spec_strength * torch.pow(ndh, shininess)
    lit = (corner * gb.bary[..., None]).sum(-2)
    return lit * ctx.light_color * ctx.light_intensity


def shade_oren_nayar(gb, ctx: ShadeContext, sigma: float = 0.35):
    albedo = _gather_material(gb, ctx)[0]
    n, l, v, _, ndl = _common_vectors(gb, ctx)  # noqa: E741
    ndv = (n * v).sum(-1, keepdim=True)
    s2 = sigma * sigma
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    theta_i = torch.arccos(torch.clamp(ndl, -1.0, 1.0))
    theta_r = torch.arccos(torch.clamp(ndv, -1.0, 1.0))
    alpha = torch.maximum(theta_i, theta_r)
    beta = torch.minimum(theta_i, theta_r)
    lp = _norm(l - ndl * n)
    vp = _norm(v - ndv * n)
    cos_phi = torch.clamp((lp * vp).sum(-1, keepdim=True), min=0.0)
    f = a + b * cos_phi * torch.sin(alpha) * torch.tan(beta)
    return albedo * ndl * f * ctx.light_color * ctx.light_intensity


def shade_debug_albedo(gb, ctx: ShadeContext):
    """The material's base color (untextured) per pixel."""
    table = ctx.materials.base_color
    rows = torch.clamp(gb.obj_id, 0, table.shape[0] - 1)
    return table[rows].expand(gb.world_pos.shape)


def shade_debug_normal(gb, ctx: ShadeContext):
    return _norm(gb.normal_ws) * 0.5 + 0.5


def shade_debug_depth(gb, ctx: ShadeContext):
    d = torch.clamp(gb.depth01, 0.0, 1.0)[..., None]
    return d.expand(gb.depth01.shape + (3,))


SHADING_MODELS = {
    "blinn_phong": shade_blinn_phong,
    "pbr_mr": shade_pbr_mr,
    "flat": shade_flat,
    "lambert": shade_lambert,
    "phong": shade_phong,
    "toon": shade_toon,
    "gooch": shade_gooch,
    "oren_nayar": shade_oren_nayar,
    "debug_albedo": shade_debug_albedo,
    "debug_normal": shade_debug_normal,
    "debug_depth": shade_debug_depth,
}


def composite_over_background(shaded, gb, background):
    """Covered pixels take the shaded color; others the background."""
    return torch.where(gb.covered[..., None], shaded, background)
