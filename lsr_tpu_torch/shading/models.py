"""Shade context and the pieces of lsr_tpu/shading/models.py that the
forward+ frame uses: ShadeContext, make_shade_context, _ambient, _norm,
composite_over_background.

Sun shadow maps are not ported yet: ShadeContext.shadow stays None and the
fused shade path treats sun visibility as 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsr_tpu_torch.shading.common import (
    MaterialsSoA,
    eval_fake_ibl,
    pack_texture_quads,
)


@dataclasses.dataclass(frozen=True)
class ShadeContext:
    """Frame-level shading uniforms."""

    light_dir_ws: torch.Tensor     # (3,) direction FROM light TOWARD scene
    light_color: torch.Tensor      # (3,)
    light_intensity: torch.Tensor  # () scalar
    camera_pos: torch.Tensor       # (3,)
    materials: MaterialsSoA
    textures: torch.Tensor | None = None       # (NT, S, S, 3) linear
    shadow: object | None = None               # sun shadow context (not ported)
    texture_quads: torch.Tensor | None = None  # pack_texture_quads(textures)
    ibl: tuple | None = None                   # real IBL maps (not ported)
    surface_maps: bool = False  # host: any normal/ORM/emissive slot used


def make_shade_context(materials: MaterialsSoA, light_dir_ws=(0.0, -1.0, 0.0),
                       light_color=(1.0, 1.0, 1.0), light_intensity=1.0,
                       camera_pos=(0.0, 0.0, 0.0), textures=None,
                       device=None) -> ShadeContext:
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


def composite_over_background(shaded, gb, background):
    """Covered pixels take the shaded color; others the background."""
    return torch.where(gb.covered[..., None], shaded, background)
