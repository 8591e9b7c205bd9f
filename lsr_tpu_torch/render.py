"""Convenience forward-render entry points (port of lsr_tpu/render.py).

One frame: geometry setup -> raster -> G-buffer interp -> shading model ->
background composite -> tonemap.  The raster takes kernel B1
(rasterize_direct) up to tiled.DIRECT_ROW_LIMIT setup rows and kernel B3
(rasterize_tiled) above it, with the list cap raised to the scene's
largest bin so that no triangle is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.util import device_const, resolve_device
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.raster import tiled
from lsr_tpu_torch.raster.brute import rasterize_brute
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import scene_setup
from lsr_tpu_torch.scene.scene import concat_scene, morton_order  # noqa: F401
from lsr_tpu_torch.shading.models import (
    SHADING_MODELS,
    composite_over_background,
    shade_gouraud,
)


def upload_mesh(mesh, device=None):
    """Host MeshData -> dict of device tensors (indices as int64)."""
    device = resolve_device(device)
    return dict(
        positions=torch.as_tensor(mesh.positions, device=device),
        normals=torch.as_tensor(mesh.normals, device=device),
        uvs=torch.as_tensor(mesh.uvs, device=device),
        indices=torch.as_tensor(np.asarray(mesh.indices, np.int64),
                                device=device),
    )


def render_forward(batch, models, normal_mats, viewproj, zn: float, zf: float,
                   shade_ctx, width: int, height: int,
                   model_name: str = "blinn_phong",
                   background=(0.05, 0.07, 0.12), use_tiled: bool = True,
                   cap: int = 1024, exposure: float = 1.0,
                   gamma: float = 2.2):
    """One full forward frame.  Returns (ldr_u8 (H, W, 3), gbuffer).

    batch: dict of tensors positions / normals / uvs / indices / vtx_obj /
    tri_obj (concat_scene's columns on the device).  model_name: a key of
    SHADING_MODELS, or "gouraud" (vertex lighting from the setup)."""
    setup = scene_setup(
        batch["positions"], batch["normals"], batch["uvs"], batch["indices"],
        batch["vtx_obj"], batch["tri_obj"], models, normal_mats, viewproj,
        width, height)
    if not use_tiled:
        depth, tid = rasterize_brute(setup, width, height, zn, zf)
    elif setup.count <= tiled.DIRECT_ROW_LIMIT:
        depth, tid, _ = tiled.rasterize_direct(setup, width, height, zn, zf)
    else:
        # rasterize_tiled's default 32x128 tiles, as lsr_tpu calls it.
        depth, tid, _ = tiled.rasterize_tiled(setup, width, height, zn, zf,
                                              tile_h=32, tile_w=128, cap=cap,
                                              fit_cap=True)
    gb = interpolate_gbuffer(setup, depth, tid, materials=shade_ctx.materials)
    if model_name == "gouraud":
        shaded = shade_gouraud(setup, gb, shade_ctx)
    else:
        shaded = SHADING_MODELS[model_name](gb, shade_ctx)
    bg = device_const(background, shaded.device).expand(shaded.shape)
    hdr = composite_over_background(shaded, gb, bg)
    return tonemap_pass(hdr, exposure=exposure, gamma=gamma), gb


def simple_camera(width, height, eye, target, fov=np.pi / 3, zn=0.1,
                  zf=100.0, up=(0, 1, 0), device=None):
    """(viewproj (4, 4), zn, zf) of a look-at perspective camera; zn / zf
    come back as the float32 values the raster uses."""
    device = resolve_device(device)
    view = m3.look_at_lh(eye, target, up, device=device)
    proj = m3.perspective_lh_no(fov, width / height, zn, zf, device=device)
    return m3.matmul4(proj, view), float(np.float32(zn)), float(np.float32(zf))
