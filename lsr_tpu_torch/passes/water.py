"""Water rendering: planar reflection + Fresnel + ripple (port of
lsr_tpu/passes/water.py: mirror_matrix_y, mirrored_camera, shade_water).

The hello_water capability (hello-render-target/hello_water.cpp): the scene
is rendered again with the camera mirrored about the water plane into a
reflection target; the water surface then mixes a ripple-distorted sample
of that target with the water tint by a Fresnel term.

The ripple offset is rounded to a whole pixel of the reflection target, so
a 1-ulp difference in the noise near a half pixel picks the neighbouring
reflection texel: such pixels are counted apart when two implementations
are compared.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.gather import take_rows
from lsr_tpu_torch.shading.procedural import snoise2


def mirror_matrix_y(plane_y, device=None):
    """Reflection about the horizontal plane y = plane_y."""
    t = m3.translate([0.0, plane_y, 0.0], device)
    s = m3.scale([1.0, -1.0, 1.0], device)
    ti = m3.translate([0.0, -plane_y, 0.0], device)
    return m3.matmul4(m3.matmul4(t, s), ti)


def mirrored_camera(view, plane_y):
    """View matrix of the camera reflected about the water plane.

    Mirroring flips handedness, so the reflection pass rasterizes with
    front-face culling (CULL_FRONT)."""
    return m3.matmul4(view, mirror_matrix_y(plane_y, view.device))


def shade_water(gb, reflection_hdr, water_obj_id: int, base_hdr, camera_pos,
                time=0.0, water_tint=(0.08, 0.18, 0.22),
                ripple_scale: float = 3.0, ripple_strength_px: float = 6.0,
                f0: float = 0.04):
    """Composite the water surface into a lit frame.

    gb: the main view's G-buffer; reflection_hdr: (H, W, 3) HDR rendered
    through the mirrored camera at the same size; base_hdr: the lit frame
    before water.  Water pixels (obj_id == water_obj_id) become the
    Fresnel mix of tint and reflection."""
    h, w = gb.depth01.shape
    dev = base_hdr.device
    is_water = gb.obj_id == water_obj_id
    time = torch.as_tensor(time, dtype=torch.float32, device=dev)

    # Ripple distortion from animated noise over world xz.
    wx, wz = gb.world_pos[..., 0], gb.world_pos[..., 2]
    nx = snoise2(wx * ripple_scale + time * 0.7, wz * ripple_scale)
    ny = snoise2(wx * ripple_scale + 13.1, wz * ripple_scale - time * 0.6)

    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    sx = torch.clamp(torch.round(xs + nx * ripple_strength_px), 0, w - 1)
    sy = torch.clamp(torch.round(ys + ny * ripple_strength_px), 0, h - 1)
    refl = take_rows(reflection_hdr.reshape(h * w, -1),
                     sy.to(torch.int64) * w + sx.to(torch.int64))

    # Schlick Fresnel with the water normal perturbed by the ripple.
    n = gb.normal_ws + torch.stack([nx, torch.zeros_like(nx), ny], -1) * 0.08
    n = n / torch.clamp(m3.norm3(n)[..., None], min=1e-8)
    v = camera_pos[None, None, :] - gb.world_pos
    v = v / torch.clamp(m3.norm3(v)[..., None], min=1e-8)
    ndv = torch.clamp(m3.dot3(n, v)[..., None], 0.0, 1.0)
    fres = f0 + (1.0 - f0) * torch.pow(1.0 - ndv, 5.0)

    tint = torch.tensor(water_tint, dtype=torch.float32, device=dev)
    water_col = tint + (refl - tint) * fres
    return torch.where(is_water[..., None], water_col, base_hdr)
