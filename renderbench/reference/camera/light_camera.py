"""Directional-light camera fitting for the sun shadow map and a follow
camera rig (port of lsr_tpu/camera/light_camera.py: build_dir_light_camera
and follow_camera_eye, :16-74).

An orthographic LH frustum fitted around the shadow casters' AABB as seen
along the light, with its xy window snapped to whole shadow texels.

The snap sits on a knife edge: the camera looks at the AABB's centre, so in
exact arithmetic the window's corner is -S/2 texels, an integer, and an ulp
either way in the view-space corners decides whether floor() moves the
whole map by one texel.  Every sum here is therefore written out in the
order lsr_tpu's operations take on XLA:CPU one op at a time, fused
multiply-adds included (core/math3d.py).  Elementwise ops round the same
on the CPU and the card, so both give lsr_tpu's camera bit for bit.  No
host sync.
"""

from __future__ import annotations

import torch

from renderbench.reference.core import math3d as m3


def build_dir_light_camera(scene_min, scene_max, light_dir_ws,
                           shadow_map_size: int, depth_margin: float = 1.0):
    """Returns (light_view, light_proj, light_viewproj) for the sun.
    light_dir_ws points from the light toward the scene."""
    dev = scene_min.device
    center = (scene_min + scene_max) * 0.5
    radius = torch.clamp(m3.norm3(scene_max - scene_min) * 0.5, min=1e-3)

    d = m3.normalize(torch.as_tensor(light_dir_ws, dtype=torch.float32,
                                     device=dev))
    # A stable up vector, away from the light direction: +z when the light
    # is within ~18 degrees of vertical, else +y (made on the device, no
    # host copy).
    steep = (torch.abs(d[1]) > 0.95).to(torch.float32)
    up = torch.stack([torch.zeros_like(steep), 1.0 - steep, steep])
    eye = center - d * (radius * 2.0 + depth_margin)
    view = m3.look_at_lh(eye, center, up, device=dev)

    # The 8 AABB corners in light view space; fit the extents.  Corner i
    # takes max in x for bit 0 of i, in y for bit 1, in z for bit 2.
    i = torch.arange(8, device=dev)[:, None]
    bits = ((i >> torch.arange(3, device=dev)) & 1).to(torch.bool)
    corners = torch.where(bits, scene_max, scene_min)
    c_view = m3.transform_points(view, corners)
    vmin = c_view.min(dim=0).values
    vmax = c_view.max(dim=0).values

    # Texel snapping: the xy window origin in whole shadow texels.
    wupt = torch.clamp((vmax[:2] - vmin[:2]) / shadow_map_size, min=1e-8)
    vmin_xy = torch.floor(vmin[:2] / wupt) * wupt
    vmax_xy = vmin_xy + (vmax[:2] - vmin[:2])

    zn = vmin[2] - depth_margin
    zf = vmax[2] + depth_margin
    proj = m3.ortho_lh_no(vmin_xy[0], vmax_xy[0], vmin_xy[1], vmax_xy[1], zn,
                          zf, device=dev)
    return view, proj, m3.matmul4(proj, view)


def follow_camera_eye(target_pos, target_yaw, distance: float = 5.0,
                      height: float = 2.0, lag: float = 1.0, prev_eye=None,
                      device=None):
    """Third-person follow rig: the eye sits `distance` behind the target's
    facing direction at `height`, optionally lagged toward the previous eye
    (lag in [0, 1], 1 = no lag)."""
    target_pos = torch.as_tensor(target_pos, dtype=torch.float32,
                                 device=device)
    dev = target_pos.device
    yaw = torch.as_tensor(target_yaw, dtype=torch.float32, device=dev)
    fwd = torch.stack([torch.sin(yaw), torch.zeros_like(yaw), torch.cos(yaw)])
    desired = target_pos - fwd * distance + torch.tensor(
        [0.0, height, 0.0], dtype=torch.float32, device=dev)
    if prev_eye is None:
        return desired
    prev_eye = torch.as_tensor(prev_eye, dtype=torch.float32, device=dev)
    return prev_eye + (desired - prev_eye) * min(max(lag, 0.0), 1.0)
