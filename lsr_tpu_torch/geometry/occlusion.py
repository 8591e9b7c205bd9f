"""Occlusion culling: a low-resolution occluder depth raster and HiZ tests of
AABB screen rectangles (port of lsr_tpu/geometry/occlusion.py:
render_occluder_depth, build_hiz_pyramid, occlusion_cull_aabbs and
run_occlusion_pass, :29-161).

The occluders go through the depth-only setup with back-face culling and
kernel B1 at the proxy resolution (320x180 in the flagship frame), view-z
depth, no ids, unsorted.  The pyramid and the rectangle tests are plain
torch: a max mip chain, then per object the 2x2 footprint at the level
where its rectangle spans at most two texels.  Visibility comes back as a
mask; nothing is read back to the host.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.raster.setup import CULL_BACK, scene_setup_depth
from lsr_tpu_torch.raster.tiled import rasterize_direct


def render_occluder_depth(geom, objects, viewproj, zn, zf, width: int = 320,
                          height: int = 180, occluder_mask=None):
    """Depth-only raster of the occluders (objects.visible, or
    occluder_mask) at proxy resolution: (height, width) view-z depth01."""
    mask = objects.visible if occluder_mask is None else occluder_mask
    setup = scene_setup_depth(
        geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
        objects.model, viewproj, width, height, cull_mode=CULL_BACK,
        obj_visible=mask)
    depth, _, _ = rasterize_direct(setup, width, height, zn, zf,
                                   track_ids=False, spatial_sort=False)
    return depth


def build_hiz_pyramid(depth, levels: int):
    """Max-depth mip chain: level 0 is the input; each level 2x2-max-pools
    the previous, odd sizes padded with the far value 1.0."""
    pyr = [depth]
    cur = depth
    for _ in range(levels - 1):
        h, w = cur.shape
        cur = torch.nn.functional.pad(cur, (0, w & 1, 0, h & 1), value=1.0)
        ph, pw = cur.shape
        cur = cur.reshape(ph // 2, 2, pw // 2, 2).amax(dim=(1, 3))
        pyr.append(cur)
    return pyr


def occlusion_cull_aabbs(depth, viewproj, wmins, wmaxs, zn, zf,
                         levels: int = 8):
    """(B,) bool, True = potentially visible: the AABB's nearest corner
    depth is not behind the HiZ max over its screen rectangle.  AABBs that
    reach behind the near plane or whose rectangle lies off screen are kept
    (is_rect_occluded, culling_software.hpp:201-250)."""
    h, w = depth.shape
    dev = depth.device
    pyr = build_hiz_pyramid(depth, levels)

    i = torch.arange(8, device=dev)[:, None]
    sel = ((i >> torch.arange(3, device=dev)) & 1).to(torch.float32)  # (8, 3)
    corners = wmins[:, None, :] + (wmaxs - wmins)[:, None, :] * sel[None]
    clip = m3.transform_points_h(viewproj, corners)        # (B, 8, 4)
    wc = clip[..., 3]
    near_cross = (wc <= 1e-6).any(dim=-1)

    w_safe = torch.clamp(wc, min=1e-6)
    ndc = clip[..., :3] / w_safe[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * (w - 1)
    sy = (ndc[..., 1] * 0.5 + 0.5) * (h - 1)
    sx_min, sx_max = sx.amin(dim=1), sx.amax(dim=1)
    sy_min, sy_max = sy.amin(dim=1), sy.amax(dim=1)
    x0 = torch.clamp(torch.floor(sx_min), 0, w - 1).to(torch.int64)
    x1 = torch.clamp(torch.ceil(sx_max), 0, w - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(sy_min), 0, h - 1).to(torch.int64)
    y1 = torch.clamp(torch.ceil(sy_max), 0, h - 1).to(torch.int64)
    degenerate = ((sx_max < 0) | (sx_min > w - 1) | (sy_max < 0)
                  | (sy_min > h - 1))

    # The object's nearest depth, conservatively its smallest corner w.
    view_z = wc.amin(dim=1)
    obj_z01 = torch.clamp((view_z - zn) / max(zf - zn, 1e-6), 0.0, 1.0)

    # The level where the rectangle spans at most two texels, and the max of
    # its 2x2 footprint there.
    span = torch.maximum(x1 - x0, y1 - y0)
    level = torch.clamp(torch.ceil(torch.log2(
        torch.clamp(span, min=1).to(torch.float32))).to(torch.int64),
        0, levels - 1)
    occ_max = torch.zeros_like(obj_z01)
    for lv, p in enumerate(pyr):
        lh, lw = p.shape
        lx0 = torch.clamp(x0 >> lv, 0, lw - 1)
        lx1 = torch.clamp(x1 >> lv, 0, lw - 1)
        ly0 = torch.clamp(y0 >> lv, 0, lh - 1)
        ly1 = torch.clamp(y1 >> lv, 0, lh - 1)
        m = torch.maximum(torch.maximum(p[ly0, lx0], p[ly0, lx1]),
                          torch.maximum(p[ly1, lx0], p[ly1, lx1]))
        occ_max = torch.where(level == lv, m, occ_max)

    occluded = occ_max < obj_z01 - 1e-4
    return ~occluded | near_cross | degenerate


def run_occlusion_pass(geom, objects, viewproj, zn, zf, frustum_mask,
                       width: int = 320, height: int = 180,
                       occluder_mask=None, levels: int = 8):
    """The whole software occlusion pass (run_software_occlusion_pass,
    culling_software.hpp:253): render the occluders (frustum_mask, or
    occluder_mask) at width x height, test every object's world AABB, and
    return frustum_mask AND the test's mask."""
    from lsr_tpu_torch.scene.scene import object_world_aabbs

    occ_mask = frustum_mask if occluder_mask is None else occluder_mask
    depth = render_occluder_depth(geom, objects, viewproj, zn, zf, width,
                                  height, occluder_mask=occ_mask)
    wmin, wmax = object_world_aabbs(objects)
    vis = occlusion_cull_aabbs(depth, viewproj, wmin, wmax, zn, zf,
                               levels=levels)
    return frustum_mask & vis
