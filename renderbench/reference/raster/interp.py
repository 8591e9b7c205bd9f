"""Attribute interpolation: visibility buffer -> G-buffer (port of
lsr_tpu/raster/interp.py: GBuffer, pack_interp_records,
reconstruct_world_pos, interpolate_gbuffer).
"""

from __future__ import annotations

import dataclasses

import torch

from renderbench.reference.raster.setup import TriSetup
from renderbench.reference.shading.common import pack_material_records


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Fullscreen interpolated fragment attributes (all (H, W, ...))."""

    world_pos: torch.Tensor    # (H, W, 3)
    normal_ws: torch.Tensor    # (H, W, 3) normalized
    uv: torch.Tensor           # (H, W, 2)
    depth01: torch.Tensor      # (H, W)
    obj_id: torch.Tensor       # (H, W) i64, -1 = background
    covered: torch.Tensor      # (H, W) bool
    bary: torch.Tensor         # (H, W, 3) perspective-corrected weights
    face_normal: torch.Tensor  # (H, W, 3) geometric (flat) normal
    tri_id: torch.Tensor       # (H, W) i32 winning triangle (-1 = none)
    mat: torch.Tensor | None = None      # (H, W, 16) material record
    tangent: torch.Tensor | None = None  # (H, W, 3) per-triangle tangent


def pack_interp_records(setup: TriSetup, materials=None):
    """ONE (N, 40|56) f32 record per triangle: [0:9] coef | [9:12] iw |
    [12:21] wp | [21:30] nw | [30:36] uv | [36] obj_id | [37:40] tangent |
    [40:56] material (optional, pack_material_records layout).

    The material row is looked up by OBJECT id, clamped into the table the
    way lsr_tpu's XLA gather clamps it (the flagship scene has 26 objects
    and 5 materials, so objects 4.. all take material 4)."""
    n = setup.coef.shape[0]
    e1 = setup.wp[:, 1] - setup.wp[:, 0]
    e2 = setup.wp[:, 2] - setup.wp[:, 0]
    duv1 = setup.uv[:, 1] - setup.uv[:, 0]
    duv2 = setup.uv[:, 2] - setup.uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))[:, None]
    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv
    tangent = torch.where(ok[:, None], tangent, e1)
    cols = [setup.coef, setup.iw, setup.wp.reshape(n, 9),
            setup.nw.reshape(n, 9), setup.uv.reshape(n, 6),
            setup.obj_id.to(torch.float32)[:, None], tangent]
    if materials is not None:
        mat = pack_material_records(materials)
        cols.append(mat[torch.clamp(setup.obj_id, 0, mat.shape[0] - 1)])
    return torch.cat(cols, dim=-1)


def reconstruct_world_pos(depth01, view, proj, zn, zf, width: int,
                          height: int):
    """World position from the view-z depth plane and the camera rays (no
    record gather), inverting the raster's DEPTH_VIEWZ storage and the
    screen mapping sx = (ndc * 0.5 + 0.5) * (W - 1) at pixel centres.
    lsr_tpu's resolve route samples the sun shadow at these positions.
    zn / zf: 0-d f32 tensors (a camera's) or host numbers.  Returns (H, W,
    3)."""
    dev = depth01.device
    view_z = zn + depth01 * (zf - zn)
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    ndc_x = xs / (width - 1) * 2.0 - 1.0
    ndc_y = ys / (height - 1) * 2.0 - 1.0
    vx = ndc_x * (1.0 / proj[0, 0]) * view_z
    vy = ndc_y * (1.0 / proj[1, 1]) * view_z
    # view = [R | t]; world = R^T (v - t).
    rot, t = view[:3, :3], view[:3, 3]
    ax, ay, az = vx - t[0], vy - t[1], view_z - t[2]
    return torch.stack([rot[0, i] * ax + rot[1, i] * ay + rot[2, i] * az
                        for i in range(3)], dim=-1)


def interpolate_gbuffer(setup: TriSetup, depth01, tid, y_offset=0,
                        materials=None, want_face_normal: bool = True) -> GBuffer:
    """Gather per-pixel triangle data and interpolate attributes
    perspective-correctly.  y_offset: the global row of this band's first
    row (screen bands: a pixel's row center is its band row + 0.5 +
    y_offset, lsr_tpu/raster/interp.py:123-145).  materials bakes
    per-pixel material records into the same gather (GBuffer.mat)."""
    h, w = tid.shape
    dev = tid.device
    covered = tid >= 0
    safe = torch.where(covered, tid, torch.zeros_like(tid)).to(torch.int64)
    rec = pack_interp_records(setup, materials)[safe]
    coef = rec[..., 0:9]
    iw = rec[..., 9:12]
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None] \
        + float(y_offset)
    bc = torch.stack([coef[..., 3 * i] * px + coef[..., 3 * i + 1] * py
                      + coef[..., 3 * i + 2] for i in range(3)], dim=-1)
    bciw = bc * iw
    denom = bciw.sum(-1, keepdim=True)
    weights = bciw / torch.clamp(denom, min=1e-12)

    def interp(flat, width_):
        a = flat.reshape(flat.shape[:-1] + (3, width_))
        return (a * weights[..., None]).sum(dim=-2)

    wp = interp(rec[..., 12:21], 3)
    nw = interp(rec[..., 21:30], 3)
    nw = nw / torch.clamp(torch.sqrt((nw * nw).sum(-1, keepdim=True)),
                          min=1e-12)
    uv = interp(rec[..., 30:36], 2)
    obj = torch.where(covered, rec[..., 36].to(torch.int64),
                      torch.full_like(safe, -1))
    if want_face_normal:
        corners = rec[..., 12:21].reshape(rec.shape[:-1] + (3, 3))
        fn = torch.linalg.cross(corners[..., 1, :] - corners[..., 0, :],
                                corners[..., 2, :] - corners[..., 0, :])
        fn = fn / torch.clamp(torch.sqrt((fn * fn).sum(-1, keepdim=True)),
                              min=1e-12)
        flip = (fn * nw).sum(-1, keepdim=True) < 0.0
        fn = torch.where(flip, -fn, fn)
    else:
        fn = nw
    return GBuffer(
        world_pos=wp, normal_ws=nw, uv=uv, depth01=depth01, obj_id=obj,
        covered=covered, bary=weights, face_normal=fn, tri_id=tid,
        mat=rec[..., 40:56] if materials is not None else None,
        tangent=rec[..., 37:40],
    )
