"""Axis-aligned bounding volumes and frustum tests (port of
lsr_tpu/geometry/volumes.py: extract_frustum_planes, sphere_outside_planes,
aabb_outside_planes, transform_aabb, frustum_cull_objects, mesh_local_aabb,
merge_aabbs, point_aabb_distance_sq and update_visibility_history,
:14-100).

Culling produces visibility masks, not compacted lists.  Every small sum is
written out in the order lsr_tpu's op-by-op form takes on XLA:CPU (left to
right; the plane norm with its fused multiply-adds, core/math3d.norm3), so
the masks are the same booleans.  The frustum functions take a batch of
view-projections (..., 4, 4): the shadow atlas culls every slot at once.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core import math3d as m3


def extract_frustum_planes(viewproj):
    """Six frustum planes (nx, ny, nz, d), inward-positive, normalised:
    plane . [p, 1] >= 0 inside (Gribb-Hartmann for row-major clip =
    M @ [p, 1], NDC in [-1, 1]^3).  Order: left, right, bottom, top, near,
    far.  viewproj (..., 4, 4) -> (..., 6, 4)."""
    m = viewproj
    r3 = m[..., 3, :]
    planes = torch.stack([r3 + m[..., 0, :], r3 - m[..., 0, :],
                          r3 + m[..., 1, :], r3 - m[..., 1, :],
                          r3 + m[..., 2, :], r3 - m[..., 2, :]], dim=-2)
    n = m3.norm3(planes[..., :3])[..., None]
    return planes / torch.clamp(n, min=1e-12)


def _plane_dot(p, planes):
    """p . n + d for points p (..., B, 1, 3) against planes (..., 1, 6, 4),
    summed left to right."""
    q = p * planes[..., :3]
    return ((q[..., 0] + q[..., 1]) + q[..., 2]) + planes[..., 3]


def sphere_outside_planes(planes, centers, radii):
    """(..., B) True where the sphere lies fully outside any plane
    (frustum_culling.hpp sphere test)."""
    d = _plane_dot(centers[..., :, None, :], planes[..., None, :, :])
    return (d < -radii[..., :, None]).any(dim=-1)


def aabb_outside_planes(planes, mins, maxs):
    """(..., B) conservative AABB-vs-frustum: outside where the positive
    vertex of some plane lies behind it (frustum_culling.hpp AABB test)."""
    pl = planes[..., None, :, :]                           # (..., 1, 6, 4)
    pos = torch.where(pl[..., :3] >= 0.0, maxs[..., :, None, :],
                      mins[..., :, None, :])               # (..., B, 6, 3)
    q = pos * pl[..., :3]
    d = ((q[..., 0] + q[..., 1]) + q[..., 2]) + pl[..., 3]
    return (d < 0.0).any(dim=-1)


def frustum_cull_objects(viewproj, world_mins, world_maxs):
    """Visibility mask (True = visible) of object world AABBs (O, 3) against
    one view-projection (4, 4) -> (O,), or a batch (S, 4, 4) -> (S, O)."""
    return ~aabb_outside_planes(extract_frustum_planes(viewproj), world_mins,
                                world_maxs)


def transform_aabb(model, mins, maxs):
    """World AABB of a transformed local AABB (B per-object, model (B,4,4)).

    Uses the |R| trick: extent' = |M3| @ extent; center' = M @ center.  The
    products sum left to right, as lsr_tpu's einsum on XLA:CPU, on every
    device."""
    center = (mins + maxs) * 0.5
    extent = (maxs - mins) * 0.5
    c_h = torch.cat([center, torch.ones_like(center[..., :1])], dim=-1)
    p = model[:, :3, :] * c_h[:, None, :]
    c_w = ((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3]
    q = torch.abs(model[:, :3, :3]) * extent[:, None, :]
    e_w = (q[..., 0] + q[..., 1]) + q[..., 2]
    return c_w - e_w, c_w + e_w


def mesh_local_aabb(positions):
    """Local-space AABB (mins, maxs) of a vertex array (numpy or tensor)."""
    if isinstance(positions, torch.Tensor):
        return positions.amin(dim=0), positions.amax(dim=0)
    return positions.min(axis=0), positions.max(axis=0)


def merge_aabbs(mins, maxs, mask=None):
    """Scene AABB from per-object AABBs, with optional inclusion mask."""
    if mask is not None:
        big = 1e30
        mins = torch.where(mask[:, None], mins, torch.full_like(mins, big))
        maxs = torch.where(mask[:, None], maxs, torch.full_like(maxs, -big))
    return mins.min(dim=0).values, maxs.max(dim=0).values


def point_aabb_distance_sq(points, mins, maxs):
    """Squared distance from points (B, 3) to AABBs (B, 3) / (B, 3),
    broadcastable; summed left to right."""
    d = points - torch.minimum(torch.maximum(points, mins), maxs)
    return m3.dot3(d, d)


def update_visibility_history(history, visible_now, hold_frames: int = 4):
    """Visibility hysteresis: an object that becomes invisible stays
    renderable for hold_frames frames.  history (B,) frames since last seen
    (start at hold_frames: never seen is not recently visible).  Returns
    (new_history, effective_visible)."""
    new_hist = torch.where(visible_now, torch.zeros_like(history),
                           history + 1)
    return new_hist, new_hist <= hold_frames
