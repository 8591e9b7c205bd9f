"""Axis-aligned bounding volumes (port of lsr_tpu/geometry/volumes.py:
transform_aabb and merge_aabbs, :50-82).

Frustum and occlusion culling are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import torch


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


def merge_aabbs(mins, maxs, mask=None):
    """Scene AABB from per-object AABBs, with optional inclusion mask."""
    if mask is not None:
        big = 1e30
        mins = torch.where(mask[:, None], mins, torch.full_like(mins, big))
        maxs = torch.where(mask[:, None], maxs, torch.full_like(maxs, -big))
    return mins.min(dim=0).values, maxs.max(dim=0).values
