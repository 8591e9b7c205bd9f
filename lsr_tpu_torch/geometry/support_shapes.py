"""Analytic culling volumes as batched support functions (port of
lsr_tpu/geometry/support_shapes.py: the record constructors,
transform_shapes, support_max_dot, classify_support_shapes,
classify_convex_vertices and light_culling_shapes).

Every shape kind packs into one fixed-width record and all kinds are
evaluated branchlessly, so a batch of shapes classifies against a convex
cell (planes with inside = dot(n, x) + d >= 0) in a few tensor ops
(culling_query.hpp:35-173).

Record layout (B, 24) f32:
  [0] kind | [1:4] p0 | [4:7] p1 | [7:10] ax | [10:13] ay | [13:16] az |
  [16:19] he | [19] r | [20] d0 | [21] d1 | [22] r0 | [23] r1
"""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.core.util import device_const


KIND_SPHERE = 0.0
KIND_AABB = 1.0
KIND_OBB = 2.0
KIND_CAPSULE = 3.0
KIND_CONE = 4.0
KIND_CYLINDER = 5.0
KIND_CONE_FRUSTUM = 6.0

REC_WIDTH = 24

# CullClass (culling_query.hpp:22)
CULL_OUTSIDE = 0
CULL_INTERSECTING = 1
CULL_INSIDE = 2


def _record(b, kind, device, **cols):
    """(B, 24) record of one kind; cols map a start lane to (B,) or (B, k)."""
    rec = torch.zeros((b, REC_WIDTH), dtype=torch.float32, device=device)
    rec[:, 0] = kind
    for lane, val in cols.items():
        j = int(lane[1:])
        val = val.to(torch.float32)
        if val.ndim == 1:
            rec[:, j] = val
        else:
            rec[:, j:j + val.shape[1]] = val
    return rec


def make_spheres(centers, radii):
    return _record(centers.shape[0], KIND_SPHERE, centers.device,
                   c1=centers, c19=radii)


def _as_f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def make_aabbs(mins, maxs):
    mins = _as_f32(mins)
    return _record(mins.shape[0], KIND_AABB, mins.device, c1=mins,
                   c4=_as_f32(maxs).to(mins.device))


def make_obbs(centers, axis_x, axis_y, axis_z, half_extents):
    return _record(centers.shape[0], KIND_OBB, centers.device, c1=centers,
                   c7=axis_x, c10=axis_y, c13=axis_z, c16=half_extents)


def make_capsules(a, b, radii):
    return _record(a.shape[0], KIND_CAPSULE, a.device, c1=a, c4=b, c19=radii)


def make_cones(apexes, axes, heights, radii):
    """axis: normalized apex -> base."""
    return _record(apexes.shape[0], KIND_CONE, apexes.device, c1=apexes,
                   c7=axes, c19=radii, c20=heights)


def make_cylinders(centers, axes, half_heights, radii):
    centers = _as_f32(centers)
    d = centers.device
    return _record(centers.shape[0], KIND_CYLINDER, d, c1=centers,
                   c7=_as_f32(axes).to(d), c19=_as_f32(radii).to(d),
                   c21=_as_f32(half_heights).to(d))


def make_cone_frustums(apexes, axes, near_d, far_d, near_r, far_r):
    apexes = _as_f32(apexes)
    d = apexes.device
    return _record(apexes.shape[0], KIND_CONE_FRUSTUM, d, c1=apexes,
                   c7=_as_f32(axes).to(d), c20=_as_f32(near_d).to(d),
                   c21=_as_f32(far_d).to(d), c22=_as_f32(near_r).to(d),
                   c23=_as_f32(far_r).to(d))


def transform_shapes(rec, rot, trans):
    """Rigidly transform shape records (rot (3,3), trans (3,)).  AABBs are
    promoted to OBBs."""
    def pt(x):
        return x @ rot.T + trans[None, :]

    def vec(x):
        return x @ rot.T

    out = rec.clone()
    out[:, 1:4] = pt(rec[:, 1:4])
    out[:, 4:7] = pt(rec[:, 4:7])
    for c in (7, 10, 13):
        out[:, c:c + 3] = vec(rec[:, c:c + 3])
    is_aabb = rec[:, 0] == KIND_AABB
    center = (rec[:, 1:4] + rec[:, 4:7]) * 0.5
    he = (rec[:, 4:7] - rec[:, 1:4]) * 0.5
    obb = make_obbs(pt(center), rot[:, 0][None].expand_as(he),
                    rot[:, 1][None].expand_as(he),
                    rot[:, 2][None].expand_as(he), he)
    return torch.where(is_aabb[:, None], obb, out)


def support_max_dot(rec, dirs):
    """max_{x in shape} dot(dir, x) for every (shape, dir) pair.
    rec: (B, 24); dirs: (P, 3), not necessarily unit.  Returns (B, P)."""
    d = dirs.to(torch.float32)
    dlen = torch.sqrt((d * d).sum(-1))
    kind = rec[:, 0:1]
    p0d = rec[:, 1:4] @ d.T
    p1d = rec[:, 4:7] @ d.T
    axd = rec[:, 7:10] @ d.T
    ayd = rec[:, 10:13] @ d.T
    azd = rec[:, 13:16] @ d.T
    r = rec[:, 19:20]

    sphere = p0d + r * dlen[None, :]
    pos = torch.where(d.T[None, :, :] >= 0.0, rec[:, 4:7, None],
                      rec[:, 1:4, None])
    aabb = (pos * d.T[None, :, :]).sum(dim=1)
    obb = (p0d + rec[:, 16:17] * torch.abs(axd)
           + rec[:, 17:18] * torch.abs(ayd)
           + rec[:, 18:19] * torch.abs(azd))
    capsule = torch.maximum(p0d, p1d) + r * dlen[None, :]
    perp_len = torch.sqrt(torch.clamp(dlen[None, :] ** 2 - axd * axd, min=0.0))
    base = p0d + rec[:, 20:21] * axd
    cone = torch.maximum(p0d, base + r * perp_len)
    cylinder = p0d + rec[:, 21:22] * torch.abs(axd) + r * perp_len
    near_s = p0d + rec[:, 20:21] * axd + rec[:, 22:23] * perp_len
    far_s = p0d + rec[:, 21:22] * axd + rec[:, 23:24] * perp_len
    cone_frustum = torch.maximum(near_s, far_s)
    return torch.where(
        kind == KIND_SPHERE, sphere,
        torch.where(kind == KIND_AABB, aabb,
                    torch.where(kind == KIND_OBB, obb,
                                torch.where(kind == KIND_CAPSULE, capsule,
                                            torch.where(kind == KIND_CONE, cone,
                                                        torch.where(kind == KIND_CYLINDER,
                                                                    cylinder,
                                                                    cone_frustum))))))


def _cull_class(outside, inside):
    return torch.where(outside, CULL_OUTSIDE,
                       torch.where(inside, CULL_INSIDE,
                                   CULL_INTERSECTING)).to(torch.int32)


def classify_support_shapes(rec, planes, outside_eps=1e-5, inside_eps=1e-5):
    """CullClass (B,) int32 of each shape against ONE convex cell
    (classify_support_shape, culling_query.hpp:152-173); planes (P, 4)."""
    n = planes[:, :3]
    dd = planes[:, 3][None, :]
    max_d = support_max_dot(rec, n) + dd                   # (B, P)
    min_d = -support_max_dot(rec, -n) + dd
    return _cull_class((max_d < -outside_eps).any(dim=1),
                       (min_d >= inside_eps).all(dim=1))


def classify_convex_vertices(verts, planes, outside_eps=1e-5,
                             inside_eps=1e-5):
    """CullClass (B,) int32 of convex vertex clouds verts (B, V, 3) (pad
    with repeats) against planes (P, 4) (classify_convex_vertices,
    culling_query.hpp:35-59)."""
    verts = _as_f32(verts).to(planes.device)
    q = verts[:, :, None, :] * planes[None, None, :, :3]    # (B, V, P, 3)
    d = ((q[..., 0] + q[..., 1]) + q[..., 2]) + planes[:, 3]
    any_inside = (d >= -outside_eps).any(dim=1)             # (B, P)
    all_inside = (d >= inside_eps).all(dim=1)
    return _cull_class((~any_inside).any(dim=1), all_inside.all(dim=1))


def _normalize(v):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=1e-12)


def light_culling_shapes(lights, spot_cones: bool = True):
    """(L, 24) support-shape records bounding each light's influence:
    point sphere, spot cone (clamped like the shaders), rect one-sided OBB,
    tube capsule; directional / env-probe rows get a huge sphere."""
    from lsr_tpu_torch.lighting.light_types import (
        LIGHT_POINT,
        LIGHT_RECT_AREA,
        LIGHT_SPOT,
        LIGHT_TUBE_AREA,
    )

    pos = lights.position
    rng = torch.clamp(lights.range, min=0.0)
    t = lights.type
    sphere_r = torch.where((t == LIGHT_POINT) | (t == LIGHT_SPOT), rng,
                           torch.full_like(rng, 1e8))
    rec = make_spheres(pos, sphere_r)

    if spot_cones:
        d = _normalize(lights.direction)
        outer = torch.clamp(lights.outer_angle, 0.02, np.pi / 2 - 0.005)
        cone = make_cones(pos, d, rng, rng * torch.tan(outer))
        rec = torch.where((t == LIGHT_SPOT)[:, None], cone, rec)

    d = _normalize(lights.direction)
    right0 = lights.axis - d * (lights.axis * d).sum(-1, keepdim=True)
    r0len = torch.sqrt((right0 * right0).sum(-1, keepdim=True))
    x_axis = device_const([[1.0, 0.0, 0.0]], pos.device)
    right = _normalize(torch.where(r0len > 1e-5, right0, x_axis))
    up = _normalize(torch.linalg.cross(d, right))
    right = _normalize(torch.linalg.cross(up, d))
    hx = torch.clamp(lights.rect_half_extents[:, 0], min=0.001)
    hy = torch.clamp(lights.rect_half_extents[:, 1], min=0.001)
    obb = make_obbs(pos + d * (rng * 0.5)[:, None], right, up, d,
                    torch.stack([hx + rng, hy + rng,
                                 torch.clamp(rng * 0.5, min=0.001)], -1))
    rec = torch.where((t == LIGHT_RECT_AREA)[:, None], obb, rec)

    axis = _normalize(lights.axis)
    hl = torch.clamp(lights.tube_half_length, min=0.001)[:, None]
    cap_r = torch.maximum(rng, torch.clamp(lights.tube_radius, min=0.001))
    cap = make_capsules(pos - axis * hl, pos + axis * hl, cap_r)
    return torch.where((t == LIGHT_TUBE_AREA)[:, None], cap, rec)
