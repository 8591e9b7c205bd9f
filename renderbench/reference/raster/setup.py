"""Triangle setup: vertex transform -> near clip -> screen-space edge setup
(port of lsr_tpu/raster/setup.py: TriSetup, vertex_stage, assemble_and_clip,
build_setup, scene_setup, vertex_stage_world, scene_setup_depth,
scene_setup_slots_depth, scene_setup_slots, CompactStats,
scene_setup_compact).

Per-triangle setup precomputes the affine barycentric coefficients
bc_i(x, y) = A_i x + B_i y + C_i, the per-corner 1/w and the screen bbox, so
the raster kernel does only multiply-adds per (triangle, pixel).  The vertex
transform's (V, 4) x (4, 4) clip product is written out elementwise in
lsr_tpu's summation order (clip_transform), so it needs no matmul and
gives the same bits on every device.
"""

from __future__ import annotations

import dataclasses

import torch

from renderbench.reference.core.util import cdiv
from renderbench.reference.raster.clip import clip_triangles_near

CULL_NONE = 0
CULL_BACK = 1
CULL_FRONT = 2

DEPTH_VIEWZ = 0   # z01 = (1/denom - zn) / (zf - zn)
DEPTH_NDC01 = 1   # z01 = z_ndc * 0.5 + 0.5


@dataclasses.dataclass(frozen=True)
class TriSetup:
    """Post-clip per-triangle SoA raster setup (N = 2 * input triangles)."""

    coef: torch.Tensor    # (N, 9) f32: A0,B0,C0,A1,B1,C1,A2,B2,C2
    iw: torch.Tensor      # (N, 3) f32: per-corner 1/w_clip
    ziw: torch.Tensor     # (N, 3) f32: per-corner z_ndc * (1/w)
    bbox: torch.Tensor    # (N, 4) i64: x0, y0, x1, y1 (inclusive, clamped)
    valid: torch.Tensor   # (N,) bool
    obj_id: torch.Tensor  # (N,) i64 object index
    wp: torch.Tensor      # (N, 3, 3) f32 per-corner world position
    nw: torch.Tensor      # (N, 3, 3) f32 per-corner world normal
    uv: torch.Tensor      # (N, 3, 2) f32 per-corner uv

    @property
    def count(self) -> int:
        return int(self.coef.shape[0])


def _world_stage(positions, normals, vtx_obj, models, normal_mats):
    """The model transform of vertex_stage: (world_h (V, 4), unit normal_ws
    (V, 3))."""
    o = models.shape[0]
    xf = torch.cat([models.reshape(o, 16), normal_mats.reshape(o, 9)],
                   dim=-1)[vtx_obj]                    # (V, 25)
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]

    def row4(c):
        return xf[:, c] * x + xf[:, c + 1] * y + xf[:, c + 2] * z + xf[:, c + 3]

    world_h = torch.stack([row4(0), row4(4), row4(8), row4(12)], dim=-1)
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]

    def nrow(c):
        return xf[:, 16 + c] * nx + xf[:, 17 + c] * ny + xf[:, 18 + c] * nz

    n_ws = torch.stack([nrow(0), nrow(3), nrow(6)], dim=-1)
    n_len = torch.sqrt((n_ws * n_ws).sum(-1, keepdim=True))
    return world_h, n_ws / torch.clamp(n_len, min=1e-12)


def clip_transform(world_h, viewproj):
    """Homogeneous world positions (..., 4) -> clip (..., 4) through
    viewproj (4, 4) or a batch (S, 1, 4, 4), each row summed as (m0 x +
    m1 y) + (m2 z + m3 w): the order of lsr_tpu's (V, 4) @ (4, 4) product
    on XLA:CPU, so a setup gets lsr_tpu's clip corners bit for bit, on
    the CPU and on the card alike.  (A matmul's own order differs by up to
    tens of ulps where terms cancel, which the edge setup of a small or
    thin triangle turns into a visible difference.)"""
    p = world_h[..., None, :] * viewproj
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def vertex_stage(positions, normals, uvs, vtx_obj, models, normal_mats,
                 viewproj):
    """Batched vertex shader.  Returns (world (V,3), clip (V,4),
    normal_ws (V,3))."""
    world_h, n_ws = _world_stage(positions, normals, vtx_obj, models,
                                 normal_mats)
    return world_h[:, :3], clip_transform(world_h, viewproj), n_ws


def assemble_and_clip(clip_v, world_v, normal_v, uv_v, indices, tri_obj):
    """Gather triangle corners and near-clip with static expansion.
    Returns flattened post-clip arrays of length N = 2 * T."""
    vrec = torch.cat([clip_v, world_v, normal_v, uv_v], dim=-1)
    crec = vrec[indices]                               # (T, 3, 12)
    attrs = {"wp": crec[..., 4:7], "normal": crec[..., 7:10],
             "uv": crec[..., 10:12]}
    clip2, attrs2, valid2 = clip_triangles_near(attrs, crec[..., 0:4])
    t = indices.shape[0]
    flat = lambda x: x.reshape((2 * t,) + x.shape[2:])  # noqa: E731
    obj2 = tri_obj[:, None].expand(t, 2).reshape(-1)
    return (flat(clip2), {k: flat(v) for k, v in attrs2.items()},
            valid2.reshape(-1), obj2)


def build_setup(clip_tris, attrs, valid, obj_id, width: int, height: int,
                cull_mode: int = CULL_BACK,
                front_face_ccw: bool = True) -> TriSetup:
    """Screen-space raster setup for post-clip triangles.
    clip_tris: (N, 3, 4); attrs: dict wp/normal/uv (N, 3, A); valid: (N,)."""
    w_clip = clip_tris[..., 3]
    w_ok = torch.all(w_clip > 1e-8, dim=-1)
    iw = torch.where(w_clip > 1e-8, 1.0 / torch.clamp(w_clip, min=1e-8),
                     torch.zeros_like(w_clip))
    ndc = clip_tris[..., :3] * iw[..., None]
    finite = torch.isfinite(ndc).all(dim=-1).all(dim=-1)

    # Screen mapping: bottom-left origin canvas.
    sx = (ndc[..., 0] * 0.5 + 0.5) * (width - 1)
    sy = (ndc[..., 1] * 0.5 + 0.5) * (height - 1)

    e0x, e0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
    e1x, e1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
    area2 = e0x * e1y - e0y * e1x
    nondegenerate = torch.abs(area2) >= 1e-10
    is_front = (area2 > 0.0) == front_face_ccw
    if cull_mode == CULL_BACK:
        face_ok = is_front
    elif cull_mode == CULL_FRONT:
        face_ok = ~is_front
    else:
        face_ok = torch.ones_like(is_front)

    # bc_i = cross(s_k - s_j, p - s_j) / area2 for (i, j, k) cyclic.
    safe_area = torch.where(nondegenerate, area2, torch.ones_like(area2))
    inv_area = torch.where(nondegenerate, 1.0 / safe_area,
                           torch.zeros_like(area2))

    def edge_coef(j, k):
        a = (sy[:, j] - sy[:, k]) * inv_area
        b = (sx[:, k] - sx[:, j]) * inv_area
        c = (sx[:, j] * sy[:, k] - sx[:, k] * sy[:, j]) * inv_area
        return a, b, c

    a0, b0, c0 = edge_coef(1, 2)
    a1, b1, c1 = edge_coef(2, 0)
    a2, b2, c2 = edge_coef(0, 1)
    coef = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2], dim=-1)

    sx_min, sx_max = sx.min(dim=1).values, sx.max(dim=1).values
    sy_min, sy_max = sy.min(dim=1).values, sy.max(dim=1).values
    x0 = torch.clamp(torch.floor(sx_min), 0, width - 1).to(torch.int64)
    x1 = torch.clamp(torch.ceil(sx_max), 0, width - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(sy_min), 0, height - 1).to(torch.int64)
    y1 = torch.clamp(torch.ceil(sy_max), 0, height - 1).to(torch.int64)
    on_screen = ((sx_max >= 0.0) & (sx_min <= width - 1)
                 & (sy_max >= 0.0) & (sy_min <= height - 1))
    bbox = torch.stack([x0, y0, x1, y1], dim=-1)

    ok = valid & w_ok & finite & nondegenerate & face_ok & on_screen
    n = clip_tris.shape[0]
    zero = lambda a: torch.zeros(  # noqa: E731
        (n, 3, a), dtype=torch.float32, device=clip_tris.device)
    return TriSetup(
        coef=coef, iw=iw, ziw=ndc[..., 2] * iw, bbox=bbox, valid=ok,
        obj_id=obj_id.to(torch.int64),
        wp=attrs.get("wp", zero(0)), nw=attrs.get("normal", zero(0)),
        uv=attrs.get("uv", zero(0)),
    )


def scene_setup(positions, normals, uvs, indices, vtx_obj, tri_obj, models,
                normal_mats, viewproj, width: int, height: int,
                cull_mode: int = CULL_BACK, front_face_ccw: bool = True,
                obj_visible=None) -> TriSetup:
    """Full geometry front-end: vertex stage + clip + setup.
    obj_visible: optional (O,) bool mask folded into triangle validity."""
    world, clip_v, n_ws = vertex_stage(
        positions, normals, uvs, vtx_obj, models, normal_mats, viewproj)
    clip_t, attrs, valid, obj2 = assemble_and_clip(
        clip_v, world, n_ws, uvs, indices, tri_obj)
    if obj_visible is not None:
        valid = valid & obj_visible[obj2]
    return build_setup(clip_t, attrs, valid, obj2, width, height, cull_mode,
                       front_face_ccw)


def vertex_stage_world(positions, vtx_obj, models):
    """World-only vertex stage for depth targets: vertex_stage's model
    transform in the same order, without normals or uvs.  Returns the
    homogeneous world positions (V, 4)."""
    o = models.shape[0]
    xf = models.reshape(o, 16)[vtx_obj]                # (V, 16)
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]

    def row4(c):
        return xf[:, c] * x + xf[:, c + 1] * y + xf[:, c + 2] * z + xf[:, c + 3]

    return torch.stack([row4(0), row4(4), row4(8), row4(12)], dim=-1)


def scene_setup_depth(positions, indices, vtx_obj, tri_obj, models, viewproj,
                      width: int, height: int, cull_mode: int = CULL_NONE,
                      front_face_ccw: bool = True,
                      obj_visible=None) -> TriSetup:
    """Depth-only geometry front-end for shadow targets
    (lsr_tpu/raster/setup.py:227-272): world positions, then the clip
    transform as explicit multiply-adds in lsr_tpu's row order (no matmul),
    the near clip on 4-wide clip corners only, and build_setup.  The
    returned TriSetup carries zero-width wp / nw / uv."""
    world_h = vertex_stage_world(positions, vtx_obj, models)
    wx, wy, wz, ww = (world_h[:, 0], world_h[:, 1], world_h[:, 2],
                      world_h[:, 3])

    def crow(r):
        return (viewproj[r, 0] * wx + viewproj[r, 1] * wy
                + viewproj[r, 2] * wz + viewproj[r, 3] * ww)

    clip_v = torch.stack([crow(0), crow(1), crow(2), crow(3)], dim=-1)
    clip2, _, valid2 = clip_triangles_near({}, clip_v[indices])
    t = indices.shape[0]
    obj2 = tri_obj[:, None].expand(t, 2).reshape(-1)
    valid = valid2.reshape(-1)
    if obj_visible is not None:
        valid = valid & obj_visible[obj2]
    return build_setup(clip2.reshape(2 * t, 3, 4), {}, valid, obj2, width,
                       height, cull_mode, front_face_ccw)


def scene_setup_slots_depth(positions, indices, vtx_obj, tri_obj, models,
                            viewprojs, size: int, cull_mode: int = CULL_NONE,
                            front_face_ccw: bool = True,
                            obj_visible_slots=None) -> TriSetup:
    """Depth-only setup of every slot of a shadow-atlas stack at once
    (lsr_tpu/raster/setup.py:275-335): viewprojs (S, 4, 4), square size^2
    targets, obj_visible_slots (S, O).  The world transform and the corner
    gather run once; each slot's clip corners are scene_setup_depth's
    multiply-adds in the same order, so slot s equals scene_setup_depth
    with viewprojs[s] bit for bit.  Returns a TriSetup whose fields carry a
    leading (S,) slot axis (2T rows a slot)."""
    s, t = viewprojs.shape[0], indices.shape[0]
    wc = vertex_stage_world(positions, vtx_obj, models)[indices]  # (T, 3, 4)
    wx, wy, wz, ww = (wc[None, ..., i] for i in range(4))

    def crow(r):
        v = viewprojs[:, None, None, r, :]
        return (v[..., 0] * wx + v[..., 1] * wy + v[..., 2] * wz
                + v[..., 3] * ww)

    tri_clip = torch.stack([crow(0), crow(1), crow(2), crow(3)], dim=-1)
    clip2, _, valid2 = clip_triangles_near({}, tri_clip.reshape(s * t, 3, 4))
    obj2 = tri_obj[None, :, None].expand(s, t, 2).reshape(-1)
    valid = valid2.reshape(-1)
    if obj_visible_slots is not None:
        slot_of = torch.arange(s, device=indices.device).repeat_interleave(
            2 * t)
        valid = valid & obj_visible_slots[slot_of, obj2]
    st = build_setup(clip2.reshape(2 * s * t, 3, 4), {}, valid, obj2, size,
                     size, cull_mode, front_face_ccw)
    return TriSetup(**{f.name: getattr(st, f.name).reshape(
        (s, 2 * t) + getattr(st, f.name).shape[1:])
        for f in dataclasses.fields(TriSetup)})


def scene_setup_slots(positions, normals, uvs, indices, vtx_obj, tri_obj,
                      models, normal_mats, viewprojs, size: int,
                      cull_mode: int = CULL_NONE, front_face_ccw: bool = True,
                      obj_visible_slots=None) -> TriSetup:
    """Full geometry front-end of every slot of a stack at once
    (lsr_tpu/raster/setup.py:339-427): viewprojs (S, 4, 4), square size^2
    targets, obj_visible_slots optional (S, O).  The model transform and
    the corner gather run once; each slot's clip corners are scene_setup's
    clip_transform with viewprojs[s], and the clip and edge setup are
    elementwise over the slots' rows, so slot s equals scene_setup with
    viewprojs[s] bit for bit.  Returns a TriSetup whose
    fields carry a leading (S,) slot axis (2T rows a slot)."""
    s, t = viewprojs.shape[0], indices.shape[0]
    world_h, n_ws = _world_stage(positions, normals, vtx_obj, models,
                                 normal_mats)
    clip_v = clip_transform(world_h[None], viewprojs[:, None])
    crec = torch.cat([world_h[:, :3], n_ws, uvs], dim=-1)[indices]
    crec = crec[None].expand(s, t, 3, 8).reshape(s * t, 3, 8)
    attrs = {"wp": crec[..., 0:3], "normal": crec[..., 3:6],
             "uv": crec[..., 6:8]}
    clip2, attrs2, valid2 = clip_triangles_near(
        attrs, clip_v[:, indices].reshape(s * t, 3, 4))
    flat = lambda x: x.reshape((2 * s * t,) + x.shape[2:])  # noqa: E731
    obj2 = tri_obj[None, :, None].expand(s, t, 2).reshape(-1)
    valid = valid2.reshape(-1)
    if obj_visible_slots is not None:
        slot_of = torch.arange(s, device=indices.device).repeat_interleave(
            2 * t)
        valid = valid & obj_visible_slots[slot_of, obj2]
    st = build_setup(flat(clip2), {k: flat(v) for k, v in attrs2.items()},
                     valid, obj2, size, size, cull_mode, front_face_ccw)
    return TriSetup(**{f.name: getattr(st, f.name).reshape(
        (s, 2 * t) + getattr(st, f.name).shape[1:])
        for f in dataclasses.fields(TriSetup)})


@dataclasses.dataclass(frozen=True)
class CompactStats:
    """Occupancy / overflow counters of scene_setup_compact.  An overflow
    means dropped triangles: callers fall back to scene_setup."""

    n_direct: torch.Tensor   # () i64 surviving unclipped triangles
    n_clip: torch.Tensor     # () i64 surviving near-clipping triangles
    overflow: torch.Tensor   # () bool: either cap exceeded
    cap_direct: int = 0
    cap_clip: int = 0


def compact_prefilter(tri_clip, width: int, height: int,
                      cull_mode: int = CULL_BACK, front_face_ccw: bool = True):
    """The compact front-end's cheap stage on (T, 3, 4) clip corners.
    Returns (keep_direct, needs_clip), each (T,) bool.

    keep_direct is build_setup's validity of an all-inside triangle,
    computed on the corner order the near clip emits for it ([v1, v2, v0]),
    with the same torch expressions in the same order as build_setup, so
    the two decisions are the same (tests/test_torch_highpoly.py holds
    them equal)."""
    d = tri_clip[..., 2] + tri_clip[..., 3]
    n_in = (d >= 0.0).sum(-1)
    all_in = n_in == 3
    needs_clip = (n_in > 0) & ~all_in
    rot = torch.roll(tri_clip, -1, 1)          # corners [v1, v2, v0]
    w_clip = rot[..., 3]
    w_ok = torch.all(w_clip > 1e-8, dim=-1)
    iw = torch.where(w_clip > 1e-8, 1.0 / torch.clamp(w_clip, min=1e-8),
                     torch.zeros_like(w_clip))
    ndc = rot[..., :3] * iw[..., None]
    finite = torch.isfinite(ndc).all(dim=-1).all(dim=-1)
    sx = (ndc[..., 0] * 0.5 + 0.5) * (width - 1)
    sy = (ndc[..., 1] * 0.5 + 0.5) * (height - 1)
    e0x, e0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
    e1x, e1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
    area2 = e0x * e1y - e0y * e1x
    nondegenerate = torch.abs(area2) >= 1e-10
    is_front = (area2 > 0.0) == front_face_ccw
    if cull_mode == CULL_BACK:
        face_ok = is_front
    elif cull_mode == CULL_FRONT:
        face_ok = ~is_front
    else:
        face_ok = torch.ones_like(is_front)
    on_screen = ((sx.max(dim=1).values >= 0.0)
                 & (sx.min(dim=1).values <= width - 1)
                 & (sy.max(dim=1).values >= 0.0)
                 & (sy.min(dim=1).values <= height - 1))
    keep = all_in & w_ok & finite & nondegenerate & face_ok & on_screen
    return keep, needs_clip


def scene_setup_compact(positions, normals, uvs, indices, vtx_obj, tri_obj,
                        models, normal_mats, viewproj, width: int,
                        height: int, cull_mode: int = CULL_BACK,
                        front_face_ccw: bool = True, obj_visible=None,
                        cap_fraction: float = 0.62, clip_cap: int = 8192):
    """High-density geometry front-end: cull and compact before the wide
    work (port of lsr_tpu/raster/setup.py:scene_setup_compact).

    1. compact_prefilter on the clip corners only;
    2. stable compaction of the survivors to cap_direct =
       ceil(T * cap_fraction / 128) * 128 rows (original order kept) and of
       the near-plane-crossing triangles to cap_clip = min(T, clip_cap);
    3. the corner gather and build_setup on those rows only, the clipped
       ones through the near-clip case tables.

    Rows are [direct survivors, clipped pairs]: the raster coverage, depth
    and attributes of scene_setup; only z-tie order between a clipped and
    an unclipped triangle may differ.  Returns (TriSetup, CompactStats); on
    overflow triangles past a cap are dropped and the caller must fall back
    to scene_setup.  No host sync."""
    t = indices.shape[0]
    cap_d = min(t, cdiv(int(t * cap_fraction), 128) * 128)
    cap_c = min(t, clip_cap)
    world, clip_v, n_ws = vertex_stage(
        positions, normals, uvs, vtx_obj, models, normal_mats, viewproj)
    keep_direct, keep_clip = compact_prefilter(
        clip_v[indices], width, height, cull_mode, front_face_ccw)
    if obj_visible is not None:
        vis = obj_visible[tri_obj]
        keep_direct = keep_direct & vis
        keep_clip = keep_clip & vis
    n_direct = keep_direct.sum()
    n_clip = keep_clip.sum()
    order_d = torch.argsort((~keep_direct).to(torch.uint8), stable=True)[:cap_d]
    order_c = torch.argsort((~keep_clip).to(torch.uint8), stable=True)[:cap_c]
    dev = indices.device
    row_d_ok = torch.arange(cap_d, device=dev) < n_direct
    row_c_ok = torch.arange(cap_c, device=dev) < n_clip

    # Direct rows: the corners in the near clip's case-111 order, normals
    # re-normalized as the clip path re-normalizes them.
    vrec = torch.cat([clip_v, world, n_ws, uvs], dim=-1)           # (V, 12)
    crec = vrec[torch.roll(indices[order_d], -1, 1)]               # (D, 3, 12)
    nrm = crec[..., 7:10]
    nrm = nrm / torch.clamp(torch.sqrt((nrm * nrm).sum(-1, keepdim=True)),
                            min=1e-12)
    attrs_d = {"wp": crec[..., 4:7], "normal": nrm, "uv": crec[..., 10:12]}

    crec_c = vrec[indices[order_c]]
    clip2, attrs2, valid2 = clip_triangles_near(
        {"wp": crec_c[..., 4:7], "normal": crec_c[..., 7:10],
         "uv": crec_c[..., 10:12]}, crec_c[..., 0:4])
    flat_c = lambda x: x.reshape((2 * cap_c,) + x.shape[2:])  # noqa: E731
    obj_c = tri_obj[order_c][:, None].expand(cap_c, 2).reshape(-1)
    valid_c = valid2.reshape(-1) & row_c_ok.repeat_interleave(2)

    setup = build_setup(
        torch.cat([crec[..., 0:4], flat_c(clip2)]),
        {k: torch.cat([attrs_d[k], flat_c(attrs2[k])]) for k in attrs_d},
        torch.cat([row_d_ok, valid_c]), torch.cat([tri_obj[order_d], obj_c]),
        width, height, cull_mode, front_face_ccw)
    return setup, CompactStats(
        n_direct=n_direct, n_clip=n_clip,
        overflow=(n_direct > cap_d) | (n_clip > cap_c),
        cap_direct=cap_d, cap_clip=cap_c)
