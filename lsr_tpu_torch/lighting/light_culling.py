"""Tiled and clustered light binning (port of
lsr_tpu/lighting/light_culling.py: view_space_spheres, tile_side_planes,
_mask_to_lists,
cull_lights_tiled, tile_depth_ranges_from_buffer, cluster_slice_bounds,
view_depth_to_cluster_slice, cull_lights_clustered, cull_lights_camera),
and count_occupancy, the binned grids' counters under tracing.

Per-tile (or per (tile, log-Z slice)) light index lists with a hard cap,
built from masks + cumsum + scatter, submission order preserved.  No host
sync: the stats stay tensors.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import cdiv, device_const, f32_on, resolve_device
from lsr_tpu_torch.geometry.support_shapes import (
    light_culling_shapes,
    support_max_dot,
    transform_shapes,
)
from lsr_tpu_torch.lighting.light_types import light_bounding_spheres
from lsr_tpu_torch.utils import trace


def _tile_grid(width, height, tile_w, tile_h=None):
    th = tile_w if tile_h is None else tile_h
    return cdiv(width, tile_w), cdiv(height, th)


def view_space_spheres(view, centers, radii):
    """Sphere centers (..., 3) into view space through view (4, 4), with
    each row summed as core.math3d.transform_points_h; radii unchanged."""
    from lsr_tpu_torch.core.math3d import transform_points_h

    return transform_points_h(view, centers)[..., :3], radii


def tile_side_planes(width, height, tile_size, proj, tile_h=None):
    """Per-tile view-space side planes through the origin, inward-positive
    normals.  Returns (tiles, 4, 3) for [left, right, bottom, top]."""
    th = tile_size if tile_h is None else tile_h
    tiles_x, tiles_y = _tile_grid(width, height, tile_size, th)
    dev = proj.device
    tan_x = 1.0 / proj[0, 0]
    tan_y = 1.0 / proj[1, 1]

    def borders(n_tiles, limit, step):
        edge_px = torch.arange(n_tiles + 1, dtype=torch.float32,
                               device=dev) * step
        edge_px = torch.clamp(edge_px, max=limit)
        return edge_px / limit * 2.0 - 1.0

    bx = borders(tiles_x, width - 1, tile_size) * tan_x
    by = borders(tiles_y, height - 1, th) * tan_y

    def plane(slope, sign, axis):
        comp = [torch.zeros_like(slope), torch.zeros_like(slope)]
        comp[axis] = torch.full_like(slope, sign)
        n = torch.stack(comp + [-sign * slope], -1)
        return n / torch.sqrt((n * n).sum(-1, keepdim=True))

    left = plane(bx[:-1], 1.0, 0)
    right = plane(bx[1:], -1.0, 0)
    bottom = plane(by[:-1], 1.0, 1)
    top = plane(by[1:], -1.0, 1)
    shape = (tiles_y, tiles_x, 3)
    planes = torch.stack([left[None].expand(shape), right[None].expand(shape),
                          bottom[:, None].expand(shape),
                          top[:, None].expand(shape)], dim=2)
    return planes.reshape(tiles_y * tiles_x, 4, 3)


def _mask_to_lists(mask, cap):
    """(tiles, L) bool -> (lists (tiles, cap) i64 -1 padded, counts (tiles,)
    i64 clamped to cap, stats {"max_count": raw max, "overflow_bins"})."""
    num_tiles, num_lights = mask.shape
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    counts = mask.sum(dim=1)
    keep = mask & (pos < cap)
    base = (torch.arange(num_tiles, device=dev) * cap)[:, None]
    flat = torch.where(keep, base + pos,
                       torch.full_like(pos, num_tiles * cap))
    ids = torch.arange(num_lights, device=dev).expand(num_tiles, num_lights)
    lists = torch.full((num_tiles * cap + 1,), -1, dtype=torch.int64,
                       device=dev)
    lists[flat.reshape(-1)] = ids.reshape(-1)
    stats = {"max_count": counts.max(), "overflow_bins": (counts > cap).sum()}
    return lists[:-1].reshape(num_tiles, cap), torch.clamp(counts, max=cap), \
        stats


def count_occupancy(name: str, counts, cap: int, stats) -> None:
    """A binned grid's occupancy as utils.trace counters, computed only
    while tracing is on (off, the frame gets no operation of this):
    <name>.entries, the list entries (counts summed); <name>.full, the bins
    whose list holds cap lights; <name>.max_count, the largest count before
    the cap (stats["max_count"])."""
    if not trace.enabled():
        return
    trace.count(f"{name}.entries", counts.sum())
    trace.count(f"{name}.full", (counts == cap).sum())
    trace.count(f"{name}.max_count", stats["max_count"])


def _light_bounds(lights, view, planes, use_shapes):
    """Which lights can touch each tile: (inside (tiles, L) bool, zmin_l,
    zmax_l (L,) view-z extent).  use_shapes: each light's analytic support
    shape (point sphere, spot cone, rect box, tube capsule) against the tile
    planes; else its bounding sphere (light_types.light_bounding_spheres)."""
    num_tiles = planes.shape[0]
    if use_shapes:
        rec_v = transform_shapes(light_culling_shapes(lights), view[:3, :3],
                                 view[:3, 3])
        sup = support_max_dot(rec_v, planes.reshape(num_tiles * 4, 3))
        inside = torch.all(sup.reshape(-1, num_tiles, 4) >= 0.0, dim=2).T
        zdirs = device_const([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]],
                             view.device)
        zsup = support_max_dot(rec_v, zdirs)
        return inside, -zsup[:, 1], zsup[:, 0]
    centers, r = light_bounding_spheres(lights)
    hom = torch.cat([centers, torch.ones_like(centers[:, :1])], dim=-1)
    c_view = (hom @ view.T)[:, :3]
    d = torch.einsum("tpc,lc->tpl", planes, c_view)
    inside = torch.all(d >= -r[None, None, :], dim=1)
    return inside, c_view[:, 2] - r, c_view[:, 2] + r


def _local_enabled(lights):
    """(L,) bool: enabled lights that tile lists take (directional and
    env-probe lights are applied globally)."""
    return (lights.type != 0) & (lights.type != 5) & lights.enabled


def cull_lights_tiled(lights, view, proj, width: int, height: int,
                      tile_size: int = 16, cap: int = 128,
                      tile_depth_range=None, tile_h: int | None = None,
                      use_shapes: bool = True):
    """Tiled light binning with each light's analytic support shape
    (use_shapes) or its bounding sphere against the tile planes (and, with
    tile_depth_range (tiles, 2), the tile's view-z range).  Directional /
    env-probe lights never enter tile lists.
    Returns (lists (tiles, cap), counts (tiles,), stats)."""
    planes = tile_side_planes(width, height, tile_size, proj, tile_h)
    inside, zmin_l, zmax_l = _light_bounds(lights, view, planes, use_shapes)
    mask = inside & _local_enabled(lights)[None, :]
    if tile_depth_range is not None:
        zmin = tile_depth_range[:, 0][:, None]
        zmax = tile_depth_range[:, 1][:, None]
        mask = mask & (zmax_l[None, :] >= zmin) & (zmin_l[None, :] <= zmax)
    return _mask_to_lists(mask, cap)


def tile_depth_ranges_from_buffer(depth01, zn, zf, width, height, tile_size,
                                  tile_h=None):
    """Per-tile [min, max] view depth reduced from the depth buffer."""
    th = tile_size if tile_h is None else tile_h
    tiles_x, tiles_y = _tile_grid(width, height, tile_size, th)
    ph, pw = tiles_y * th, tiles_x * tile_size
    d = torch.nn.functional.pad(
        depth01, (0, pw - depth01.shape[1], 0, ph - depth01.shape[0]),
        value=1.0)
    d = d.reshape(tiles_y, th, tiles_x, tile_size)
    view_z = zn + d * (zf - zn)
    zmin = view_z.amin(dim=(1, 3)).reshape(-1)
    zmax = view_z.amax(dim=(1, 3)).reshape(-1)
    return torch.stack([zmin, zmax], dim=-1)


def cluster_slice_bounds(zn, zf, slices: int, device=None):
    """(slices + 1,) logarithmic view-z slice boundaries zn * (zf / zn) **
    (k / slices), the inverse of view_depth_to_cluster_slice, on `device`
    (default: the card, core.util.default_device).  zn and zf: 0-d f32
    tensors (a camera's: data, as in lsr_tpu) or host numbers, which become
    memoised f32 constants; either way zf / zn rounds in f32 as lsr_tpu's
    does."""
    device = resolve_device(device)
    zn_t, zf_t = f32_on(zn, device), f32_on(zf, device)
    k = torch.arange(slices + 1, dtype=torch.float32, device=device) / slices
    return zn_t * torch.pow(zf_t / zn_t, k)


def view_depth_to_cluster_slice(view_z, zn, zf, slices: int):
    """Logarithmic cluster slice of each view depth, floor(log(z / zn) /
    log(zf / zn) * slices) clamped to [0, slices - 1]; int64."""
    zn_t, zf_t = f32_on(zn, view_z.device), f32_on(zf, view_z.device)
    t = torch.log(torch.clamp(view_z, min=1e-6) / zn_t) \
        / torch.log(zf_t / zn_t)
    return torch.clamp(torch.floor(t * slices).to(torch.int64), 0,
                       slices - 1)


def cull_lights_clustered(lights, view, proj, zn, zf, width: int, height: int,
                          tile_size: int = 16, cap: int = 128,
                          slices: int = 16, use_shapes: bool = True,
                          tile_h: int | None = None):
    """Clustered binning: lists (tiles * slices, cap), cluster index = tile
    * slices + slice.  A light enters a cluster when it touches the tile
    (as in cull_lights_tiled) and its view-z extent overlaps the slice's
    [bounds[s], bounds[s + 1]].  The mask is (tiles, slices, L) booleans.
    Returns (lists, counts (tiles * slices,), stats)."""
    planes = tile_side_planes(width, height, tile_size, proj, tile_h)
    inside, zmin_l, zmax_l = _light_bounds(lights, view, planes, use_shapes)
    bounds = cluster_slice_bounds(zn, zf, slices, view.device)
    overlap = ((zmax_l[None, :] >= bounds[:-1, None])
               & (zmin_l[None, :] <= bounds[1:, None]))    # (slices, L)
    mask = (inside[:, None, :] & overlap[None, :, :]
            & _local_enabled(lights)[None, None, :])
    return _mask_to_lists(mask.reshape(planes.shape[0] * slices, -1), cap)


def cull_lights_camera(lights, viewproj, occ_depth=None, zn=None, zf=None):
    """Per-frame camera cull of the LOCAL lights (port of lsr_tpu's
    cull_lights_camera, light_culling.py:253-278): (L,) bool, True = keep.
    The range sphere against the camera frustum, then, with an occluder
    depth proxy, HiZ occlusion of the sphere's AABB.  Directional and
    env-probe lights always pass."""
    from lsr_tpu_torch.geometry.occlusion import occlusion_cull_aabbs
    from lsr_tpu_torch.geometry.volumes import extract_frustum_planes

    planes = extract_frustum_planes(viewproj)              # (6, 4)
    pos = lights.position
    r = torch.clamp(lights.range, min=0.0)
    q = planes[:, None, :3] * pos[None, :, :]
    d = ((q[..., 0] + q[..., 1]) + q[..., 2]) + planes[:, None, 3]
    keep = (d >= -r[None, :]).all(dim=0)
    if occ_depth is not None:
        keep = keep & occlusion_cull_aabbs(occ_depth, viewproj,
                                           pos - r[:, None], pos + r[:, None],
                                           zn, zf)
    local = (lights.type != 0) & (lights.type != 5)
    return torch.where(local, keep, torch.ones_like(keep))
