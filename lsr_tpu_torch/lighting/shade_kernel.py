"""Fused shading: sun BRDF + binned local lights, kernel B2 (port of
lsr_tpu/lighting/shade_kernel.py: shade_fused_pallas / _shade_kernel).

shade_fused bins the lights per 64x128 screen tile (cull_lights_tiled) or,
in clustered mode (variant B2b), per (tile, log-Z slice)
(cull_lights_clustered), gathers each list's 32-lane light records (empty
list slots hold zero records), lays the G-buffer out as planes and then
either launches the CUDA kernel (csrc/shade_fused.cu) for CUDA tensors or
evaluates the same lists per pixel with torch ops (_shade_plain) for CPU
tensors.  The kernel leaves out the terms of lights that cannot reach a
warp's pixels, which the plain version adds as +0 (lighting/light_walk.py).

G-buffer planes (16, ph, pw), the channel layout of lsr_tpu:
  0:3 world_pos | 3:6 normal | 6 covered | 7:10 albedo | 10 metallic |
  11 roughness | 12 sun shadow visibility | 13 cluster slice of the pixel
  (clustered mode; lsr_tpu appends it after its local-shadow planes) |
  14:16 pad
Clustered records are (tiles, slices * cap, 32): slice s of a tile's lists
starts at s * cap, and counts are (tiles * slices,).
Local-shadow planes, when given, stay a separate (K + 1, H, W) stack: lsr_tpu
appends them to its G-buffer planes; the kernel reads one texel of a plane
per live shadowed light (record lane 28 = the plane).
Uniforms (9,) f32: 0:3 camera_pos | 3:6 sun dir (toward scene, unit) |
  6:9 sun radiance (color * intensity)
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import cdiv
from lsr_tpu_torch.lighting.light_culling import (
    count_occupancy,
    cull_lights_clustered,
    cull_lights_tiled,
)
from lsr_tpu_torch.lighting.light_runtime import pack_light_records
from lsr_tpu_torch.lighting.light_types import (
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
)
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

_PI = 3.14159265358979
_HALF_PI = 1.5707963267948966

SUN_MODELS = ("pbr_mr", "blinn_phong")


def _rsqrt(x):
    # 1/sqrt rounded twice, as the CUDA kernel and the CPU reference do
    # (torch.rsqrt on the card is the approximate rsqrtf; near the GGX
    # highlight peak D amplifies its ulps ~250x).
    return 1.0 / torch.sqrt(x)


def _unit3(a, b, c):
    il = _rsqrt(torch.clamp(a * a + b * b + c * c, min=1e-16))
    return a * il, b * il, c * il


def _f(x, v):
    return torch.full_like(x, v)


def _sun_term(g, uni, sun_model):
    """Per-pixel sun BRDF times sun visibility (shade_kernel.py:59-131).
    g: sequence of planes; uni: (9,) uniforms.  Returns (dr, dg, db)."""
    px, py, pz = g[0], g[1], g[2]
    nx, ny, nz = g[3], g[4], g[5]
    ar, ag, ab = g[7], g[8], g[9]
    metal = torch.clamp(g[10], 0.0, 1.0)
    rough = g[11]
    sun_vis = g[12]
    cx, cy, cz, sdx, sdy, sdz, srr, srg, srb = (uni[i] for i in range(9))

    vx, vy, vz = _unit3(cx - px, cy - py, cz - pz)
    lx, ly, lz = -sdx, -sdy, -sdz
    hx, hy, hz = _unit3(lx + vx, ly + vy, lz + vz)
    ndl = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
    ndh = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
    ndv = torch.clamp(nx * vx + ny * vy + nz * vz, min=0.0)

    if sun_model == "blinn_phong":
        rough_c = torch.clamp(rough, 0.0, 1.0)
        spec_pow = torch.clamp(8.0 + (1.0 - rough_c) * 120.0, min=4.0)
        spec_norm = (spec_pow + 2.0) / (2.0 * _PI)
        spec_f0 = 0.04 + 0.96 * metal
        spec = torch.pow(torch.clamp(ndh, min=1e-9), spec_pow) * spec_norm \
            * spec_f0 * ndl
        base = (1.0 - metal) * (ndl / _PI)
        dr = (base * ar + spec) * srr
        dg = (base * ag + spec) * srg
        db = (base * ab + spec) * srb
    else:
        rough_c = torch.clamp(rough, 0.04, 1.0)
        a = rough_c * rough_c
        a2 = a * a
        dden = ndh * ndh * (a2 - 1.0) + 1.0
        d = a2 / (_PI * dden * dden + 1e-7)
        k = (a + 1.0) * (a + 1.0) * 0.125
        g1v = ndv / (ndv * (1.0 - k) + k + 1e-7)
        g1l = ndl / (ndl * (1.0 - k) + k + 1e-7)
        gg = g1v * g1l
        vdh = torch.clamp(vx * hx + vy * hy + vz * hz, min=0.0)
        fres = torch.pow(1.0 - vdh, 5.0)
        denom_s = torch.clamp(4.0 * ndl * ndv, min=1e-6)
        inv_pi = 1.0 / _PI
        lit = ((ndl > 0.0) & (ndv > 0.0)).to(torch.float32)
        out = []
        for alb, rad in ((ar, srr), (ag, srg), (ab, srb)):
            f0 = 0.04 + (alb - 0.04) * metal
            fc = f0 + (1.0 - f0) * fres
            sc = d * gg * fc / denom_s
            kd = (1.0 - fc) * (1.0 - metal)
            out.append((kd * alb * inv_pi + sc) * rad * ndl * lit)
        dr, dg, db = out
    return dr * sun_vis, dg * sun_vis, db * sun_vis


def tile_planes(planes, th, tw, tiles_y, tiles_x):
    """(C, ph, pw) planes -> (C, tiles, 1, th * tw), tile-major: the layout
    the plain versions evaluate a tile's light list in."""
    c_all = planes.shape[0]
    return planes.reshape(c_all, tiles_y, th, tiles_x, tw) \
        .permute(0, 1, 3, 2, 4).reshape(c_all, tiles_y * tiles_x, 1, th * tw)


def untile_planes(t, th, tw, tiles_y, tiles_x):
    """Inverse of tile_planes for (C, tiles, 1, th * tw) -> (C, ph, pw)."""
    c_all = t.shape[0]
    return t.reshape(c_all, tiles_y, tiles_x, th, tw).permute(0, 1, 3, 2, 4) \
        .reshape(c_all, tiles_y * th, tiles_x * tw)


def light_terms(blk, px, py, pz, nx, ny, nz, vx, vy, vz, covered, apow1,
                kinds, want_reach=False, lvis=None, in_slice=None):
    """One chunk of every tile's list against the tile's pixels, in the
    kernels' operation order (csrc/light_loop.cuh: light_prepare,
    light_reach, light_shade).
    blk: (T, chunk, 32) records; pixel planes (T, 1, P).  Returns the
    clamped light colors ((T, chunk, 1) x 3), wd and ws (T, chunk, P).
    kinds: the light types to evaluate (math for absent types is skipped,
    bit-exact).  want_reach also returns light_reach's verdict (see
    light_live).  lvis (T, chunk, P): each light's local-shadow visibility
    at the pixel, which multiplies its gain (plane_select).  in_slice (T,
    1, P) bool: clustered mode, the pixels of the slice whose list blk is;
    the gain of every other pixel is multiplied by 0 (lsr_tpu
    shade_kernel.py:295-300), which is +0 or -0 for a finite gain."""
    def f(j):
        return blk[:, :, j:j + 1]                           # (T, chunk, 1)

    has_spot = LIGHT_SPOT in kinds
    has_rect = LIGHT_RECT_AREA in kinds
    has_tube = LIGHT_TUBE_AREA in kinds
    ltype = f(0)
    posx, posy, posz = f(1), f(2), f(3)
    if has_spot or has_rect:
        fwdx, fwdy, fwdz = _unit3(f(4), f(5), f(6))
    if has_rect:
        upx, upy, upz = _unit3(f(7), f(8), f(9))
    if has_tube:
        axx, axy, axz = _unit3(f(10), f(11), f(12))
    colr, colg, colb = f(13), f(14), f(15)
    intensity = f(16)
    rng = torch.clamp(f(17), min=0.001)
    inner = torch.clamp(f(18), 0.02, _HALF_PI - 0.02)
    outer = torch.minimum(torch.maximum(torch.maximum(inner + 0.005, f(19)),
                                        inner + 0.005),
                          _f(inner, _HALF_PI - 0.005))
    hex_ = torch.clamp(f(20), min=0.05)
    hey = torch.clamp(f(21), min=0.05)
    thl = torch.clamp(f(22), min=0.1)
    amodel = f(24)
    apow = torch.clamp(f(25), min=0.001)
    abias = torch.clamp(f(26), min=1e-5)
    acut = f(27)
    is_spot = ltype == float(LIGHT_SPOT)
    is_rect = ltype == float(LIGHT_RECT_AREA)
    is_tube = ltype == float(LIGHT_TUBE_AREA)

    emx, emy, emz = posx, posy, posz
    if has_rect or has_tube:
        dxp, dyp, dzp = px - posx, py - posy, pz - posz
    if has_rect:
        rx0, ry0, rz0 = _unit3(upy * fwdz - upz * fwdy,
                               upz * fwdx - upx * fwdz,
                               upx * fwdy - upy * fwdx)
        u2x, u2y, u2z = _unit3(fwdy * rz0 - fwdz * ry0,
                               fwdz * rx0 - fwdx * rz0,
                               fwdx * ry0 - fwdy * rx0)
        rx, ry, rz = _unit3(u2y * fwdz - u2z * fwdy,
                            u2z * fwdx - u2x * fwdz,
                            u2x * fwdy - u2y * fwdx)
        ux = torch.minimum(torch.maximum(dxp * rx + dyp * ry + dzp * rz,
                                         -hex_), hex_)
        uy = torch.minimum(torch.maximum(dxp * u2x + dyp * u2y + dzp * u2z,
                                         -hey), hey)
        emx = torch.where(is_rect, posx + rx * ux + u2x * uy, emx)
        emy = torch.where(is_rect, posy + ry * ux + u2y * uy, emy)
        emz = torch.where(is_rect, posz + rz * ux + u2z * uy, emz)
    if has_tube:
        ax2, ay2, az2 = axx * (2.0 * thl), axy * (2.0 * thl), axz * (2.0 * thl)
        a0x, a0y, a0z = posx - axx * thl, posy - axy * thl, posz - axz * thl
        denom_seg = torch.clamp(ax2 * ax2 + ay2 * ay2 + az2 * az2, min=1e-8)
        tseg = torch.clamp(((px - a0x) * ax2 + (py - a0y) * ay2
                            + (pz - a0z) * az2) / denom_seg, 0.0, 1.0)
        emx = torch.where(is_tube, a0x + ax2 * tseg, emx)
        emy = torch.where(is_tube, a0y + ay2 * tseg, emy)
        emz = torch.where(is_tube, a0z + az2 * tseg, emz)

    tlx, tly, tlz = emx - px, emy - py, emz - pz
    dist = torch.sqrt(torch.clamp(tlx * tlx + tly * tly + tlz * tlz,
                                  min=1e-16))
    inv_d = 1.0 / dist
    llx, lly, llz = tlx * inv_d, tly * inv_d, tlz * inv_d

    shaping = torch.ones_like(dist)
    shaped = torch.ones_like(dist, dtype=torch.bool)
    if has_spot:
        cos_t = -(llx * fwdx + lly * fwdy + llz * fwdz)
        cin = torch.cos(inner)
        cout = torch.cos(outer)
        tt = torch.clamp((cos_t - cout) / torch.clamp(cin - cout, min=1e-5),
                         0.0, 1.0)
        spot = torch.where(cos_t > cout, tt * tt * (3.0 - 2.0 * tt),
                           torch.zeros_like(tt))
        shaping = torch.where(is_spot, spot, shaping)
        shaped = torch.where(is_spot, cos_t > cout, shaped)
    if has_rect:
        facing = torch.clamp(-(fwdx * llx + fwdy * lly + fwdz * llz), min=0.0)
        rect = torch.where(facing > 0.0, 0.65 + 0.55 * facing,
                           torch.zeros_like(facing))
        shaping = torch.where(is_rect, rect, shaping)
        shaped = torch.where(is_rect, facing > 0.0, shaped)
    if has_tube:
        soft = torch.clamp(1.0 - dist / rng, 0.0, 1.0)
        shaping = torch.where(is_tube, 0.75 + 0.35 * soft, shaping)
    spec_pw = torch.where(is_spot, _f(ltype, 34.0), _f(ltype, 36.0))
    spec_sc = torch.where(is_spot, _f(ltype, 0.32), _f(ltype, 0.30))
    if has_rect:
        spec_pw = torch.where(is_rect, _f(ltype, 26.0), spec_pw)
        spec_sc = torch.where(is_rect, _f(ltype, 0.26), spec_sc)
    if has_tube:
        spec_pw = torch.where(is_tube, _f(ltype, 22.0), spec_pw)
        spec_sc = torch.where(is_tube, _f(ltype, 0.20), spec_sc)

    norm = torch.clamp(1.0 - dist / rng, 0.0, 1.0)
    smooth = norm * norm * (3.0 - 2.0 * norm)
    invsq = torch.clamp((rng * rng) / torch.maximum(dist * dist, abias),
                        max=1.0) * norm * norm
    fall = torch.where(amodel == 0.0, norm,
                       torch.where(amodel == 1.0, smooth, invsq))
    if not apow1:
        fall = torch.pow(torch.clamp(fall, min=1e-9), apow)
    fall = torch.where((acut > 0.0) & (fall < acut), torch.zeros_like(fall),
                       fall)
    atten = torch.where(dist < rng, fall, torch.zeros_like(fall)) \
        * torch.clamp(shaping, min=0.0)

    lndl = torch.clamp(nx * llx + ny * lly + nz * llz, min=0.0)
    live = (dist > 1e-4) & (lndl > 0.0) & (atten > 0.0) & covered
    gain = torch.where(live, intensity * atten, torch.zeros_like(atten))
    if lvis is not None:
        gain = gain * lvis
    if in_slice is not None:
        gain = gain * in_slice.to(torch.float32)
    hxl, hyl, hzl = llx + vx, lly + vy, llz + vz
    hll = _rsqrt(torch.clamp(hxl * hxl + hyl * hyl + hzl * hzl, min=1e-16))
    lndh = torch.clamp(nx * (hxl * hll) + ny * (hyl * hll) + nz * (hzl * hll),
                       min=0.0)
    spec = spec_sc * torch.pow(torch.clamp(lndh, min=1e-9), spec_pw)
    cols = [torch.clamp(c, min=0.0) for c in (colr, colg, colb)]
    if want_reach:
        reach = (covered & (dist > 1e-4) & (dist < rng) & (lndl > 0.0)
                 & shaped)
        return cols, gain * lndl, gain * spec, reach
    return cols, gain * lndl, gain * spec


def light_live(blk, px, py, pz, nx, ny, nz, covered, kinds):
    """(T, chunk, P) bool: the (light, pixel) pairs that can add anything,
    the plain model of light_reach's verdict in csrc/light_loop.cuh, on
    which the warps of kernels B2, B5 and B6 vote before they pay for a
    light's attenuation and specular terms.  A pair is live when the pixel is covered, off the
    emitter (dist > 1e-4), in range (dist < rng), faces the light (N.L > 0)
    and lies inside a spot's cone or in front of a rect; anywhere else
    light_terms' gain is 0 and its wd and ws are +0."""
    zero = torch.zeros_like(px)
    return light_terms(blk, px, py, pz, nx, ny, nz, zero, zero, zero,
                       covered, True, kinds, want_reach=True)[3]


def plane_select(vis_tiles, blk):
    """(T, chunk, P) local-shadow visibility of each light of a chunk at
    each pixel: plane blk[..., 28] of vis_tiles (T, K + 1, P), the tile
    planes of the (K + 1, H, W) stack.  lsr_tpu sums the one-hot select
    sum_k where(idx == k, plane_k, 0) (shade_kernel.py:270-294), which is
    the indexed plane exactly for planes in [0, 1]."""
    idx = blk[..., 28].to(torch.int64)                       # (T, chunk)
    return torch.gather(vis_tiles, 1, idx[..., None].expand(
        -1, -1, vis_tiles.shape[-1]))


def vis_tile_planes(planes, ph, pw, th, tw, tiles_y, tiles_x):
    """(K + 1, H, W) visibility planes -> (T, K + 1, P) tile planes, padded
    with 1.0 (no pixel there is kept)."""
    h, w = planes.shape[1:]
    padded = torch.nn.functional.pad(planes.to(torch.float32),
                                     (0, pw - w, 0, ph - h), value=1.0)
    return tile_planes(padded, th, tw, tiles_y, tiles_x)[:, :, 0].transpose(
        0, 1)


def check_shadow_planes(name, planes, light_shadow_index, lights, height,
                        width):
    """Local-shadow planes and the light -> plane index come together: (K
    + 1, H, W) planes, plane K the constant 1.0 of unshadowed lights, and
    one index in [0, K] per light."""
    if (planes is None) != (light_shadow_index is None):
        raise ValueError(f"{name}: local-shadow planes and "
                         f"light_shadow_index come together")
    if planes is None:
        return
    if planes.ndim != 3 or tuple(planes.shape[1:]) != (height, width):
        raise ValueError(f"{name}: local-shadow planes must be (K + 1, "
                         f"{height}, {width}), got {tuple(planes.shape)}")
    if tuple(light_shadow_index.shape) != (lights.count,):
        raise ValueError(f"{name}: light_shadow_index must hold one plane "
                         f"per light")


def slice_lists(tile_rec, counts, slices):
    """The lists of a launch, walked in order: (slice, records (T, cap, 32),
    counts (T,)) for each slice of clustered records, or one (None,
    tile_rec, counts) for tiled ones."""
    if not slices:
        yield None, tile_rec, counts
        return
    cap = tile_rec.shape[1] // slices
    per_tile = counts.reshape(-1, slices)
    for sl in range(slices):
        yield sl, tile_rec[:, sl * cap:(sl + 1) * cap], per_tile[:, sl]


def walk_chunks(tile_rec, counts, chunk):
    """The chunks of every tile's list that the kernels walk: the largest
    tile's min(ceil(count / chunk), cap / chunk) (one host sync); smaller
    tiles meet zero records past their count, which add exactly zero.
    Yields (T, chunk, 32) record blocks."""
    cap = tile_rec.shape[1]
    n_chunks = min(cdiv(int(counts.max()), chunk), cap // chunk)
    for ci in range(n_chunks):
        yield tile_rec[:, ci * chunk:(ci + 1) * chunk, :]


def _shade_plain(gbuf, tile_rec, counts, uni, th, tw, tiles_y, tiles_x,
                 chunk, sun_model, apow1, kinds, vis_planes=None, slices=0):
    """Plain PyTorch version of kernel B2: every tile's list evaluated per
    pixel in the kernel's operation order, in (tiles, chunk, pixels) layout.
    vis_planes: (K + 1, H, W) local-shadow planes, selected per light by
    record lane 28.  slices > 0 (B2b): the lists of each slice in turn,
    each light's gain kept only at the pixels of that slice (G-buffer plane
    13).  Returns (3, ph, pw) lit planes."""
    g = tile_planes(gbuf, th, tw, tiles_y, tiles_x)
    vis_t = None if vis_planes is None else vis_tile_planes(
        vis_planes, gbuf.shape[1], gbuf.shape[2], th, tw, tiles_y, tiles_x)
    px, py, pz = g[0], g[1], g[2]
    nx, ny, nz = g[3], g[4], g[5]
    covered = g[6] > 0.0
    dr, dg, db = _sun_term(g, uni, sun_model)
    vx, vy, vz = _unit3(uni[0] - px, uni[1] - py, uni[2] - pz)

    acc = [torch.zeros_like(px) for _ in range(6)]
    for sl, rec, cnt in slice_lists(tile_rec, counts, slices):
        in_slice = None if sl is None else g[13] == float(sl)
        for blk in walk_chunks(rec, cnt, chunk):
            cols, wd, ws = light_terms(
                blk, px, py, pz, nx, ny, nz, vx, vy, vz, covered, apow1,
                kinds, in_slice=in_slice,
                lvis=None if vis_t is None else plane_select(vis_t, blk))
            for i, c in enumerate(cols):
                acc[i] = acc[i] + (c * wd).sum(dim=1, keepdim=True)
                acc[3 + i] = acc[3 + i] + (c * ws).sum(dim=1, keepdim=True)

    covf = covered.to(torch.float32)
    sun = (dr, dg, db)
    lit = torch.stack([(sun[i] + g[7 + i] * acc[i] + acc[3 + i]) * covf
                       for i in range(3)])
    return untile_planes(lit, th, tw, tiles_y, tiles_x)


def bin_light_records(lights, view, proj, width, height, tile_h, tile_w, cap,
                      tile_depth_range, light_shadow_index=None, n_planes=0,
                      slices=0, zn=None, zf=None):
    """Bin the lights per screen tile (or, slices > 0, per (tile, log-Z
    slice) between zn and zf) and gather each list's 32-lane records; empty
    list slots hold zero records.  With local-shadow planes (n_planes = K +
    1), lane 28 holds each light's plane index as f32 (lsr_tpu's
    shade_kernel.py:434-447) and an empty slot's is K, the constant plane,
    so no kernel reads a plane for it.
    Returns (tile_rec (tiles, [slices *] cap, 32), counts (tiles [*
    slices],), bin_stats)."""
    if slices:
        lists, counts, bin_stats = cull_lights_clustered(
            lights, view, proj, zn, zf, width, height, tile_size=tile_w,
            tile_h=tile_h, cap=cap, slices=slices)
        count_occupancy("b2b_lists", counts, cap, bin_stats)
    else:
        lists, counts, bin_stats = cull_lights_tiled(
            lights, view, proj, width, height, tile_size=tile_w,
            tile_h=tile_h, cap=cap, tile_depth_range=tile_depth_range)
    packed = pack_light_records(lights)
    if light_shadow_index is not None:
        packed[:, 28] = light_shadow_index.to(torch.float32)
    tile_rec = torch.where((lists >= 0)[..., None],
                           packed[torch.clamp(lists, min=0)],
                           torch.zeros((), dtype=torch.float32,
                                       device=packed.device))
    if light_shadow_index is not None:
        tile_rec[..., 28] = torch.where(
            lists >= 0, tile_rec[..., 28],
            torch.full_like(tile_rec[..., 28], float(n_planes - 1)))
    if slices:
        tile_rec = tile_rec.reshape(-1, slices * cap, 32)
    return tile_rec, counts, bin_stats


def pad_planes(planes, ph, pw):
    """(H, W) planes -> one (C, ph, pw) f32 stack, zero padded."""
    return torch.stack([torch.nn.functional.pad(
        p.to(torch.float32), (0, pw - p.shape[1], 0, ph - p.shape[0]))
        for p in planes])


def _prepare(gb_world_pos, gb_normal, gb_covered, albedo, metallic,
             roughness, sun_shadow_vis, camera_pos, sun_dir_ws, sun_radiance,
             lights, view, proj, width, height, tile_h, tile_w, cap, chunk,
             tile_depth_range, sun_model, local_vis_stack, light_shadow_index,
             cluster_slice_plane, slices, zn=None, zf=None):
    """Light binning, tile records, G-buffer planes and uniforms shared by
    the kernel and its plain version (shade_kernel.py:415-488 of lsr_tpu)."""
    if (cluster_slice_plane is None) != (slices == 0) or slices < 0:
        raise ValueError("shade_fused: cluster_slice_plane and slices > 0 "
                         "come together")
    if slices and (zn is None or zf is None):
        raise ValueError("shade_fused: clustered slices need zn and zf")
    if slices and tuple(cluster_slice_plane.shape) != (height, width):
        raise ValueError(f"shade_fused: cluster_slice_plane must be "
                         f"({height}, {width})")
    if sun_model not in SUN_MODELS:
        raise ValueError(f"shade_fused: sun_model must be one of {SUN_MODELS}")
    if (tile_h, tile_w, chunk) != (64, 128, 8) or cap % chunk:
        raise ValueError("shade_fused: the kernel is built for 64x128 tiles, "
                         "8-light chunks and a cap that is a multiple of 8")
    vis_planes = None if local_vis_stack is None \
        else local_vis_stack.permute(2, 0, 1)
    check_shadow_planes("shade_fused", vis_planes, light_shadow_index, lights,
                        height, width)
    tiles_x = cdiv(width, tile_w)
    tiles_y = cdiv(height, tile_h)
    ph, pw = tiles_y * tile_h, tiles_x * tile_w
    tile_rec, counts, bin_stats = bin_light_records(
        lights, view, proj, width, height, tile_h, tile_w, cap,
        tile_depth_range, light_shadow_index,
        0 if vis_planes is None else vis_planes.shape[0], slices, zn, zf)
    zeros = torch.zeros_like(metallic)
    gbuf = pad_planes([
        gb_world_pos[..., 0], gb_world_pos[..., 1], gb_world_pos[..., 2],
        gb_normal[..., 0], gb_normal[..., 1], gb_normal[..., 2], gb_covered,
        albedo[..., 0], albedo[..., 1], albedo[..., 2], metallic, roughness,
        sun_shadow_vis, zeros if cluster_slice_plane is None
        else cluster_slice_plane, zeros, zeros], ph, pw)
    sd = sun_dir_ws / torch.clamp(torch.sqrt((sun_dir_ws * sun_dir_ws).sum()),
                                  min=1e-8)
    uni = torch.cat([camera_pos.reshape(3), sd.reshape(3),
                     sun_radiance.reshape(3)]).to(torch.float32)
    return (gbuf, tile_rec, counts, uni, bin_stats, (tiles_y, tiles_x),
            vis_planes)


def shade_fused_plain(gb_world_pos, gb_normal, gb_covered, albedo, metallic,
                      roughness, sun_shadow_vis, camera_pos, sun_dir_ws,
                      sun_radiance, lights, view, proj, width: int,
                      height: int, tile_h: int = 64, tile_w: int = 128,
                      cap: int = 256, chunk: int = 8, tile_depth_range=None,
                      sun_model: str = "pbr_mr", local_vis_stack=None,
                      light_shadow_index=None, cluster_slice_plane=None,
                      slices: int = 0, zn=None, zf=None):
    """The plain PyTorch version of shade_fused on any device (what
    shade_fused runs for CPU tensors).  Returns ((H, W, 3) lit, bin_stats)."""
    (gbuf, tile_rec, counts, uni, bin_stats, (tiles_y, tiles_x),
     vis_planes) = _prepare(
        gb_world_pos, gb_normal, gb_covered, albedo, metallic, roughness,
        sun_shadow_vis, camera_pos, sun_dir_ws, sun_radiance, lights, view,
        proj, width, height, tile_h, tile_w, cap, chunk, tile_depth_range,
        sun_model, local_vis_stack, light_shadow_index, cluster_slice_plane,
        slices, zn, zf)
    lit = _shade_plain(gbuf, tile_rec, counts, uni, tile_h, tile_w, tiles_y,
                       tiles_x, chunk, sun_model, lights.apow1, lights.kinds,
                       vis_planes, slices)
    return lit[:, :height, :width].permute(1, 2, 0), bin_stats


def _shade_launch(lib, gbuf, tile_rec, counts, uni, width, height, sun_model,
                  apow1, stream, vis_planes=None, slices=0):
    """Launch kernel B2 through the C interface; returns (H, W, 3) lit.
    vis_planes: contiguous (K + 1, H, W) f32 local-shadow planes.  slices >
    0: clustered records (tiles, slices * cap, 32), the slice plane in
    G-buffer plane 13 (B2b)."""
    ph, pw = gbuf.shape[1], gbuf.shape[2]
    cap = tile_rec.shape[1] // max(slices, 1)
    counts32 = counts.to(torch.int32)
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=gbuf.device)
    args = [gbuf.data_ptr(), tile_rec.data_ptr(), counts32.data_ptr(),
            uni.data_ptr(),
            None if vis_planes is None else vis_planes.data_ptr(),
            0 if vis_planes is None else vis_planes.shape[0] - 1,
            out.data_ptr(), width, height, ph, pw, pw // 128, cap]
    if slices:
        fn, args = lib.lsr_shade_fused_clustered, args + [slices]
    else:
        fn = lib.lsr_shade_fused
    check_launch(fn.__name__, fn(*args, SUN_MODELS.index(sun_model),
                                 int(bool(apow1)), stream))
    return out


def shade_fused(gb_world_pos, gb_normal, gb_covered, albedo, metallic,
                roughness, sun_shadow_vis, camera_pos, sun_dir_ws,
                sun_radiance, lights, view, proj, width: int, height: int,
                tile_h: int = 64, tile_w: int = 128, cap: int = 256,
                chunk: int = 8, tile_depth_range=None,
                sun_model: str = "pbr_mr", local_vis_stack=None,
                light_shadow_index=None, cluster_slice_plane=None,
                slices: int = 0, zn=None, zf=None):
    """Sun + binned local lighting, fused.  Returns ((H, W, 3) lit,
    bin_stats).  The result is direct sun + albedo-modulated local diffuse +
    local specular, zeroed outside coverage; ambient, emissive and the
    background are added by the caller.

    local_vis_stack (H, W, K + 1) with light_shadow_index (L,): the local
    shadow planes (lighting/local_shadows), plane K the constant 1.0; each
    light's gain is multiplied by its plane at the pixel (kernel variant
    B2a).  cluster_slice_plane (H, W) int with slices > 0, zn and zf:
    clustered mode (variant B2b), lists per (tile, log-Z slice) from
    cull_lights_clustered, and a pixel takes only the lights of its own
    slice (light_culling.view_depth_to_cluster_slice).  The light set's
    host constants decide two things without a sync: lights.apow1 skips
    the attenuation pow (exact when every power is 1), lights.kinds lets
    the plain version skip math for absent light types (bit-exact; the
    CUDA kernel branches per light instead).
    CPU tensors run the plain version; CUDA tensors launch kernel B2 or
    raise."""
    args = (gb_world_pos, gb_normal, gb_covered, albedo, metallic, roughness,
            sun_shadow_vis, camera_pos, sun_dir_ws, sun_radiance, lights,
            view, proj, width, height, tile_h, tile_w, cap, chunk,
            tile_depth_range, sun_model, local_vis_stack, light_shadow_index,
            cluster_slice_plane, slices, zn, zf)
    dev = gb_world_pos.device
    if dev.type == "cpu":
        return shade_fused_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"shade_fused: unsupported device {dev}")
    (gbuf, tile_rec, counts, uni, bin_stats, (tiles_y, tiles_x),
     vis_planes) = _prepare(*args)
    if vis_planes is not None:
        vis_planes = vis_planes.to(torch.float32).contiguous()
    for name, t in (("gbuf", gbuf), ("tile_rec", tile_rec), ("uniforms", uni),
                    ("local-shadow planes", vis_planes)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"shade_fused: {name} must be contiguous f32 "
                             f"on {dev}")
    if tuple(tile_rec.shape) != (tiles_y * tiles_x, max(slices, 1) * cap, 32):
        raise ValueError(f"shade_fused: tile records {tuple(tile_rec.shape)}")
    out = _shade_launch(load_kernels(), gbuf, tile_rec, counts, uni, width,
                        height, sun_model, lights.apow1,
                        torch.cuda.current_stream(dev).cuda_stream,
                        vis_planes, slices)
    shade_fused.launches += 1
    return out, bin_stats


shade_fused.launches = 0
