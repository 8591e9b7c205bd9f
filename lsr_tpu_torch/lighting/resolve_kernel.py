"""Fused resolve, kernel B5 (port of lsr_tpu/lighting/resolve_kernel.py:
resolve_fused_pallas / _resolve_kernel).

Visibility buffer -> lit HDR in one pass: barycentric weights, world
position and normal, material, sun BRDF x sun visibility, the binned
local-light loop, fake-IBL ambient, emissive and the background.

lsr_tpu gathers a (H, W, 56) interp record per pixel before its kernel (a
TPU kernel cannot gather).  Here the kernel takes pack_interp_records'
(rows, 56) table and the (H, W) triangle ids and reads each pixel's row
itself; the plain version takes the same inputs and gathers with torch.
An uncovered pixel (tid < 0) reads row 0, as lsr_tpu's clamped gather
does, and takes the background.  Each chunk of per-light terms is summed
as lsr_tpu's pairwise tree (_sum0), in the kernel and the plain version
alike.  No attenuation-pow skip: B5 always applies it.

The kernel prepares each light once per block and never evaluates a light
for a warp (8x4 pixels) that it cannot reach: the light walk it shares with
B2 and B6, modelled in lighting/light_walk.py.

Uniforms (12,) f32: 0:3 camera_pos | 3:6 sun dir (unit) | 6:9 sun radiance
| 9:12 background.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import cdiv, device_const
from lsr_tpu_torch.lighting import light_walk
from lsr_tpu_torch.lighting.shade_kernel import (
    SUN_MODELS,
    _rsqrt,
    _sun_term,
    _unit3,
    bin_light_records,
    check_shadow_planes,
    light_terms,
    pad_planes,
    plane_select,
    tile_planes,
    untile_planes,
    vis_tile_planes,
    walk_chunks,
)
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

REC_LANES = 56
REC_LAYOUTS = ("planes", "lanes")


def _pairwise_sum(x):
    """(T, chunk, P) -> (T, 1, P) summed as lsr_tpu's _sum0 tree:
    neighbours first, an odd last part carried up."""
    parts = [x[:, j:j + 1] for j in range(x.shape[1])]
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _env(up, g, h, z):
    # lsr_tpu's env(): z - h is folded in double by Python, then rounded.
    return g + ((h + (z - h) * up) - g) * up


def _check(rec_table, tid, lights, tile_h, tile_w, cap, chunk, sun_model,
           rec_layout, local_vis_planes, light_shadow_index):
    check_shadow_planes("resolve_fused", local_vis_planes,
                        light_shadow_index, lights, *tid.shape)
    if sun_model not in SUN_MODELS:
        raise ValueError(f"resolve_fused: sun_model must be one of "
                         f"{SUN_MODELS}")
    if rec_layout not in REC_LAYOUTS:
        raise ValueError(f"resolve_fused: rec_layout must be one of "
                         f"{REC_LAYOUTS}")
    if chunk not in (8, 16) or cap % chunk or tile_h % 8 or tile_w % 32:
        raise ValueError("resolve_fused: chunk must be 8 or 16 and divide "
                         "cap; tiles must be multiples of 8x32")
    if rec_table.ndim != 2 or rec_table.shape[1] != REC_LANES:
        raise ValueError("resolve_fused: the record table must be "
                         "pack_interp_records(setup, materials), (rows, 56)")


def _uniforms(camera_pos, sun_dir_ws, sun_radiance, background, dev):
    sd = sun_dir_ws / torch.clamp(torch.sqrt((sun_dir_ws * sun_dir_ws).sum()),
                                  min=1e-8)
    bg = device_const(background, dev)
    return torch.cat([camera_pos.reshape(3), sd.reshape(3),
                      sun_radiance.reshape(3), bg.reshape(3)]
                     ).to(torch.float32)


def _pixel_planes(rec_table, tid, sun_vis, tex_albedo, width, height, th, tw,
                  tiles_y, tiles_x):
    """The per-pixel inputs of the light loop, interpolated through tid in
    kernel B5's operation order, as (17, tiles, 1, th * tw) tile planes:
    0:3 world_pos | 3:6 unit normal | 6 covered | 7:10 albedo | 10 metallic
    | 11 roughness | 12 sun visibility | 13 ao | 14:17 emissive."""
    dev = rec_table.device
    covered = tid >= 0
    rec = rec_table[torch.where(covered, tid, torch.zeros_like(tid))
                    .to(torch.int64)]                       # (H, W, 56)

    def r(c):
        return rec[..., c]

    sx = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    sy = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    w0 = (r(0) * sx + r(1) * sy + r(2)) * r(9)
    w1 = (r(3) * sx + r(4) * sy + r(5)) * r(10)
    w2 = (r(6) * sx + r(7) * sy + r(8)) * r(11)
    inv_den = 1.0 / torch.clamp(w0 + w1 + w2, min=1e-12)
    w0, w1, w2 = w0 * inv_den, w1 * inv_den, w2 * inv_den
    p = [w0 * r(12 + i) + w1 * r(15 + i) + w2 * r(18 + i) for i in range(3)]
    n0 = [w0 * r(21 + i) + w1 * r(24 + i) + w2 * r(27 + i) for i in range(3)]
    nl = _rsqrt(torch.clamp(n0[0] * n0[0] + n0[1] * n0[1] + n0[2] * n0[2],
                            min=1e-24))
    alb = [torch.clamp(r(40 + i), min=0.0) * tex_albedo[..., i]
           for i in range(3)]
    return tile_planes(pad_planes(
        p + [n * nl for n in n0] + [covered] + alb
        + [torch.clamp(r(43), 0.0, 1.0), r(44), sun_vis,
           torch.clamp(r(45), 0.0, 1.0), r(46), r(47), r(48)],
        tiles_y * th, tiles_x * tw), th, tw, tiles_y, tiles_x)


def walk_counts(rec_table, tid, tex_albedo, tile_rec, counts, width: int,
                height: int, th: int, tw: int, chunk: int, kinds,
                n_shadowed: int = 0):
    """light_walk.walk_counts of a B5 launch: what its light walk meets and
    what its box test and vote leave of it, on the kernel's own inputs."""
    no_vis = torch.zeros_like(tid, dtype=torch.float32)   # not read here
    g = _pixel_planes(rec_table, tid, no_vis, tex_albedo, width, height, th,
                      tw, cdiv(height, th), cdiv(width, tw))
    return light_walk.walk_counts(g[0], g[1], g[2], g[3], g[4], g[5],
                                  g[6] > 0.0, tile_rec, counts, th, tw, chunk,
                                  kinds, n_shadowed)


def _resolve_plain(rec_table, tid, sun_vis, tex_albedo, tile_rec, counts,
                   uni, width, height, th, tw, tiles_y, tiles_x, chunk,
                   sun_model, kinds, vis_planes=None):
    """Plain PyTorch version of kernel B5, in its operation order.
    vis_planes: (K + 1, H, W) local-shadow planes, selected per light by
    record lane 28.  Returns (H, W, 3) HDR."""
    g = _pixel_planes(rec_table, tid, sun_vis, tex_albedo, width, height, th,
                      tw, tiles_y, tiles_x)
    vis_t = None if vis_planes is None else vis_tile_planes(
        vis_planes, tiles_y * th, tiles_x * tw, th, tw, tiles_y, tiles_x)
    px, py, pz, nx, ny, nz = g[0], g[1], g[2], g[3], g[4], g[5]
    cov = g[6] > 0.0
    metal, rough, ao = g[10], g[11], g[13]

    sun = _sun_term(g, uni, sun_model)
    vx, vy, vz = _unit3(uni[0] - px, uni[1] - py, uni[2] - pz)
    acc = [torch.zeros_like(px) for _ in range(6)]
    for blk in walk_chunks(tile_rec, counts, chunk):
        cols, wd, ws = light_terms(
            blk, px, py, pz, nx, ny, nz, vx, vy, vz, cov, False, kinds,
            lvis=None if vis_t is None else plane_select(vis_t, blk))
        for i, c in enumerate(cols):
            acc[i] = acc[i] + _pairwise_sum(c * wd)
            acc[3 + i] = acc[3 + i] + _pairwise_sum(c * ws)

    # Fake-IBL ambient (eval_fake_ibl, inlined as in lsr_tpu's kernel).
    ndv_c = nx * vx + ny * vy + nz * vz
    rvy = 2.0 * ndv_c * ny - vy
    up_n = torch.clamp(ny * 0.5 + 0.5, 0.0, 1.0)
    up_r = torch.clamp(rvy * 0.5 + 0.5, 0.0, 1.0)
    consts = ((0.16, 0.62, 0.32), (0.15, 0.66, 0.46), (0.14, 0.72, 0.72))
    rgh = torch.clamp(rough, 0.0, 1.0)
    fres_a = torch.pow(1.0 - torch.clamp(ndv_c, min=0.0), 5.0)
    spec_str = 0.02 + (1.0 - rgh) * 0.18
    covf = cov.to(torch.float32)
    out = []
    for i, (cg, ch, cz) in enumerate(consts):
        a = g[7 + i]
        f0 = 0.04 + (torch.clamp(a, min=0.0) - 0.04) * metal
        fa = f0 + (1.0 - f0) * fres_a
        amb = ((1.0 - fa) * (1.0 - metal) * a * _env(up_n, cg, ch, cz) * 0.12
               + _env(up_r, cg, ch, cz) * fa * spec_str) * ao
        out.append((sun[i] + a * acc[i] + acc[3 + i] + (amb + g[14 + i]))
                   * covf + uni[9 + i] * (1.0 - covf))
    hdr = untile_planes(torch.stack(out), th, tw, tiles_y, tiles_x)
    return hdr[:, :height, :width].permute(1, 2, 0)


def resolve_fused_plain(rec_table, tid, sun_vis, tex_albedo, camera_pos,
                        sun_dir_ws, sun_radiance, background, lights, view,
                        proj, width: int, height: int, tile_h: int = 64,
                        tile_w: int = 128, cap: int = 256, chunk: int = 16,
                        tile_depth_range=None, sun_model: str = "pbr_mr",
                        rec_layout: str = "planes", local_vis_planes=None,
                        light_shadow_index=None):
    """The plain PyTorch version of resolve_fused on any device (what
    resolve_fused runs for CPU tensors).  Returns ((H, W, 3) hdr,
    bin_stats)."""
    _check(rec_table, tid, lights, tile_h, tile_w, cap, chunk, sun_model,
           rec_layout, local_vis_planes, light_shadow_index)
    tile_rec, counts, bin_stats = _bin(lights, view, proj, width, height,
                                       tile_h, tile_w, cap, tile_depth_range,
                                       local_vis_planes, light_shadow_index)
    uni = _uniforms(camera_pos, sun_dir_ws, sun_radiance, background,
                    rec_table.device)
    hdr = _resolve_plain(rec_table, tid, sun_vis, tex_albedo, tile_rec,
                         counts, uni, width, height, tile_h, tile_w,
                         cdiv(height, tile_h), cdiv(width, tile_w), chunk,
                         sun_model, lights.kinds, local_vis_planes)
    return hdr, bin_stats


def _bin(lights, view, proj, width, height, tile_h, tile_w, cap,
         tile_depth_range, local_vis_planes, light_shadow_index):
    """bin_light_records with the lights' planes in record lane 28."""
    return bin_light_records(
        lights, view, proj, width, height, tile_h, tile_w, cap,
        tile_depth_range, light_shadow_index,
        0 if local_vis_planes is None else local_vis_planes.shape[0])


def _resolve_launch(lib, rec_table, tid, sun_vis, tex_albedo, tile_rec,
                    counts, uni, width, height, tile_h, tile_w, chunk,
                    sun_model, stream, vis_planes=None):
    """Launch kernel B5 through the C interface; returns (H, W, 3) HDR.
    vis_planes: contiguous (K + 1, H, W) f32 local-shadow planes."""
    dev = rec_table.device
    tid32 = tid.to(torch.int32).contiguous()
    counts32 = counts.to(torch.int32)
    checked = [("sun_vis", sun_vis, (height, width)),
               ("tex_albedo", tex_albedo, (height, width, 3))]
    if vis_planes is not None:
        checked.append(("local-shadow planes", vis_planes,
                        (vis_planes.shape[0], height, width)))
    for name, t, shape in checked:
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"resolve_fused: {name} must be a contiguous "
                             f"f32 {shape} tensor on {dev}")
    if tuple(tid32.shape) != (height, width):
        raise ValueError(f"resolve_fused: tid {tuple(tid.shape)}")
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    err = lib.lsr_resolve_fused(
        rec_table.data_ptr(), tid32.data_ptr(), sun_vis.data_ptr(),
        tex_albedo.data_ptr(), tile_rec.data_ptr(), counts32.data_ptr(),
        uni.data_ptr(),
        None if vis_planes is None else vis_planes.data_ptr(),
        0 if vis_planes is None else vis_planes.shape[0] - 1,
        out.data_ptr(), width, height, tile_h, tile_w,
        cdiv(width, tile_w), cdiv(height, tile_h), tile_rec.shape[1], chunk,
        SUN_MODELS.index(sun_model), stream)
    check_launch("lsr_resolve_fused", err)
    return out


def resolve_fused(rec_table, tid, sun_vis, tex_albedo, camera_pos,
                  sun_dir_ws, sun_radiance, background, lights, view, proj,
                  width: int, height: int, tile_h: int = 64,
                  tile_w: int = 128, cap: int = 256, chunk: int = 16,
                  tile_depth_range=None, sun_model: str = "pbr_mr",
                  rec_layout: str = "planes", local_vis_planes=None,
                  light_shadow_index=None):
    """Fused interp + shade resolve.  Returns ((H, W, 3) hdr, bin_stats).

    rec_table: pack_interp_records(setup, materials) (rows, 56); tid: (H, W)
    winning rows (-1 = background); sun_vis (H, W); tex_albedo (H, W, 3)
    (ones where untextured).  rec_layout is lsr_tpu's VMEM layout choice and
    both values give the same result here.  local_vis_planes (K + 1, H, W)
    with light_shadow_index (L,): the local-shadow planes, plane K the
    constant 1.0; each light's gain is multiplied by its plane at the pixel
    (kernel variant B5a).  CPU tensors run the plain version; CUDA tensors
    launch kernel B5 or raise."""
    args = (rec_table, tid, sun_vis, tex_albedo, camera_pos, sun_dir_ws,
            sun_radiance, background, lights, view, proj, width, height,
            tile_h, tile_w, cap, chunk, tile_depth_range, sun_model,
            rec_layout, local_vis_planes, light_shadow_index)
    dev = rec_table.device
    if dev.type == "cpu":
        return resolve_fused_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"resolve_fused: unsupported device {dev}")
    _check(rec_table, tid, lights, tile_h, tile_w, cap, chunk, sun_model,
           rec_layout, local_vis_planes, light_shadow_index)
    if (rec_table.dtype != torch.float32 or not rec_table.is_contiguous()
            or rec_table.data_ptr() % 16):
        raise ValueError("resolve_fused: the record table must be "
                         "contiguous f32, 16-byte aligned (the kernel reads "
                         "its rows with 16-byte loads)")
    tile_rec, counts, bin_stats = _bin(lights, view, proj, width, height,
                                       tile_h, tile_w, cap, tile_depth_range,
                                       local_vis_planes, light_shadow_index)
    uni = _uniforms(camera_pos, sun_dir_ws, sun_radiance, background, dev)
    out = _resolve_launch(
        load_kernels(), rec_table, tid, sun_vis, tex_albedo, tile_rec, counts,
        uni, width, height, tile_h, tile_w, chunk, sun_model,
        torch.cuda.current_stream(dev).cuda_stream,
        None if local_vis_planes is None
        else local_vis_planes.to(torch.float32).contiguous())
    resolve_fused.launches += 1
    return out, bin_stats


resolve_fused.launches = 0
