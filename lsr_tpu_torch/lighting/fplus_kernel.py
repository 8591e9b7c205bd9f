"""Forward+ light accumulation, kernel B6 (port of
lsr_tpu/lighting/fplus_kernel.py: accumulate_lights_pallas / _fplus_kernel).

Per pixel, the diffuse and specular sums of its screen tile's binned local
lights (no sun; the caller combines them with albedo, as
light_runtime.combine_local_light does).  Every light type is evaluated
and selected per light, and the attenuation pow is always applied, as in
lsr_tpu's kernel.  Tiles are the caller's (64x128 by default, 16x128 in
lsr_tpu's own tests and goldens); cap and chunk (8 or 16) are arguments and
each tile walks min(ceil(count / chunk), cap / chunk) chunks.  A chunk's
terms are summed in light order, then added to the running sums, in the
kernel (csrc/fplus_accumulate.cu) and the plain version alike; the kernel
leaves out the terms of lights that cannot reach a warp's pixels, which the
plain version adds as +0 (lighting/light_walk.py).

G-buffer planes (8, ph, pw): 0:3 world_pos | 3:6 normal | 6 covered | 7 pad.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import cdiv
from lsr_tpu_torch.lighting.light_types import (
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
)
from lsr_tpu_torch.lighting.shade_kernel import (
    _unit3,
    bin_light_records,
    light_terms,
    pad_planes,
    tile_planes,
    untile_planes,
    walk_chunks,
)
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

ALL_KINDS = (LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT, LIGHT_RECT_AREA,
             LIGHT_TUBE_AREA)


def _prepare(gb_world_pos, gb_normal, gb_covered, camera_pos, lights, view,
             proj, width, height, tile_h, tile_w, cap, chunk,
             tile_depth_range):
    """Light binning, tile records, G-buffer planes and the camera uniform
    shared by the kernel and its plain version."""
    if chunk not in (8, 16) or cap % chunk or tile_h % 8 or tile_w % 32:
        raise ValueError("accumulate_lights: chunk must be 8 or 16 and "
                         "divide cap; tiles must be multiples of 8x32")
    tiles_x, tiles_y = cdiv(width, tile_w), cdiv(height, tile_h)
    tile_rec, counts, bin_stats = bin_light_records(
        lights, view, proj, width, height, tile_h, tile_w, cap,
        tile_depth_range)
    zeros = torch.zeros_like(gb_world_pos[..., 0])
    gbuf = pad_planes([
        gb_world_pos[..., 0], gb_world_pos[..., 1], gb_world_pos[..., 2],
        gb_normal[..., 0], gb_normal[..., 1], gb_normal[..., 2], gb_covered,
        zeros], tiles_y * tile_h, tiles_x * tile_w)
    uni = camera_pos.reshape(3).to(torch.float32)
    return gbuf, tile_rec, counts, uni, bin_stats, (tiles_y, tiles_x)


def _accumulate_plain(gbuf, tile_rec, counts, uni, th, tw, tiles_y, tiles_x,
                      chunk):
    """Plain PyTorch version of kernel B6.  Returns (6, ph, pw): diffuse
    rgb, specular rgb."""
    g = tile_planes(gbuf, th, tw, tiles_y, tiles_x)
    px, py, pz, nx, ny, nz = g[0], g[1], g[2], g[3], g[4], g[5]
    covered = g[6] > 0.0
    vx, vy, vz = _unit3(uni[0] - px, uni[1] - py, uni[2] - pz)
    acc = [torch.zeros_like(px) for _ in range(6)]
    for blk in walk_chunks(tile_rec, counts, chunk):
        cols, wd, ws = light_terms(blk, px, py, pz, nx, ny, nz, vx, vy, vz,
                                   covered, False, ALL_KINDS)
        part = [torch.zeros_like(px) for _ in range(6)]
        for j in range(chunk):
            for i, c in enumerate(cols):
                part[i] = part[i] + c[:, j:j + 1] * wd[:, j:j + 1]
                part[3 + i] = part[3 + i] + c[:, j:j + 1] * ws[:, j:j + 1]
        acc = [a + p for a, p in zip(acc, part)]
    return untile_planes(torch.stack(acc), th, tw, tiles_y, tiles_x)


def accumulate_lights_plain(gb_world_pos, gb_normal, gb_covered, camera_pos,
                            lights, view, proj, width: int, height: int,
                            tile_h: int = 64, tile_w: int = 128,
                            cap: int = 256, chunk: int = 16,
                            tile_depth_range=None):
    """The plain PyTorch version of accumulate_lights on any device (what
    accumulate_lights runs for CPU tensors)."""
    gbuf, tile_rec, counts, uni, bin_stats, (ty, tx) = _prepare(
        gb_world_pos, gb_normal, gb_covered, camera_pos, lights, view, proj,
        width, height, tile_h, tile_w, cap, chunk, tile_depth_range)
    out = _accumulate_plain(gbuf, tile_rec, counts, uni, tile_h, tile_w, ty,
                            tx, chunk)[:, :height, :width].permute(1, 2, 0)
    return out[..., 0:3], out[..., 3:6], bin_stats


def _accumulate_launch(lib, gbuf, tile_rec, counts, uni, width, height,
                       tile_h, tile_w, chunk, stream):
    """Launch kernel B6 through the C interface; returns (diffuse,
    specular), each (H, W, 3)."""
    ph, pw = gbuf.shape[1], gbuf.shape[2]
    counts32 = counts.to(torch.int32)
    diffuse = torch.empty((height, width, 3), dtype=torch.float32,
                          device=gbuf.device)
    specular = torch.empty_like(diffuse)
    err = lib.lsr_fplus_accumulate(
        gbuf.data_ptr(), tile_rec.data_ptr(), counts32.data_ptr(),
        uni.data_ptr(), diffuse.data_ptr(), specular.data_ptr(), width,
        height, ph, pw, tile_h, tile_w, pw // tile_w, tile_rec.shape[1],
        chunk, stream)
    check_launch("lsr_fplus_accumulate", err)
    return diffuse, specular


def accumulate_lights(gb_world_pos, gb_normal, gb_covered, camera_pos, lights,
                      view, proj, width: int, height: int, tile_h: int = 64,
                      tile_w: int = 128, cap: int = 256, chunk: int = 16,
                      tile_depth_range=None):
    """Binned local-light accumulation on the caller's screen tiles.
    Returns (diffuse (H, W, 3), specular (H, W, 3), bin_stats
    {max_count, overflow_bins}).  CPU tensors run the plain version; CUDA
    tensors launch kernel B6 or raise."""
    args = (gb_world_pos, gb_normal, gb_covered, camera_pos, lights, view,
            proj, width, height, tile_h, tile_w, cap, chunk,
            tile_depth_range)
    dev = gb_world_pos.device
    if dev.type == "cpu":
        return accumulate_lights_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"accumulate_lights: unsupported device {dev}")
    gbuf, tile_rec, counts, uni, bin_stats, _ = _prepare(*args)
    for name, t in (("gbuf", gbuf), ("tile_rec", tile_rec), ("camera", uni)):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"accumulate_lights: {name} must be contiguous "
                             f"f32 on {dev}")
    diffuse, specular = _accumulate_launch(
        load_kernels(), gbuf, tile_rec, counts, uni, width, height, tile_h,
        tile_w, chunk, torch.cuda.current_stream(dev).cuda_stream)
    accumulate_lights.launches += 1
    return diffuse, specular, bin_stats


accumulate_lights.launches = 0
