"""Kernels V1 and V2: the local-shadow visibility planes on their crop
windows (port of lsr_tpu's crop cascade, lsr_tpu/lighting/
local_shadows.py:674-730, _cropped_plane, nested lax.cond, and of its
upsample, :966-971; not a pallas_call).

lsr_tpu evaluates each plane on the smallest window of its crop cascade
that holds the light's footprint this frame, and skips the plane when the
footprint is empty or the light was culled, branching on the device.  Here
the branch is data:
- V1 (vis_windows, csrc/vis_footprint.cu) folds each light's footprint on
  the vis_scale-strided grid into its bounds and picks the window (K, 4)
  i32 (y0c, x0c, ch, cw) and the run flag (K,) bool, in one launch over
  all planes;
- V2 (vis_planes, csrc/vis_planes.cu) reads them from device memory,
  evaluates each plane inside its window (1.0 elsewhere) and writes the
  full-resolution planes (K + 1, H, W), upsampled at vis_scale > 1 with
  core/image._taps' taps and weights as resize_bilinear does.
No host read comes between them, so one captured frame serves every
camera.  The plain versions, vis_windows_plain and vis_planes_full_plain,
live in lighting/local_shadows.py; CPU tensors run them, CUDA tensors
launch the kernels or raise.  V2's tiles and halos (upsample_layout) are
fixed on the host from the frame's sizes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lsr_tpu_torch.core.image import _taps
from lsr_tpu_torch.core.util import device_const
from lsr_tpu_torch.lighting import local_shadows as ls
from lsr_tpu_torch.lighting.shadow_sample import Q16
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels


def _checked(name, t, dev, dtype=torch.float32):
    """t contiguous on dev, or a ValueError (None passes as a null)."""
    if t is None:
        return None
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} "
                         f"on {t.device}")
    return t.contiguous()


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _aligned16(t):
    """t, or a copy of it where its data is not 16-byte aligned (V2 reads
    each row of a view-projection as one 16-byte vector)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _strides(name, t, dev):
    """The element strides of an (H, W, 3) f32 image on dev, which the
    kernels read in place."""
    if (t.device != dev or t.dtype != torch.float32 or t.dim() != 3
            or t.shape[-1] != 3):
        raise ValueError(f"{name} must be (H, W, 3) float32 on {dev}")
    return t.stride()


def _card(fn_name, world_pos):
    dev = world_pos.device
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    return dev


def _info(sh, dev):
    """(K, 2) i32: each shadowed light's kind and base slot."""
    return device_const([[int(k), int(b)] for k, b in zip(sh.kinds,
                                                          sh.base_slots)],
                        dev, torch.int32)


# V1's persistent grid: blocks an SM.  At V1's 40 registers 6 blocks of
# 256 threads are resident on an SM, so 8 launch 1.33 waves; the smaller
# runs of warp rows even out the blocks' uneven work (the spot test stops
# early off the light).  At flagship (d) 8 took 0.0540 ms, one wave of 6
# 0.0624 and 4 0.0642 (patched copies of the source, timed on an NVIDIA
# H100 80GB HBM3 at 700 W).
V1_BLOCKS_PER_SM = 8


def _windows_launch(lib, sh, world_pos, stream):
    """Launch kernel V1 through the C interface (with a crop cascade, a
    memset of its scratch and the persistent footprint launch, whose last
    block picks the levels; without one, one block); returns (win, run) on
    world_pos's device.  sh has K >= 1 planes."""
    dev = world_pos.device
    k = sh.n_shadowed
    sy, sx, s3 = _strides("vis_windows: world_pos", world_pos, dev)
    h, w = ls.vis_grid_shape(sh, world_pos)
    levels = ls.vis_levels(sh, h, w)
    lv = device_const(list(levels) or [(0, 0)], dev, torch.int32)
    spot_vp = _checked("spot_viewproj", sh.spot_viewproj, dev)
    cpos = _checked("caster_pos", sh.caster_pos, dev)
    crange = _checked("caster_range", sh.caster_range, dev)
    en = _checked("caster_enabled", sh.caster_enabled, dev, torch.bool)
    bounds = torch.empty((4 * k + 1,), dtype=torch.int32, device=dev)
    win = torch.empty((k, 4), dtype=torch.int32, device=dev)
    run = torch.empty((k,), dtype=torch.bool, device=dev)
    err = lib.lsr_vis_windows(
        world_pos.data_ptr(), sy, sx, s3, h, w, max(1, int(sh.vis_scale)),
        _info(sh, dev).data_ptr(), _ptr(spot_vp), cpos.data_ptr(),
        crange.data_ptr(), _ptr(en), lv.data_ptr(), len(levels),
        int(bool(ls.crop_sizes(sh.vis_crop))), bounds.data_ptr(),
        win.data_ptr(), run.data_ptr(), k,
        V1_BLOCKS_PER_SM * _sm_count(dev), stream)
    check_launch("lsr_vis_windows", err)
    return win, run


@functools.cache
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def vis_windows(sh: ls.LocalShadowMaps, world_pos):
    """The crop window (K, 4) i32 (y0c, x0c, ch, cw) and run flag (K,)
    bool of each visibility plane on sh's strided grid
    (ls.vis_windows_plain).  CPU tensors run the plain version; CUDA
    tensors launch kernel V1 or raise."""
    if world_pos.device.type == "cpu":
        return ls.vis_windows_plain(sh, world_pos)
    dev = _card("vis_windows", world_pos)
    if sh.n_shadowed == 0:
        return (torch.zeros((0, 4), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    out = _windows_launch(load_kernels(), sh, world_pos,
                          torch.cuda.current_stream(dev).cuda_stream)
    vis_windows.launches += 1
    return out


vis_windows.launches = 0


def _uniforms(sh, dev):
    """V2's f32 uniforms: bias_const, bias_slope, esm_c, near, far_min,
    1 / 65535 and the PCF box's 1 / (2r + 1)^2 (the reciprocal PyTorch's
    CUDA division by a scalar multiplies by)."""
    f = np.float32
    box = (2 * int(sh.pcf_radius) + 1) ** 2
    return device_const(np.array(
        [sh.bias_const, sh.bias_slope, sh.esm_c, ls._SHADOW_NEAR,
         ls._FAR_MIN, 1.0 / Q16, f(1.0) / f(box)], f), dev)


# V2's output tile at vis_scale > 1: 128 columns (32 lanes x 4) and the
# most rows of V2_TILE_ROWS whose halos of K planes fit V2_SMEM bytes (at
# flagship (a) 8 rows took 0.0669 ms and 16 took 0.0703, patched copies
# of the source timed on an NVIDIA H100 80GB HBM3 at 700 W).
V2_TILE_W = 128
V2_TILE_ROWS = (8, 4, 2, 1)
V2_SMEM = 48 * 1024


@functools.cache
def axis_halo(m: int, n: int, tile: int) -> int:
    """The most strided samples the taps (core/image._taps) of `tile`
    consecutive outputs of an axis of m samples written as n reach (tiles
    from output 0 on, the last one cut at n): from the first output's i0
    to the last one's i1, as V2 stages them.  An axis that keeps its size
    (n == m: a frame one pixel high or wide) has weights (1, 0), which
    give each sample itself."""
    i0, i1, _, _ = _taps(m, n, torch.device("cpu"))
    i0, i1 = i0.tolist(), i1.tolist()
    return max(i1[min(t + tile, n) - 1] - i0[t] + 1
               for t in range(0, n, tile))


@functools.cache
def upsample_layout(k: int, hs: int, ws: int, h: int, w: int):
    """(tile_h, halo_h, halo_w, shared bytes) of V2's upsampling launch for
    K planes evaluated on an (hs, ws) grid and written at (h, w): the most
    rows of V2_TILE_ROWS whose halo of K planes and K windows fits
    V2_SMEM."""
    halo_w = axis_halo(ws, w, V2_TILE_W)
    for tile_h in V2_TILE_ROWS:
        halo_h = axis_halo(hs, h, tile_h)
        smem = 4 * k * (4 + halo_h * halo_w)
        if smem <= V2_SMEM:
            return tile_h, halo_h, halo_w, smem
    raise ValueError(f"vis_planes: {k} planes' halos do not fit {V2_SMEM} "
                     f"bytes of shared memory")


def _planes_launch(lib, sh, world_pos, normal, win, run, stream):
    """Launch kernel V2 through the C interface; returns the (K + 1, H, W)
    full-resolution planes on world_pos's device."""
    dev = world_pos.device
    k = sh.n_shadowed
    wsy, wsx, ws3 = _strides("vis_planes: world_pos", world_pos, dev)
    nsy, nsx, ns3 = _strides("vis_planes: normal", normal, dev)
    if normal.shape != world_pos.shape:
        raise ValueError("vis_planes: normal and world_pos differ in shape")
    win = _checked("vis_planes: win", win, dev, torch.int32)
    run = _checked("vis_planes: run", run, dev, torch.bool)
    if win.shape != (k, 4) or run.shape != (k,):
        raise ValueError(f"vis_planes: win {tuple(win.shape)} and run "
                         f"{tuple(run.shape)} must be ({k}, 4) and ({k},)")
    hs, ws = ls.vis_grid_shape(sh, world_pos)
    h, w = world_pos.shape[:2]
    sc = max(1, int(sh.vis_scale))
    out = torch.empty((k + 1, h, w), dtype=torch.float32, device=dev)
    tables = [_aligned16(_checked(n, getattr(sh, n), dev)) for n in (
        "spot_viewproj", "point_viewproj", "caster_pos", "caster_range",
        "strength")]
    dtypes = {t.dtype for t in (sh.spot_taps, sh.point_taps)
              if t is not None}
    texel = dtypes.pop() if len(dtypes) == 1 else torch.int32
    if texel == torch.float32 and sh.filter_mode == "esm":
        raise ValueError("vis_planes: ESM's soft tables are q16 (int32)")
    taps = [_checked(n, getattr(sh, n), dev, texel)
            for n in ("spot_taps", "point_taps")]
    up, layout = [None] * 8, (0, 0, 0)
    if sc > 1:
        up = [*_taps(hs, h, dev), *_taps(ws, w, dev)]
        layout = upsample_layout(k, hs, ws, h, w)[:3]
    err = lib.lsr_vis_planes(
        world_pos.data_ptr(), wsy, wsx, ws3, normal.data_ptr(), nsy, nsx,
        ns3, h, w, sc, _info(sh, dev).data_ptr() if k else 0,
        *(_ptr(t) for t in tables), *(_ptr(t) for t in taps),
        int(sh.spot_size), int(sh.point_size), int(texel == torch.float32),
        _ptr(win), _ptr(run), _uniforms(sh, dev).data_ptr(), out.data_ptr(),
        k, int(sh.filter_mode == "esm"), int(sh.pcf_radius),
        *(_ptr(t) for t in up), *layout, stream)
    check_launch("lsr_vis_planes", err)
    return out


def vis_planes(sh: ls.LocalShadowMaps, world_pos, normal, win, run):
    """(K + 1, H, W) f32 visibility planes at world_pos's resolution: each
    evaluated on sh's strided grid inside its window where its run flag is
    set, 1.0 elsewhere, plane K 1.0, then upsampled bilinearly at
    vis_scale > 1 (ls.vis_planes_full_plain).  CPU tensors run the plain
    version; CUDA tensors launch kernel V2 or raise."""
    if world_pos.device.type == "cpu":
        return ls.vis_planes_full_plain(sh, world_pos, normal, win, run)
    dev = _card("vis_planes", world_pos)
    out = _planes_launch(load_kernels(), sh, world_pos, normal, win, run,
                         torch.cuda.current_stream(dev).cuda_stream)
    vis_planes.launches += 1
    return out


vis_planes.launches = 0
