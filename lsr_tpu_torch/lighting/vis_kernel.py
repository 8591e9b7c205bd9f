"""Kernels V1 and V2: the local-shadow visibility planes on their crop
windows (port of lsr_tpu's crop cascade, lsr_tpu/lighting/
local_shadows.py:674-730, _cropped_plane, nested lax.cond; not a
pallas_call).

lsr_tpu evaluates each plane on the smallest window of its crop cascade
that holds the light's footprint this frame, and skips the plane when the
footprint is empty or the light was culled, branching on the device.  Here
the branch is data:
- V1 (vis_windows, csrc/vis_footprint.cu) folds each light's footprint on
  the vis_scale-strided grid into its bounds and picks the window (K, 4)
  i32 (y0c, x0c, ch, cw) and the run flag (K,) bool;
- V2 (vis_planes, csrc/vis_planes.cu) reads them from device memory and
  evaluates each plane inside its window, 1.0 elsewhere, (K + 1, H', W').
No host read comes between them, so one captured frame serves every
camera.  The plain versions, vis_windows_plain and vis_planes_plain, live
in lighting/local_shadows.py; CPU tensors run them, CUDA tensors launch
the kernels or raise.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _windows_launch(lib, sh, world_pos, stream):
    """Launch kernel V1 through the C interface (a memset of its scratch,
    the footprint launch when sh has a crop cascade, the level launch);
    returns (win, run) on world_pos's device.  sh has K >= 1 planes."""
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
    bounds = torch.empty((k, 4), dtype=torch.int32, device=dev)
    win = torch.empty((k, 4), dtype=torch.int32, device=dev)
    run = torch.empty((k,), dtype=torch.bool, device=dev)
    err = lib.lsr_vis_windows(
        world_pos.data_ptr(), sy, sx, s3, h, w, max(1, int(sh.vis_scale)),
        _info(sh, dev).data_ptr(), _ptr(spot_vp), cpos.data_ptr(),
        crange.data_ptr(), _ptr(en), lv.data_ptr(), len(levels),
        int(bool(ls.crop_sizes(sh.vis_crop))), bounds.data_ptr(),
        win.data_ptr(), run.data_ptr(), k, stream)
    check_launch("lsr_vis_windows", err)
    return win, run


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


def _planes_launch(lib, sh, world_pos, normal, win, run, stream):
    """Launch kernel V2 through the C interface; returns the (K + 1, H',
    W') planes on world_pos's device."""
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
    h, w = ls.vis_grid_shape(sh, world_pos)
    out = torch.empty((k + 1, h, w), dtype=torch.float32, device=dev)
    tables = [_checked(n, getattr(sh, n), dev) for n in (
        "spot_viewproj", "point_viewproj", "caster_pos", "caster_range",
        "strength")]
    taps = [_checked(n, getattr(sh, n), dev, torch.int32)
            for n in ("spot_taps", "point_taps")]
    err = lib.lsr_vis_planes(
        world_pos.data_ptr(), wsy, wsx, ws3, normal.data_ptr(), nsy, nsx,
        ns3, h, w, max(1, int(sh.vis_scale)),
        _info(sh, dev).data_ptr() if k else 0,
        *(_ptr(t) for t in tables), *(_ptr(t) for t in taps),
        int(sh.spot_size), int(sh.point_size), _ptr(win), _ptr(run),
        _uniforms(sh, dev).data_ptr(), out.data_ptr(), k,
        int(sh.filter_mode == "esm"), int(sh.pcf_radius), stream)
    check_launch("lsr_vis_planes", err)
    return out


def vis_planes(sh: ls.LocalShadowMaps, world_pos, normal, win, run):
    """(K + 1, H', W') f32 visibility planes on sh's strided grid, each
    evaluated inside its window where its run flag is set, 1.0 elsewhere;
    plane K is 1.0 (ls.vis_planes_plain).  CPU tensors run the plain
    version; CUDA tensors launch kernel V2 or raise."""
    if world_pos.device.type == "cpu":
        return ls.vis_planes_plain(sh, world_pos, normal, win, run)
    dev = _card("vis_planes", world_pos)
    out = _planes_launch(load_kernels(), sh, world_pos, normal, win, run,
                         torch.cuda.current_stream(dev).cuda_stream)
    vis_planes.launches += 1
    return out


vis_planes.launches = 0
