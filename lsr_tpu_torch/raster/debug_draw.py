"""Debug draw: 3D line / AABB overlays onto rendered frames (port of
lsr_tpu/raster/debug_draw.py; sw_render/debug_draw.hpp's line and AABB
overlays).

World-space segments are projected through the camera, near-clipped,
mapped to canvas pixels and drawn with the Bresenham scatter on top of an
LDR frame.  The clip transform sums as lsr_tpu's product does
(raster/setup.clip_transform): a matmul's own order can move an endpoint
by a pixel where terms cancel.
"""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.raster.lines import rasterize_lines
from lsr_tpu_torch.raster.setup import clip_transform


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def project_segments(p0_ws, p1_ws, viewproj, width: int, height: int,
                     near_eps: float = 1e-4):
    """World segments -> integer canvas endpoints + validity, on viewproj's
    device.

    Segments crossing the near plane are clipped to it (parametric clip on
    the w' = z+w distance, like the triangle near clip)."""
    dev = viewproj.device
    vp = viewproj.to(torch.float32)

    def hom(p):
        p = _f32(p, dev)
        return torch.cat([p, torch.ones_like(p[..., :1])], -1)

    c0 = clip_transform(hom(p0_ws), vp)
    c1 = clip_transform(hom(p1_ws), vp)
    d0 = c0[..., 2] + c0[..., 3]
    d1 = c1[..., 2] + c1[..., 3]
    both_out = (d0 < 0) & (d1 < 0)
    dd = d0 - d1
    t = torch.clamp(d0 / torch.where(dd.abs() > 1e-8, dd,
                                     torch.ones_like(dd)), 0.0, 1.0)
    cross = (d0 < 0) | (d1 < 0)
    mid = c0 + (c1 - c0) * t[..., None]
    c0 = torch.where((d0 < 0)[..., None], mid, c0)
    c1 = torch.where((d1 < 0)[..., None], mid, c1)

    def to_screen(c):
        w_ok = c[..., 3] > near_eps
        wd = torch.where(w_ok, c[..., 3], torch.ones_like(c[..., 3]))
        x = (c[..., 0] / wd * 0.5 + 0.5) * (width - 1)
        y = (c[..., 1] / wd * 0.5 + 0.5) * (height - 1)
        return torch.stack([x, y], -1), w_ok

    s0, ok0 = to_screen(c0)
    s1, ok1 = to_screen(c1)
    valid = ok0 & ok1 & ~both_out & cross | (ok0 & ok1 & ~cross)
    # Clamp into a guard window so Bresenham step counts stay bounded.
    lim = torch.tensor([width * 2.0, height * 2.0], dtype=torch.float32,
                       device=dev)
    s0 = torch.clamp(s0, -lim, lim)
    s1 = torch.clamp(s1, -lim, lim)
    return (torch.round(s0).to(torch.int32), torch.round(s1).to(torch.int32),
            valid)


def draw_segments(ldr_u8, p0_ws, p1_ws, viewproj, color=(255, 230, 40)):
    """World segments drawn over an (H, W, 3) u8 frame; returns a new
    frame."""
    h, w = ldr_u8.shape[:2]
    s0, s1, valid = project_segments(p0_ws, p1_ws, viewproj.to(ldr_u8.device),
                                     w, h)
    # Collapse invalid segments to a zero-length off-screen point.
    off = torch.tensor([-10, -10], dtype=torch.int32, device=ldr_u8.device)
    s0 = torch.where(valid[..., None], s0, off)
    s1 = torch.where(valid[..., None], s1, off)
    return rasterize_lines(ldr_u8, s0, s1, color, max_steps=3 * (w + h))


_AABB_EDGES = np.array([
    (0, 1), (1, 3), (3, 2), (2, 0),   # bottom ring (y=min)
    (4, 5), (5, 7), (7, 6), (6, 4),   # top ring
    (0, 4), (1, 5), (2, 6), (3, 7),   # verticals
], np.int64)
_CORNER_SEL = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1]
                        for i in range(8)], np.float32)


def aabb_segments(wmin, wmax, device=None):
    """(B,3)/(B,3) AABBs -> (B*12, 3) segment endpoints (p0, p1), on
    wmin's device when it is a tensor, else on `device` (default: the
    card)."""
    if device is None and isinstance(wmin, torch.Tensor):
        device = wmin.device
    device = resolve_device(device)
    wmin, wmax = _f32(wmin, device), _f32(wmax, device)
    sel = torch.as_tensor(_CORNER_SEL, device=device)
    corners = wmin[:, None, :] + (wmax - wmin)[:, None, :] * sel[None]
    e = torch.as_tensor(_AABB_EDGES, device=device)
    return (corners[:, e[:, 0]].reshape(-1, 3),
            corners[:, e[:, 1]].reshape(-1, 3))


def draw_aabbs(ldr_u8, wmin, wmax, viewproj, color=(255, 80, 80)):
    """Overlay world AABB wireframes (the culling-debug overlay)."""
    p0, p1 = aabb_segments(wmin, wmax, device=ldr_u8.device)
    return draw_segments(ldr_u8, p0, p1, viewproj, color)
