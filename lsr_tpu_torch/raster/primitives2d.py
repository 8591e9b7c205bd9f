"""2D canvas primitives (port of lsr_tpu/raster/primitives2d.py; the
hello-pixel-primitives demo family).

Pixel fills, outlined / filled triangles, polygonal circles, image blits
and alpha blending, Canvas helper analogs (shs_renderer.hpp:684-1100:
fill_pixel :794, draw_circle_poly :826, draw_triangle :840, barycentric
fill :860-905, alpha_blend :1037, image_blit :1060), as masked
full-canvas ops and scatters on the canvas's device.  Every function
returns a new canvas.
"""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.raster.lines import rasterize_lines


def _grid(canvas):
    """(xs (1, W), ys (H, 1)) int64 pixel coordinates of a canvas."""
    hh, ww = canvas.shape[:2]
    dev = canvas.device
    return (torch.arange(ww, device=dev)[None, :],
            torch.arange(hh, device=dev)[:, None])


def _u8(color, canvas):
    return torch.as_tensor(color, dtype=torch.uint8, device=canvas.device)


def fill_rect(canvas_u8, x, y, w, h, color):
    """Canvas::fill_pixel analog: masked rectangle fill."""
    xs, ys = _grid(canvas_u8)
    mask = (xs >= x) & (xs < x + w) & (ys >= y) & (ys < y + h)
    return torch.where(mask[..., None], _u8(color, canvas_u8), canvas_u8)


def draw_circle_poly(canvas_u8, cx, cy, radius, segments, color):
    """Canvas::draw_circle_poly: circle as line segments (table built on
    the host in float64, as lsr_tpu builds it)."""
    th1 = 2.0 * np.pi * np.arange(segments) / segments
    th2 = 2.0 * np.pi * (np.arange(segments) + 1) / segments
    p0 = np.stack([cx + (radius * np.cos(th1)).astype(np.int32),
                   cy + (radius * np.sin(th1)).astype(np.int32)], -1)
    p1 = np.stack([cx + (radius * np.cos(th2)).astype(np.int32),
                   cy + (radius * np.sin(th2)).astype(np.int32)], -1)
    return rasterize_lines(canvas_u8, p0.astype(np.int32),
                           p1.astype(np.int32), color)


def draw_triangle_outline(canvas_u8, verts, color):
    """Canvas::draw_triangle: three Bresenham edges.  verts: (3, 2) int."""
    v = np.asarray(verts, np.int32)
    return rasterize_lines(canvas_u8, v[[0, 1, 2]], v[[1, 2, 0]], color)


def fill_triangle_2d(canvas_u8, verts, color):
    """Barycentric-coverage filled 2D triangle (draw_triangle_flat_shading's
    coverage rule: all barycentrics >= 0, shs_renderer.hpp:894-900)."""
    hh, ww = canvas_u8.shape[:2]
    dev = canvas_u8.device
    v = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
    xs = torch.arange(ww, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(hh, dtype=torch.float32, device=dev)[:, None]

    ax, ay = v[0, 0], v[0, 1]
    v0x, v0y = v[1, 0] - ax, v[1, 1] - ay
    v1x, v1y = v[2, 0] - ax, v[2, 1] - ay
    v2x, v2y = xs - ax, ys - ay
    d00 = v0x * v0x + v0y * v0y
    d01 = v0x * v1x + v0y * v1y
    d11 = v1x * v1x + v1y * v1y
    d20 = v2x * v0x + v2y * v0y
    d21 = v2x * v1x + v2y * v1y
    den = d00 * d11 - d01 * d01
    ok = den.abs() >= 1e-5
    den = torch.where(ok, den, torch.ones_like(den))
    bv = (d11 * d20 - d01 * d21) / den
    bw = (d00 * d21 - d01 * d20) / den
    bu = 1.0 - bv - bw
    mask = ok & (bu >= 0) & (bv >= 0) & (bw >= 0)
    return torch.where(mask[..., None], _u8(color, canvas_u8), canvas_u8)


def alpha_blend(dst_u8, src_u8, alpha):
    """shs::alpha_blend: dst*(1-a) + src*a per pixel; alpha scalar or (H,W).
    Rounds half to even (torch.round, as jnp.round)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dst_u8.device)
    if a.ndim == 2:
        a = a[..., None]
    out = dst_u8.float() * (1.0 - a) + src_u8.float() * a
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def image_blit(canvas_u8, img_u8, x, y):
    """shs::image_blit: paste img at (x, y) with bounds clipping (the
    source index clamped into the image, pixels outside it masked)."""
    ih, iw = img_u8.shape[:2]
    xs, ys = _grid(canvas_u8)
    in_rect = (xs >= x) & (xs < x + iw) & (ys >= y) & (ys < y + ih)
    sx = torch.clamp(xs - x, 0, iw - 1)
    sy = torch.clamp(ys - y, 0, ih - 1)
    src = torch.as_tensor(img_u8, device=canvas_u8.device)[sy, sx]
    return torch.where(in_rect[..., None], src, canvas_u8)
