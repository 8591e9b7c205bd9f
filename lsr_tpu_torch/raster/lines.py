"""Vectorized Bresenham line rasterization (port of lsr_tpu/raster/lines.py:
line_points, rasterize_lines, rasterize_lines_f32).

The reference's all-octant Bresenham loop (shs_renderer.hpp:808-822) in
its closed form: with n = max(|dx|, |dy|) steps, the pixel at step t is

    x(t) = x0 + sx * floor((2 t |dx| + n) / (2 n))
    y(t) = y0 + sy * floor((2 t |dy| + n) / (2 n))

a data-parallel map over (line, step), in int32 as lsr_tpu computes it.

The draw is a scatter.  Where two steps hit one pixel, lsr_tpu's
`.at[y, x].set` leaves the later one in flattened (line, step) order;
`index_put_` with repeated indices has no defined winner (on the card it
varies from run to run), so the port picks the winner itself, the largest
flattened index per pixel (scatter_reduce "amax"), and writes each pixel
once.  Coordinates outside [0, W) x [0, H), negative ones included, are
dropped, as lsr_tpu's mode="drop" drops them.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import resolve_device


def _i32(p, device):
    """An (L, 2) endpoint array as int32 on `device`; float coordinates are
    truncated toward zero, as jnp.asarray(p, jnp.int32) does."""
    if isinstance(p, torch.Tensor):
        return p.to(device=device).to(torch.int32)
    return torch.as_tensor(p, device=device).to(torch.int32)


def line_points(p0, p1, max_steps: int, device=None):
    """Expand integer line segments into per-step pixel coordinates.

    p0, p1: (L, 2) endpoints (x, y); float ones are truncated to int32.
    Returns (x, y, valid), each (L, max_steps), on p0's device when it is a
    tensor, else on `device` (default: the card); steps beyond a line's
    length are marked invalid.  max_steps must be >= max(|dx|, |dy|) + 1.
    """
    if device is None and isinstance(p0, torch.Tensor):
        device = p0.device
    device = resolve_device(device)
    p0, p1 = _i32(p0, device), _i32(p1, device)
    d = p1 - p0
    adx, ady = d[:, 0].abs(), d[:, 1].abs()
    one = torch.ones_like(adx)
    sx = torch.where(d[:, 0] >= 0, one, -one)
    sy = torch.where(d[:, 1] >= 0, one, -one)
    n = torch.maximum(adx, ady)
    n_safe = torch.clamp(n, min=1)[:, None]

    t = torch.arange(max_steps, dtype=torch.int32, device=device)[None, :]
    xa = torch.div(2 * t * adx[:, None] + n_safe, 2 * n_safe,
                   rounding_mode="floor")
    ya = torch.div(2 * t * ady[:, None] + n_safe, 2 * n_safe,
                   rounding_mode="floor")
    x = p0[:, 0:1] + sx[:, None] * xa
    y = p0[:, 1:2] + sy[:, None] * ya
    valid = t <= n[:, None]
    return x, y, valid


def _scatter_last(buf, x, y, valid, vals):
    """buf (H, W, C) with vals (L * S, C) written at (y, x), the largest
    flattened (line, step) index winning a pixel hit more than once; steps
    not valid or outside the buffer dropped."""
    h, w = buf.shape[0], buf.shape[1]
    keep = (valid & (x >= 0) & (y >= 0) & (x < w) & (y < h)).reshape(-1)
    pix = (y.to(torch.int64) * w + x.to(torch.int64)).reshape(-1)[keep]
    k = torch.arange(keep.numel(), device=buf.device)[keep]
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=buf.device)
    winner.scatter_reduce_(0, pix, k, reduce="amax")
    hit = torch.nonzero(winner >= 0).squeeze(1)
    out = buf.clone()
    out.view(h * w, -1)[hit] = vals[winner[hit]]
    return out


def rasterize_lines(canvas_u8, p0, p1, color, max_steps: int | None = None):
    """Draw integer line segments onto a (H, W, 3) u8 canvas (bottom-left
    origin), on the canvas's device; returns a new canvas.

    color: (3,) or (L, 3) u8.  Out-of-bounds pixels are dropped (the
    reference's draw_pixel bounds check, shs_renderer.hpp:713-716).
    """
    h, w = canvas_u8.shape[0], canvas_u8.shape[1]
    if max_steps is None:
        max_steps = w + h
    x, y, valid = line_points(p0, p1, max_steps, device=canvas_u8.device)
    color = torch.as_tensor(color, dtype=torch.uint8,
                            device=canvas_u8.device)
    if color.ndim == 1:
        color = color.expand(x.shape[0], 3)
    colors = color[:, None, :].expand(x.shape + (3,)).reshape(-1, 3)
    return _scatter_last(canvas_u8, x, y, valid, colors)


def rasterize_lines_f32(buf, p0, p1, value, max_steps: int | None = None):
    """Same as rasterize_lines but for float (H, W, C) buffers (debug
    overlays); value: (C,) or (L, C) in buf's dtype."""
    h, w = buf.shape[0], buf.shape[1]
    if max_steps is None:
        max_steps = w + h
    x, y, valid = line_points(p0, p1, max_steps, device=buf.device)
    value = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
    c = value.shape[-1]
    if value.ndim == 1:
        value = value.expand(x.shape[0], c)
    vals = value[:, None, :].expand(x.shape + (c,)).reshape(-1, c)
    return _scatter_last(buf, x, y, valid, vals)
