"""Post-process passes (port of lsr_tpu/passes/post.py): motion vectors
and motion blur, light shafts, separable gaussian blur, bloom, fog,
outlines, depth of field, FXAA, TAA and lens flare.

Each is a fullscreen tensor transform.  lsr_tpu's row gathers become
indexing of a flattened image; its edge-clamped shifts stay pad-and-slice
(_shift_clamped), its jnp.roll neighbourhoods stay torch.roll (they wrap).
Float images stay float (the HDR chain); uint8 images keep lsr_tpu's
round-and-clip LDR semantics.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from renderbench.reference.core.color import quantize_u8
from renderbench.reference.core.util import device_const


def _take(img, rows):
    """img (H, W, C...) flattened to rows, gathered at rows (...)."""
    h, w = img.shape[:2]
    flat = img.reshape((h * w,) + tuple(img.shape[2:]))
    return flat[rows]


def _length(v):
    return torch.sqrt((v * v).sum(-1))


# ---------------------------------------------------------------------------
# Motion vectors + motion blur
# ---------------------------------------------------------------------------


def motion_vectors_pass(gb, objects, viewproj, prev_viewproj, width, height,
                        max_vel: float = 96.0):
    """(H, W, 2) screen-space velocity in pixels of each covered pixel: its
    world position taken back through its object's prev_model @
    inverse(model) and projected by both view-projections, clamped to
    max_vel pixels; 0 elsewhere.  The per-object matrices are inverted in
    float32 (an object whose 3x3 is singular keeps the identity)."""
    dev = viewproj.device
    o = objects.model.shape[0]
    det = torch.linalg.det(objects.model[:, :3, :3])
    safe = (torch.abs(det) > 1e-10)[:, None, None]
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(o, 4, 4)
    # inv_ex: no error check, so no wait for the card.
    inv_model = torch.linalg.inv_ex(torch.where(safe, objects.model, eye))[0]
    c2p_obj = torch.where(safe, objects.prev_model @ inv_model, eye)
    obj = torch.clamp(gb.obj_id, 0, o - 1)
    c2p = c2p_obj[obj]                                    # (H, W, 4, 4)

    wp = gb.world_pos
    hom = torch.cat([wp, torch.ones_like(wp[..., :1])], -1)
    prev_world = torch.einsum("hwij,hwj->hwi", c2p, hom)
    curr_clip = hom @ viewproj.T
    prev_clip = prev_world @ prev_viewproj.T
    wc = curr_clip[..., 3:4]
    wp_ = prev_clip[..., 3:4]
    ok = (torch.abs(wc) > 1e-8) & (torch.abs(wp_) > 1e-8)
    one = torch.ones_like(wc)
    curr_ndc = curr_clip[..., :2] / torch.where(ok, wc, one)
    prev_ndc = prev_clip[..., :2] / torch.where(ok, wp_, one)
    vel = (curr_ndc - prev_ndc) * 0.5 * device_const([width, height], dev)
    ln = _length(vel)[..., None]
    scale = torch.where(ln > max_vel, max_vel / torch.clamp(ln, min=1e-6),
                        torch.ones_like(ln))
    vel = vel * scale
    return torch.where(ok & gb.covered[..., None], vel,
                       torch.zeros_like(vel))


def motion_blur_pass(img, depth01, velocity, dt, samples: int = 10,
                     strength: float = 1.0, max_velocity_px: float = 20.0,
                     min_velocity_px: float = 0.25,
                     depth_reject: float = 0.08):
    """Velocity line blur: `samples` taps along the pixel's velocity (scaled
    by strength and the frame time, clamped to max_velocity_px), rounded to
    pixels, each kept when its depth is within depth_reject; the mean of
    the kept taps, or the pixel itself when none is kept or the velocity is
    below min_velocity_px.  dt is the frame time in seconds (a float)."""
    h, w = depth01.shape
    dev = depth01.device
    is_u8 = img.dtype == torch.uint8
    src = img.to(torch.float32)
    dt_scale = np.clip(np.maximum(np.float32(dt), np.float32(1e-4))
                       * np.float32(60.0), np.float32(0.5), np.float32(2.5))
    v = velocity * float(np.float32(strength) * dt_scale)
    ln = _length(v)
    over = (ln > max_velocity_px) & (ln > 1e-6)
    v = torch.where(over[..., None],
                    v * (max_velocity_px
                         / torch.clamp(ln, min=1e-6))[..., None], v)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    # Color and depth of a texel in one row: one gather per tap.
    packed = torch.cat([src, depth01[..., None]], -1).reshape(h * w, 4)
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for i in range(samples):
        t = i / (samples - 1) - 0.5
        sx = torch.clamp(torch.round(xs + v[..., 0] * t), 0, w - 1)
        sy = torch.clamp(torch.round(ys + v[..., 1] * t), 0, h - 1)
        row = packed[(sy * w + sx).to(torch.int64)]
        take = torch.abs(row[..., 3] - depth01) <= depth_reject
        acc = acc + torch.where(take[..., None], row[..., :3],
                                torch.zeros_like(row[..., :3]))
        cnt = cnt + take.to(torch.float32)
    ok = (cnt >= 1.0) & (ln >= min_velocity_px)
    avg = acc / torch.clamp(cnt, min=1.0)[..., None]
    out = torch.where(ok[..., None], avg, src)
    if is_u8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# Light shafts
# ---------------------------------------------------------------------------


def light_shafts_pass(img, depth01, camera_pos, sun_dir_ws, viewproj,
                      steps: int = 48, density: float = 0.8,
                      weight: float = 0.9, decay: float = 0.95,
                      log_march: bool = True):
    """Radial god rays toward the sun's screen position, where it is on
    screen: the depth-scaled luma marched toward the sun with decaying
    weights, added as a warm boost.

    log_march=True (the default, as in lsr_tpu) is lsr_tpu's zoom-compose
    march: ceil(log2(steps)) passes, each adding a decayed, sun-zoomed copy
    of its own accumulation (2^k effective taps at geometric spacing
    toward the sun), rescaled to the linear march's weight sum.
    log_march=False is the linear march of `steps` taps."""
    h, w = depth01.shape
    dev = depth01.device
    is_u8 = img.dtype == torch.uint8
    src = img.to(torch.float32)
    scale = 255.0 if is_u8 else 1.0

    sun_pos = camera_pos + (-sun_dir_ws) * 100.0
    clip = torch.cat([sun_pos, torch.ones(1, dtype=torch.float32,
                                          device=dev)]) @ viewproj.T
    wc = clip[3]
    ndc = clip[:3] / torch.where(torch.abs(wc) > 1e-6, wc,
                                 torch.ones_like(wc))
    sun_u = ndc[0] * 0.5 + 0.5
    sun_v = ndc[1] * 0.5 + 0.5
    sun_valid = ((torch.abs(wc) > 1e-6) & (wc > 0.0)
                 & (ndc[2] >= -1.0) & (ndc[2] <= 1.0)
                 & (sun_u >= 0.0) & (sun_u <= 1.0)
                 & (sun_v >= 0.0) & (sun_v <= 1.0))

    luma = (0.2126 * src[..., 0] + 0.7152 * src[..., 1]
            + 0.0722 * src[..., 2]) / scale
    # Far pixels keep shafts: luma scaled by depth (near kills them).
    luma = luma * torch.clamp(depth01, 0.0, 1.0)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :] / max(1, w - 1)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None] / max(1, h - 1)

    def rows(t):
        su = u + (sun_u - u) * t
        sv = v + (sun_v - v) * t
        sx = torch.clamp(torch.round(su * (w - 1)), 0, w - 1)
        sy = torch.clamp(torch.round(sv * (h - 1)), 0, h - 1)
        return (sy * w + sx).to(torch.int64)

    if log_march:
        k_passes = max(1, math.ceil(math.log2(max(steps, 2))))
        n = 2 ** k_passes
        # The schedule's scalars in float32, as lsr_tpu computes them.
        f32 = np.float32
        dens = np.minimum(f32(density), f32(0.99))
        decay_f = f32(decay)
        one_m = np.power(f32(1.0) - dens, f32(1.0 / max(n - 1, 1)))
        accum = luma * weight
        for k in range(k_passes):
            tk = float(f32(1.0) - np.power(one_m, f32(2 ** k)))
            wk = float(np.power(decay_f, f32(2 ** k)))
            accum = accum + wk * accum.reshape(-1)[rows(tk)]
        safe_d = f32(0.999999) if abs(decay_f - f32(1.0)) < 1e-6 else decay_f
        lin_sum = (f32(1.0) - np.power(safe_d, f32(steps))) / (f32(1.0) - safe_d)
        log_sum = (f32(1.0) - np.power(safe_d, f32(n))) / (f32(1.0) - safe_d)
        accum = accum * float(f32(lin_sum / log_sum))
    else:
        # density, weight and decay are float32 values in lsr_tpu's jitted
        # pass, and so is the schedule computed from them.
        f32 = np.float32
        accum = torch.zeros((h, w), dtype=torch.float32, device=dev)
        illum = f32(1.0)
        flat = luma.reshape(-1)
        for i in range(steps):
            accum = accum + flat[rows(float(f32(i / steps) * f32(density)))] \
                * float(illum * f32(weight))
            illum = illum * f32(decay)

    if is_u8:
        boost = torch.clamp(torch.round(accum * 80.0), 0, 120)
        out = torch.stack([src[..., 0] + boost, src[..., 1] + boost,
                           src[..., 2] + torch.floor(boost / 2)], -1)
        out = torch.clamp(out, 0, 255).to(torch.uint8)
        return torch.where(sun_valid, out, img)
    boost = torch.clamp(accum * 80.0, 0.0, 120.0) / 255.0
    out = torch.stack([src[..., 0] + boost, src[..., 1] + boost,
                       src[..., 2] + boost * 0.5], -1)
    return torch.where(sun_valid, out, src)


# ---------------------------------------------------------------------------
# Blur / bloom / fog / outline / DoF / FXAA / TAA / lens flare
# ---------------------------------------------------------------------------


def _gaussian_kernel1d(radius: int, sigma: float | None = None, device=None):
    """(2 radius + 1,) normalized gaussian weights (sigma radius / 2 by
    default)."""
    if sigma is None:
        sigma = max(radius * 0.5, 1e-3)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def _shift_clamped(x, off: int, axis: int):
    """x shifted by off along axis with edge clamping (out[i] = x[clamp(i +
    off)]): a slice and the repeated edge, pure data movement."""
    if off == 0:
        return x
    n = x.shape[axis]
    if off > 0:
        body = x.narrow(axis, off, n - off)
        edge = x.narrow(axis, n - 1, 1)
        return torch.cat([body] + [edge] * off, dim=axis)
    body = x.narrow(axis, 0, n + off)
    edge = x.narrow(axis, 0, 1)
    return torch.cat([edge] * (-off) + [body], dim=axis)


def gaussian_blur(img, radius: int = 2, sigma: float | None = None):
    """Separable edge-clamped gaussian blur, rows then columns; float
    (H, W, C) in and out."""
    k = _gaussian_kernel1d(radius, sigma, img.device)
    img_f = img.to(torch.float32)

    def blur_axis(x, axis):
        out = torch.zeros_like(x)
        for j, off in enumerate(range(-radius, radius + 1)):
            out = out + k[j] * _shift_clamped(x, off, axis)
        return out

    return blur_axis(blur_axis(img_f, 0), 1)


def bloom_pass(hdr, threshold: float = 1.0, intensity: float = 0.5,
               blur_radius: int = 4, passes: int = 2):
    """Bright pass (luma above threshold), `passes` gaussian blurs, added
    back at intensity."""
    luma = 0.2126 * hdr[..., 0] + 0.7152 * hdr[..., 1] + 0.0722 * hdr[..., 2]
    bright = torch.where((luma > threshold)[..., None], hdr,
                         torch.zeros_like(hdr))
    blurred = bright
    for _ in range(passes):
        blurred = gaussian_blur(blurred, radius=blur_radius)
    return hdr + blurred * intensity


def fog_pass(hdr, depth01, fog_color=(0.55, 0.6, 0.68),
             fog_density: float = 1.6):
    """Exponential depth fog toward fog_color."""
    f = 1.0 - torch.exp(-fog_density * torch.clamp(depth01, 0.0, 1.0))
    fc = device_const(fog_color, hdr.device)
    return hdr + (fc - hdr) * f[..., None]


def outline_pass(hdr, depth01, threshold: float = 0.003,
                 color=(0.0, 0.0, 0.0)):
    """`color` where the depth jumps by more than threshold to the left or
    upper neighbour (wrapping at the borders, as jnp.roll)."""
    d = depth01
    dx = torch.abs(d - torch.roll(d, 1, dims=1))
    dy = torch.abs(d - torch.roll(d, 1, dims=0))
    edge = (torch.maximum(dx, dy) > threshold)[..., None]
    return torch.where(edge, device_const(color, hdr.device), hdr)


def _median_midpoint(x):
    """jnp.median of all of x: the mean of the two middle values of an even
    count ((lo + hi) * 0.5, its "midpoint" rule), NaN if any is NaN."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(s).any(), torch.full_like(mid, math.nan),
                       mid)


def depth_of_field_pass(hdr, depth01, focus_depth: float = -1.0,
                        focus_range: float = 0.08, blur_radius: int = 4,
                        center_frac: float = 0.125):
    """Blend toward a gaussian blur by the circle of confusion |depth -
    focus| / focus_range; focus_depth < 0 focuses on the median depth of
    the central center_frac window."""
    h, w = depth01.shape
    ch = max(2, int(h * center_frac))
    cw = max(2, int(w * center_frac))
    y0 = (h - ch) // 2
    x0 = (w - cw) // 2
    if focus_depth >= 0.0:
        focus = focus_depth
    else:
        focus = _median_midpoint(depth01[y0:y0 + ch, x0:x0 + cw])
    coc = torch.clamp(torch.abs(depth01 - focus) / max(focus_range, 1e-4),
                      0.0, 1.0)
    blurred = gaussian_blur(hdr, radius=blur_radius)
    return hdr + (blurred - hdr) * coc[..., None]


def fxaa_pass(ldr_u8, contrast_threshold: float = 0.0312,
              relative_threshold: float = 0.125):
    """Luma-based FXAA on the (H, W, 3) u8 LDR image (wrap-around borders,
    like lsr_tpu's jnp.roll formulation)."""
    src = ldr_u8.to(torch.float32) / 255.0
    luma = 0.299 * src[..., 0] + 0.587 * src[..., 1] + 0.114 * src[..., 2]

    def sh(dx, dy):
        return torch.roll(torch.roll(luma, dy, dims=0), dx, dims=1)

    n, s, e, w_ = sh(0, -1), sh(0, 1), sh(1, 0), sh(-1, 0)
    lmax = torch.maximum(torch.maximum(torch.maximum(n, s),
                                       torch.maximum(e, w_)), luma)
    lmin = torch.minimum(torch.minimum(torch.minimum(n, s),
                                       torch.minimum(e, w_)), luma)
    contrast = lmax - lmin
    thresh = torch.clamp(relative_threshold * lmax, min=contrast_threshold)
    active = contrast >= thresh

    ne, nw, se, sw = sh(1, -1), sh(-1, -1), sh(1, 1), sh(-1, 1)
    blend_l = (2.0 * (n + s + e + w_) + ne + nw + se + sw) / 12.0
    f = torch.clamp(torch.abs(blend_l - luma)
                    / torch.clamp(contrast, min=1e-5), 0.0, 1.0)
    f = f * f * (3.0 - 2.0 * f)

    horiz = (torch.abs(n + s - 2 * luma) * 2.0
             + torch.abs(ne + se - 2 * e) + torch.abs(nw + sw - 2 * w_)) >= \
        (torch.abs(e + w_ - 2 * luma) * 2.0
         + torch.abs(ne + nw - 2 * n) + torch.abs(se + sw - 2 * s))
    pos_l = torch.where(horiz, n, e)
    neg_l = torch.where(horiz, s, w_)
    step_pos = torch.abs(pos_l - luma) >= torch.abs(neg_l - luma)
    neighbor = torch.where(
        (step_pos & horiz)[..., None], torch.roll(src, -1, dims=0),
        torch.where((~step_pos & horiz)[..., None], torch.roll(src, 1, dims=0),
                    torch.where((step_pos & ~horiz)[..., None],
                                torch.roll(src, 1, dims=1),
                                torch.roll(src, -1, dims=1))))
    out = src + (neighbor - src) * (f * active)[..., None]
    return quantize_u8(out)


def taa_pass(hdr, history, velocity, blend: float = 0.1,
             clamp_neighborhood: bool = True):
    """Temporal AA: history reprojected by velocity (rounded to pixels),
    clamped to the 3x3 neighbourhood's range (wrapping, as jnp.roll), and
    blended toward the frame.  Returns (resolved, new_history)."""
    h, w = hdr.shape[:2]
    dev = hdr.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    px = torch.clamp(torch.round(xs - velocity[..., 0]), 0, w - 1)
    py = torch.clamp(torch.round(ys - velocity[..., 1]), 0, h - 1)
    hist = history.reshape(h * w, -1)[(py * w + px).to(torch.int64)]
    if clamp_neighborhood:
        cmin = hdr
        cmax = hdr
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nb = torch.roll(torch.roll(hdr, dy, dims=0), dx, dims=1)
                cmin = torch.minimum(cmin, nb)
                cmax = torch.maximum(cmax, nb)
        hist = torch.minimum(torch.maximum(hist, cmin), cmax)
    resolved = hist + (hdr - hist) * blend
    return resolved, resolved


def lens_flare_pass(hdr, threshold: float = 2.0, intensity: float = 0.35,
                    ghosts: int = 4, halo_radius: float = 0.45):
    """Pseudo lens flare: the blurred bright pass sampled at
    center-mirrored, scaled positions (ghosts) and on a ring around the
    center (halo), added to the frame."""
    h, w = hdr.shape[:2]
    dev = hdr.device
    luma = 0.2126 * hdr[..., 0] + 0.7152 * hdr[..., 1] + 0.0722 * hdr[..., 2]
    bright = torch.where((luma > threshold)[..., None], hdr,
                         torch.zeros_like(hdr))
    bright = gaussian_blur(bright, radius=3)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    out = torch.zeros_like(hdr)
    for g in range(ghosts):
        s = -0.4 - 0.35 * g
        gy = torch.clamp(torch.round(cy + (ys - cy) * s), 0, h - 1)
        gx = torch.clamp(torch.round(cx + (xs - cx) * s), 0, w - 1)
        weight = intensity / (g + 1.0)
        tint = device_const([1.0 - 0.15 * g, 0.8, 0.7 + 0.1 * g], dev)
        out = out + _take(bright, (gy * w + gx).to(torch.int64)) \
            * weight * tint
    r = torch.sqrt(((ys - cy) / h) ** 2 + ((xs - cx) / w) ** 2)
    halo_w = torch.exp(-((r - halo_radius) ** 2) / 0.001)[..., None]
    iy = ys.to(torch.int64)
    ix = xs.to(torch.int64)
    halo_src = _take(bright, ((h - 1) - iy) * w + (w - 1) - ix)
    out = out + halo_src * halo_w * (intensity * 0.5)
    return hdr + out
