"""Directional shadow-map sampling (port of lsr_tpu/lighting/shadow_sample.py:
ShadowContext, make_shadow_context, count_lit, prefilter_esm, fetch_soft,
esm_visibility, shadow_visibility_dir).

Semantics of the reference sampler (shadow_sample.hpp:30-108): project the
world position by the light's view-projection, NDC [-1, 1] -> uv and z in
[0, 1]; outside the map or with a degenerate w the pixel is lit; a slope-
scaled bias from N.L; then one of three filters, all on the nearest texel
centre with clamped fetches:

- hard (radius 0): one f32 depth test;
- PCF, (2r+1)^2 box of depth tests.  With a unit step the taps are compared
  in 16-bit quanta, lsr_tpu's TAPS_U16 semantics: q16(z_test) <=
  q16(depth[texel]), q16(z) = clip(round(z * 65535), 0, 65535).  lsr_tpu
  assembles per-anchor tap windows for the TPU's gathers; window assembly is
  pure data movement, so fetching the clamped texel of the q16 plane gives
  the same counts.  With pcf_step > 1 the taps are strided f32 tests;
- ESM: the box filter is baked into a prefiltered "soft" map (prefilter_esm),
  stored as its q16 plane, and sampled with one fetch:
  clip(exp(c * (soft - z_test)), 0, 1).

lsr_tpu packs two q16 texels per u32 to halve its gather tables; here the
q16 values stay an (S, S) int32 plane and one texel is fetched per tap.
count_lit and fetch_soft still read lsr_tpu's packed form (a u32 word of
two q16 values, low half first), as a uint32 or int64 tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Q16 = 65535.0


@dataclasses.dataclass(frozen=True)
class ShadowContext:
    depth: torch.Tensor            # (S, S) f32 shadow map depth in [0, 1]
    light_viewproj: torch.Tensor   # (4, 4)
    bias_const: float = 0.0008     # host floats holding f32 values
    bias_slope: float = 0.0015
    strength: float = 1.0
    pcf_radius: int = 2            # 0 = hard
    pcf_step: int = 1              # texel step
    taps_q16: torch.Tensor | None = None  # (S, S) int32: pcf, q16(depth);
                                          # esm, q16(prefiltered soft map)
    filter_mode: str = "pcf"       # "pcf" | "esm"
    esm_c: float = 80.0            # ESM sharpness exponent


def _f32(x) -> float:
    return float(np.float32(x))


def quantize_q16(z):
    """f32 [0, 1] depth -> int32 [0, 65535], round half to even."""
    return torch.clamp(torch.round(z * Q16), 0.0, Q16).to(torch.int32)


def _halves(packed):
    """The low and high q16 halves of packed u16 pairs, as int64."""
    w = packed.to(torch.int64)
    return w & 0xFFFF, w >> 16


def count_lit(window, z_test, mask):
    """Masked count of window taps passing the depth test.

    window: gathered tap rows, (..., L) f32, or (..., L/2) packed q16 pairs
    (uint32 / int64), compared in q16 quanta; z_test (...) f32 biased test
    depth; mask (..., L) f32 lane mask (broadcastable).  Returns (...)
    f32 counts."""
    if window.dtype != torch.float32:
        q = quantize_q16(z_test)[..., None].to(torch.int64)
        lo, hi = _halves(window)
        return (((q <= lo).to(torch.float32) * mask[..., 0::2]).sum(-1)
                + ((q <= hi).to(torch.float32) * mask[..., 1::2]).sum(-1))
    return ((z_test[..., None] <= window).to(torch.float32) * mask).sum(-1)


def fetch_soft(packed, idx):
    """f32 [0, 1] soft depths of flat row-major texel ids idx (any shape,
    local to packed's map) from a packed soft map (T/2,) of q16 pairs (even
    texel in the low half)."""
    from lsr_tpu_torch.core.gather import take_rows

    idx = idx.to(torch.int64)
    lo, hi = _halves(take_rows(packed.to(torch.int64), idx >> 1))
    q = torch.where((idx & 1) == 0, lo, hi).to(torch.float32)
    return q * _f32(1.0 / Q16)


def prefilter_esm(depth, radius: int, c: float = 80.0):
    """ESM soft occluder map: ln(mean of exp(c * z) over the clamped
    (2r+1)^2 window) / c, computed as exp((z - 1) * c) so every operand stays
    in [e^-c, 1].  Two separable passes of (2r+1) shifted adds over the
    edge-padded map, in lsr_tpu's order.  Returns (S, S) f32 in [0, 1]; a
    stack of maps (..., S, S) is filtered map by map."""
    if radius <= 0:
        return depth
    k = 2 * radius + 1
    h, w = depth.shape[-2:]
    e = torch.exp((depth - 1.0) * c)
    p = torch.nn.functional.pad(e.reshape(-1, 1, h, w), (radius,) * 4,
                                mode="replicate").reshape(
        depth.shape[:-2] + (h + 2 * radius, w + 2 * radius))
    rows = sum(p[..., i:i + h, :] for i in range(k))
    both = sum(rows[..., :, i:i + w] for i in range(k))
    mean = both * _f32(1.0 / (k * k))
    return torch.log(mean) * _f32(1.0 / c) + 1.0


def esm_visibility(soft_z, z_test, c: float):
    """clamp(exp(c * (soft_z - z_test)), 0, 1)."""
    return torch.clamp(torch.exp((soft_z - z_test) * _f32(c)), 0.0, 1.0)


def make_shadow_context(depth, light_viewproj, bias_const: float = 0.0008,
                        bias_slope: float = 0.0015, strength: float = 1.0,
                        pcf_radius: int = 2, pcf_step: int = 1,
                        filter_mode: str = "pcf",
                        esm_c: float = 80.0) -> ShadowContext:
    """The sampling context of a rendered map.  ESM prefilters and
    quantizes the soft map; unit-step PCF quantizes the depth map."""
    if filter_mode not in ("pcf", "esm"):
        raise ValueError(f"make_shadow_context: unknown filter "
                         f"{filter_mode!r}")
    taps = None
    if filter_mode == "esm" and pcf_radius > 0:
        if depth.numel() % 2:
            raise ValueError("make_shadow_context: the ESM soft map needs an "
                             "even texel count (lsr_tpu packs texel pairs)")
        taps = quantize_q16(prefilter_esm(depth, pcf_radius, esm_c))
    elif filter_mode == "esm":
        filter_mode = "pcf"   # radius 0 is a single hard tap either way
    elif pcf_radius > 0 and pcf_step == 1:
        taps = quantize_q16(depth)
    return ShadowContext(
        depth=depth, light_viewproj=light_viewproj.to(torch.float32),
        bias_const=_f32(bias_const), bias_slope=_f32(bias_slope),
        strength=_f32(strength), pcf_radius=int(pcf_radius),
        pcf_step=int(pcf_step), taps_q16=taps,
        filter_mode=filter_mode, esm_c=float(esm_c))


def shadow_visibility_dir(shadow: ShadowContext, world_pos, ndotl):
    """Visibility in [0, 1] per pixel; world_pos (H, W, 3), ndotl (H, W)."""
    sm = shadow.depth
    sh, sw = sm.shape
    m = shadow.light_viewproj
    px, py, pz = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]

    def mrow(r):
        return m[r, 0] * px + m[r, 1] * py + m[r, 2] * pz + m[r, 3]

    w = mrow(3)
    w_ok = torch.abs(w) >= 1e-8
    w_safe = torch.where(w_ok, w, torch.ones_like(w))
    u = (mrow(0) / w_safe) * 0.5 + 0.5
    v = (mrow(1) / w_safe) * 0.5 + 0.5
    z = (mrow(2) / w_safe) * 0.5 + 0.5
    in_map = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & w_ok

    slope = 1.0 - torch.clamp(ndotl, 0.0, 1.0)
    z_test = z - (shadow.bias_const + shadow.bias_slope * slope)

    # Nearest texel centre.  Pixels off the map are lit whatever they
    # fetch; they fetch texel 0 so no NaN or huge value is cast to int.
    zero = torch.zeros_like(u)
    cx = torch.round(torch.where(in_map, u * (sw - 1), zero)).to(torch.int64)
    cy = torch.round(torch.where(in_map, v * (sh - 1), zero)).to(torch.int64)
    r = max(0, shadow.pcf_radius)
    step = max(1, shadow.pcf_step)

    def fetch(plane, ox, oy):
        x = torch.clamp(cx + ox, 0, sw - 1)
        y = torch.clamp(cy + oy, 0, sh - 1)
        return plane.reshape(-1)[y * sw + x]

    if r == 0:
        vis = (z_test <= fetch(sm, 0, 0)).to(torch.float32)
    elif shadow.filter_mode == "esm" and shadow.taps_q16 is not None:
        soft = fetch(shadow.taps_q16, 0, 0).to(torch.float32) \
            * _f32(1.0 / Q16)
        vis = esm_visibility(soft, z_test, shadow.esm_c)
    elif shadow.taps_q16 is not None and step == 1:
        q = quantize_q16(z_test)
        lit = torch.zeros_like(z_test)
        for oy in range(-r, r + 1):
            for ox in range(-r, r + 1):
                lit = lit + (q <= fetch(shadow.taps_q16, ox, oy)).to(
                    torch.float32)
        vis = lit / float((2 * r + 1) ** 2)
    else:
        lit = torch.zeros_like(z_test)
        for oy in range(-r, r + 1):
            for ox in range(-r, r + 1):
                lit = lit + (z_test <= fetch(sm, ox * step, oy * step)).to(
                    torch.float32)
        vis = lit / float((2 * r + 1) ** 2)

    vis = torch.where(in_map, vis, torch.ones_like(vis))
    return 1.0 + (vis - 1.0) * min(max(shadow.strength, 0.0), 1.0)
