"""Post-process passes (port of lsr_tpu/passes/post.py:fxaa_pass)."""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.color import quantize_u8


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
