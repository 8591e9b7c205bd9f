"""Screen-space ambient occlusion from depth (port of
lsr_tpu/passes/ssao.py): a fixed spiral of taps compared against the
pixel's depth, a 3x3 box smooth.  Returns (H, W) AO in [0, 1] (1 =
unoccluded; uncovered pixels 1).
"""

from __future__ import annotations

import numpy as np
import torch

from renderbench.reference.passes.post import _shift_clamped


def _spiral_offsets(samples: int, radius_px: float):
    """(samples, 2) float32 golden-angle spiral of tap offsets in pixels."""
    a = np.arange(samples, dtype=np.float32)
    ang = a * 2.399963  # golden angle
    r = radius_px * np.sqrt((a + 0.5) / samples)
    return np.stack([np.cos(ang) * r, np.sin(ang) * r], -1).astype(np.float32)


def tap_offsets(samples: int = 12, radius_px: float = 8.0):
    """The taps' integer (dx, dy) pixel offsets: Python's round (half to
    even) of the float32 spiral, on the host, as lsr_tpu."""
    offsets = _spiral_offsets(samples, radius_px)
    return [(int(round(float(x))), int(round(float(y)))) for x, y in offsets]


def ssao_pass(gb, zn, zf, samples: int = 12, radius_px: float = 8.0,
              strength: float = 1.0, depth_bias: float = 0.002,
              depth_range: float = 0.02):
    """SSAO of a G-buffer (its depth01 and coverage)."""
    return ssao_depth_pass(gb.depth01, gb.covered, zn, zf, samples=samples,
                           radius_px=radius_px, strength=strength,
                           depth_bias=depth_bias, depth_range=depth_range)


def ssao_depth_pass(depth, covered, zn, zf, samples: int = 12,
                    radius_px: float = 8.0, strength: float = 1.0,
                    depth_bias: float = 0.002, depth_range: float = 0.02):
    """Depth-only AO, so that it runs straight off a depth prepass.  A tap
    occludes when it is nearer than depth - depth_bias and within
    depth_range of it; every pixel takes the same taps, each an
    edge-clamped shift of the depth buffer."""
    h, w = depth.shape
    occ = torch.zeros((h, w), dtype=torch.float32, device=depth.device)
    for ox, oy in tap_offsets(samples, radius_px):
        sd = _shift_clamped(_shift_clamped(depth, oy, 0), ox, 1)
        nearer = sd < depth - depth_bias
        in_range = (depth - sd) < depth_range
        occ = occ + (nearer & in_range).to(torch.float32)
    ao = 1.0 - strength * occ / samples
    acc = torch.zeros_like(ao)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + torch.roll(torch.roll(ao, dy, dims=0), dx, dims=1)
    ao = acc / 9.0
    return torch.where(covered, torch.clamp(ao, 0.0, 1.0),
                       torch.ones_like(ao))
