"""Near-plane clipping with static shapes (port of lsr_tpu/raster/clip.py).

Only the near plane (z_clip + w >= 0) is clipped geometrically; each input
triangle maps to two output slots with validity masks.  The case tables and
the emission order are lsr_tpu's, so fan splitting produces the same
sub-triangles in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from renderbench.reference.core.util import device_const


# Generators: 0..2 = original vertices, 3 = lerp(v0,v1), 4 = lerp(v1,v2),
# 5 = lerp(v2,v0), 6 = padding.
_PAD = 6

# _CASE_SLOTS[case] = polygon as generator ids; case = in0 + 2*in1 + 4*in2.
_CASE_SLOTS = np.array(
    [
        [_PAD, _PAD, _PAD, _PAD],  # 000: fully clipped
        [3, 5, 0, _PAD],           # 100: only v0 in
        [3, 1, 4, _PAD],           # 010: only v1 in
        [1, 4, 5, 0],              # 110: v0,v1 in
        [4, 2, 5, _PAD],           # 001: only v2 in
        [3, 4, 2, 0],              # 101: v0,v2 in
        [3, 1, 2, 5],              # 011: v1,v2 in
        [1, 2, 0, _PAD],           # 111: fully inside (rotated emission)
    ],
    np.int64,
)
_CASE_COUNT = np.array([0, 3, 3, 4, 3, 4, 4, 3], np.int64)


def clip_triangles_near(corner_attrs: dict, clip: torch.Tensor):
    """Clip triangles against the near plane with static 2x expansion.

    corner_attrs: dict of per-corner attributes (T, 3, A); 'normal' is
    re-normalized after interpolation.  clip: (T, 3, 4).
    Returns (clip2 (T, 2, 3, 4), attrs2 {k: (T, 2, 3, A)}, valid2 (T, 2)).
    Slot 0 = fan tri (p0,p1,p2), slot 1 = (p0,p2,p3).
    """
    dev = clip.device
    d = clip[..., 2] + clip[..., 3]
    inside = (d >= 0.0).to(torch.int64)
    case = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]

    def edge_t(a, b):
        den = d[:, a] - d[:, b]
        den = torch.where(torch.abs(den) > 1e-8, den, torch.ones_like(den))
        return torch.clamp(d[:, a] / den, 0.0, 1.0)

    t01, t12, t20 = edge_t(0, 1), edge_t(1, 2), edge_t(2, 0)

    def lerp(x, a, b, t):
        ta, tb = x[:, a], x[:, b]
        return ta + (tb - ta) * t[:, None]

    keys = list(corner_attrs.keys())
    widths = [corner_attrs[k].shape[-1] for k in keys]
    comb = torch.cat([clip] + [corner_attrs[k] for k in keys], dim=-1)
    gen = torch.stack([
        comb[:, 0], comb[:, 1], comb[:, 2],
        lerp(comb, 0, 1, t01), lerp(comb, 1, 2, t12), lerp(comb, 2, 0, t20),
        torch.zeros_like(comb[:, 0]),
    ], dim=1)                                           # (T, 7, C)
    slots = device_const(_CASE_SLOTS, dev, torch.int64)[case]   # (T, 4)
    counts = device_const(_CASE_COUNT, dev, torch.int64)[case]  # (T,)
    poly = torch.gather(
        gen, 1, slots[..., None].expand(-1, -1, gen.shape[-1]))  # (T, 4, C)
    fan2 = torch.cat([poly[:, :1], poly[:, 2:4]], dim=1)    # slots 0, 2, 3
    emitted = torch.stack([poly[:, 0:3], fan2], dim=1)

    clip2 = emitted[..., :4]
    attrs2 = {}
    off = 4
    for k, width in zip(keys, widths):
        out = emitted[..., off:off + width]
        off += width
        if k == "normal":
            n = torch.sqrt((out * out).sum(-1, keepdim=True))
            out = out / torch.clamp(n, min=1e-12)
        attrs2[k] = out
    valid2 = torch.stack([counts >= 3, counts >= 4], dim=1)
    return clip2, attrs2, valid2
