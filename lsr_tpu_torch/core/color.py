"""Color helpers (port of lsr_tpu/core/color.py: quantize_u8, reinhard)."""

from __future__ import annotations

import torch


def quantize_u8(x01):
    """[0,1] float -> u8 with round-half-up, floor(x*255 + 0.5), matching
    std::lround + clamp (NOT torch.round, which rounds half to even)."""
    v = torch.floor(x01.to(torch.float32) * 255.0 + 0.5)
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def reinhard_tonemap(rgb, exposure: float = 1.0, gamma: float = 2.2):
    """Exposure -> Reinhard -> gamma.  Returns float in [0,1)."""
    c = torch.clamp(rgb * exposure, min=0.0)
    c = c / (1.0 + c)
    return torch.pow(c, 1.0 / gamma)
