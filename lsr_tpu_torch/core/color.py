"""Color helpers (port of lsr_tpu/core/color.py).

The reference decodes sRGB with a gamma-2.2 power (builtin_shaders.hpp:
25-31) and tonemaps with Reinhard + gamma and lround quantization
(pass_tonemap.hpp:55-80).
"""

from __future__ import annotations

import torch


def _f32(c):
    return torch.as_tensor(c).to(torch.float32)


def srgb_u8_to_linear(c_u8):
    """u8 sRGB -> linear float via pow(c / 255, 2.2)."""
    return torch.pow(_f32(c_u8) / 255.0, 2.2)


def srgb_to_linear(c):
    """[0, 1] sRGB float -> linear float (gamma 2.2)."""
    return torch.pow(torch.clamp(_f32(c), min=0.0), 2.2)


def linear_to_srgb(c, gamma: float = 2.2):
    return torch.pow(torch.clamp(_f32(c), min=0.0), 1.0 / gamma)


def quantize_u8(x01):
    """[0,1] float -> u8 with round-half-up, floor(x*255 + 0.5), matching
    std::lround + clamp (NOT torch.round, which rounds half to even)."""
    v = torch.floor(x01.to(torch.float32) * 255.0 + 0.5)
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def u8_to_f01(c_u8):
    return _f32(c_u8) / 255.0


def reinhard_tonemap(rgb, exposure: float = 1.0, gamma: float = 2.2):
    """Exposure -> Reinhard -> gamma.  Returns float in [0,1)."""
    c = torch.clamp(rgb * exposure, min=0.0)
    c = c / (1.0 + c)
    return torch.pow(c, 1.0 / gamma)


def luma_bt601(rgb):
    """Perceptual luma used by FXAA and the light-shaft prepass."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
