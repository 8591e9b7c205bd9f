"""Tonemap pass: HDR -> LDR u8 (port of lsr_tpu/passes/tonemap.py).

Exposure guard, Reinhard, gamma, round-half-up quantization.  Within
hdr_in(dtype), the HDR input is first rounded to dtype (the benchmark's
control of a half-precision HDR target).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from renderbench.reference.core.color import quantize_u8


_HDR_DTYPE: list = []


@contextlib.contextmanager
def hdr_in(dtype):
    """Within the block, tonemap_pass rounds its input to dtype first."""
    _HDR_DTYPE.append(dtype)
    try:
        yield
    finally:
        _HDR_DTYPE.pop()


def tonemap_pass(hdr_rgb, exposure: float = 1.0, gamma: float = 2.2):
    """(H, W, 3|4) f32 linear HDR -> (H, W, 3) u8 LDR."""
    # The guards and 1/gamma are evaluated in float32, as lsr_tpu does.
    exposure = float(np.maximum(np.float32(exposure), np.float32(0.0001)))
    inv_gamma = float(np.float32(1.0)
                      / np.maximum(np.float32(gamma), np.float32(0.001)))
    if _HDR_DTYPE:
        hdr_rgb = hdr_rgb.to(_HDR_DTYPE[-1]).to(hdr_rgb.dtype)
    c = torch.clamp(hdr_rgb[..., :3] * exposure, min=0.0)
    c = c / (1.0 + c)
    return quantize_u8(torch.pow(c, inv_gamma))
