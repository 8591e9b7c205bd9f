"""Framebuffer / render-target types (port of lsr_tpu/gfx/framebuffer.py).

Analog of gfx/rt_types.hpp: the reference's RT structs (RT_ColorHDR :79,
RT_DepthBuffer :91, RT_ColorDepthVelocity :130, RT_ShadowDepth
rt_shadow.hpp:18) become tensors in a frozen dataclass threaded through
passes, replaced rather than written.  Layout is (H, W, C) row-major with
row 0 = bottom (canvas convention, conventions.md §2).
"""

from __future__ import annotations

import dataclasses

import torch

from lsr_tpu_torch.core.util import resolve_device

DEPTH_CLEAR = 1.0  # far plane in the [0,1] normalized view-z depth scheme


@dataclasses.dataclass(frozen=True)
class Framebuffer:
    """HDR color + depth + motion target (analog of RT_ColorDepthVelocity).

    color:  (H, W, 4) f32 linear HDR RGBA
    depth:  (H, W)    f32 normalized view-z in [0, 1] (1 = far/clear)
    motion: (H, W, 2) f32 screen-space motion vectors in pixels
    """

    color: torch.Tensor
    depth: torch.Tensor
    motion: torch.Tensor

    @property
    def height(self) -> int:
        return self.color.shape[0]

    @property
    def width(self) -> int:
        return self.color.shape[1]


def make_framebuffer(height: int, width: int,
                     clear_color=(0.0, 0.0, 0.0, 1.0),
                     device=None) -> Framebuffer:
    """A cleared Framebuffer on `device` (default: the card)."""
    device = resolve_device(device)
    color = torch.as_tensor(clear_color, dtype=torch.float32,
                            device=device).expand(height, width, 4)
    depth = torch.full((height, width), DEPTH_CLEAR, dtype=torch.float32,
                       device=device)
    motion = torch.zeros((height, width, 2), dtype=torch.float32,
                         device=device)
    return Framebuffer(color=color, depth=depth, motion=motion)


def clear_color(fb: Framebuffer, rgba) -> Framebuffer:
    c = torch.as_tensor(rgba, dtype=torch.float32,
                        device=fb.color.device).expand(fb.color.shape)
    return dataclasses.replace(fb, color=c)


def clear_depth(fb: Framebuffer, value: float = DEPTH_CLEAR) -> Framebuffer:
    return dataclasses.replace(fb, depth=torch.full_like(fb.depth, value))


def make_ldr(height: int, width: int, rgb=(0, 0, 0),
             device=None) -> torch.Tensor:
    """(H, W, 3) u8 LDR canvas (analog of RT_ColorLDR), bottom-left origin,
    on `device` (default: the card)."""
    return torch.as_tensor(rgb, dtype=torch.uint8,
                           device=resolve_device(device)).expand(
        height, width, 3).clone()


def make_shadow_depth(size: int, clear: float = 1.0,
                      device=None) -> torch.Tensor:
    """(S, S) f32 shadow depth map (analog of RT_ShadowDepth), cleared to
    far, on `device` (default: the card)."""
    return torch.full((size, size), clear, dtype=torch.float32,
                      device=resolve_device(device))
