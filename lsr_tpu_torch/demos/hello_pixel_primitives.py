"""2D pixel-primitive contact sheet: the hello-pixel-primitives family
(port of demos/hello_pixel_primitives.py).

One panel per reference executable (cpp-folders/src/hello-pixel-primitives/
CMakeLists.txt): HelloPixel (pixel grid), HelloLine (line star,
shs_renderer.hpp:808 Bresenham semantics), HelloTriangle (outline +
filled), HelloCirclePoly (segmented circle), HelloTexture (image blit +
alpha blend over the canvas), through raster/primitives2d.py and
raster/lines.py, presented as one PNG."""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.demos.common import (
    lit_pixels, parser, setup_device, write_frame)
from lsr_tpu_torch.raster.lines import rasterize_lines
from lsr_tpu_torch.raster.primitives2d import (
    alpha_blend,
    draw_circle_poly,
    draw_triangle_outline,
    fill_rect,
    fill_triangle_2d,
    image_blit,
)
from lsr_tpu_torch.shading.common import checkerboard_texture

PANEL = 200
MIN_LIT = 5000       # lsr_tpu's check that the sheet is not empty


def _blank(device):
    return torch.zeros((PANEL, PANEL, 3), dtype=torch.uint8, device=device)


def panel_pixels(device):
    """HelloPixel: a dot grid lit one pixel at a time."""
    c = _blank(device)
    ys, xs = np.mgrid[10:PANEL:16, 10:PANEL:16]
    for y, x in zip(ys.ravel().tolist(), xs.ravel().tolist()):
        c = fill_rect(c, x, y, 2, 2, (90 + (x * 79) % 166, 200, 120))
    return c


def panel_lines(device):
    """HelloLine: a star of lines from the panel center.  The float32
    endpoints are truncated to int32 by rasterize_lines, as in lsr_tpu."""
    n = 24
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    cx = cy = PANEL // 2
    p0 = np.tile([[cx, cy]], (n, 1)).astype(np.float32)
    p1 = np.stack([cx + 92 * np.cos(ang), cy + 92 * np.sin(ang)], -1)
    return rasterize_lines(_blank(device), p0, p1.astype(np.float32),
                           (240, 210, 90))


def panel_triangles(device):
    """HelloTriangle: outline + filled triangle."""
    c = draw_triangle_outline(
        _blank(device), ((20.0, 30.0), (95.0, 170.0), (170.0, 60.0)),
        (90, 170, 250))
    return fill_triangle_2d(
        c, ((60.0, 40.0), (180.0, 120.0), (110.0, 185.0)), (250, 120, 90))


def panel_circle(device):
    """HelloCirclePoly: segmented circles of decreasing tessellation."""
    c = _blank(device)
    for r, seg, col in ((80, 48, (120, 220, 250)), (52, 12, (250, 220, 120)),
                        (26, 5, (220, 120, 250))):
        c = draw_circle_poly(c, PANEL // 2, PANEL // 2, r, seg, col)
    return c


def panel_texture(device):
    """HelloTexture: checkerboard blit + translucent overlay blend."""
    tex = torch.as_tensor(
        (checkerboard_texture(96)[..., :3] * 255).astype(np.uint8),
        device=device)
    c = image_blit(_blank(device), tex, 16, 16)
    c = image_blit(c, tex, 88, 88)
    overlay = fill_rect(_blank(device), 40, 70, 120, 60, (255, 60, 30))
    return alpha_blend(c, overlay, 0.45)


PANELS = (panel_pixels, panel_lines, panel_triangles, panel_circle,
          panel_texture)


def build_scene(device=None):
    return {"device": setup_device(device)}


def render(scene):
    """{"ldr": (2 * PANEL, 3 * PANEL, 3) u8 sheet, "panels": [5 panels]};
    the sheet's first row of panels is at the canvas's bottom rows."""
    dev = scene["device"]
    panels = [p(dev) for p in PANELS]
    row0 = torch.cat(panels[:3], dim=1)
    row1 = torch.cat(panels[3:] + [_blank(dev)], dim=1)
    return {"ldr": torch.cat([row0, row1], dim=0), "panels": panels}


def main(argv=None):
    args = parser(__doc__, None, None, mesh=False).parse_args(argv)
    ldr = render(build_scene(args.device))["ldr"]
    path = write_frame(args.out, "torch_hello_pixel_primitives.png", ldr)
    lit = lit_pixels(ldr)
    print(f"wrote {path} (lit px: {lit})")
    if lit <= MIN_LIT:
        raise RuntimeError(f"contact sheet unexpectedly empty: {lit} lit "
                           f"px, not more than {MIN_LIT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
