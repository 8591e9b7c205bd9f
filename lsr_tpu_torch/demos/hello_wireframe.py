"""Config #1: a wireframe mesh, headless PNG out (port of
demos/hello_wireframe.py; parity: hello_wireframe.cpp).

The mesh's model coordinates are taken as NDC, its edges (v0, v1) and (v1,
v2) drawn in green with the Bresenham scatter (raster/wireframe.py)."""

from __future__ import annotations

from lsr_tpu_torch.demos.common import (
    lit_pixels, parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.raster.wireframe import render_wireframe


def build_scene(mesh, device=None):
    return {"mesh": mesh, "device": setup_device(device)}


def render(scene, width: int, height: int):
    """{"ldr": (H, W, 3) u8}."""
    return {"ldr": render_wireframe(scene["mesh"], width, height,
                                    device=scene["device"])}


def main(argv=None):
    args = parser(__doc__, 600, 600).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    ldr = render(scene, args.width, args.height)["ldr"]
    path = write_frame(args.out, "torch_hello_wireframe.png", ldr)
    print(f"wrote {path}  ({lit_pixels(ldr)} lit pixels)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
