"""The hello-shaders family: eight procedural fragment shaders on one
contact sheet (port of demos/hello_shaders.py).  No mesh, no kernel: each
field is tensor ops on the device."""

from __future__ import annotations

import torch

from lsr_tpu_torch.demos.common import parser, setup_device, write_frame
from lsr_tpu_torch.shading.procedural import PROCEDURAL_SHADERS

T = 2.0


def build_scene(mesh=None, device=None):
    """No geometry: the device and the shader time."""
    return {"device": setup_device(device), "t": T}


def render(scene, width: int, height: int):
    """{"ldr": (2H, 4W, 3) u8 sheet, "fields": {name: (H, W, 3) f32}}."""
    fields = {name: fn(width, height, scene["t"], device=scene["device"])
              for name, fn in PROCEDURAL_SHADERS.items()}
    tiles = [torch.clamp(torch.floor(torch.clamp(f, 0, 1) * 255 + 0.5), 0,
                         255).to(torch.uint8) for f in fields.values()]
    sheet = torch.cat([torch.cat(tiles[i * 4:(i + 1) * 4], dim=1)
                       for i in range(2)], dim=0)
    return {"ldr": sheet, "fields": fields}


def main(argv=None):
    args = parser(__doc__, 320, 320, mesh=False).parse_args(argv)
    out = render(build_scene(device=args.device), args.width, args.height)
    for name, f in out["fields"].items():
        v = torch.floor(torch.clamp(f, 0, 1) * 255 + 0.5)
        print(f"  {name}: mean={float(v.mean()):.1f}")
    path = write_frame(args.out, "torch_hello_shaders.png", out["ldr"])
    print(f"wrote {path} {tuple(out['ldr'].shape)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
