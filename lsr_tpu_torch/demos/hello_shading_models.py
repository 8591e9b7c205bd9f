"""Shading-model contact sheet (port of demos/hello_shading_models.py).

The mesh under every shading model of the hello-3d-primitives pipeline
family (flat, Gouraud, Phong, Blinn-Phong, toon, Gooch, Oren-Nayar) and the
normal / depth debug views, one render_forward (kernel B1) per panel, as a
3x3 sheet."""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.demos.common import (
    batch_of, parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.render import render_forward, simple_camera
from lsr_tpu_torch.scene.scene import concat_scene, geometry_from_numpy
from lsr_tpu_torch.shading.common import make_materials
from lsr_tpu_torch.shading.models import make_shade_context

EYE = (0.35, 0.25, -2.6)
MODELS = (
    "flat", "gouraud", "phong",
    "blinn_phong", "toon", "gooch",
    "oren_nayar", "debug_normal", "debug_depth",
)


def build_scene(mesh, device=None):
    device = setup_device(device)
    geom = geometry_from_numpy(concat_scene([mesh]), device)
    rot = m3.rotate_y(0.4, device)
    mats = make_materials(base_color=[(0.8, 0.55, 0.35)], metallic=[0.05],
                          roughness=[0.45], device=device)
    ctx = make_shade_context(
        mats, light_dir_ws=(0.45, -0.7, 0.55), light_color=(1.0, 0.97, 0.92),
        light_intensity=2.6, camera_pos=EYE, device=device)
    return {"batch": batch_of(geom), "models": rot[None],
            "nmats": m3.normal_matrix(rot)[None], "ctx": ctx,
            "device": device}


def render(scene, width: int, height: int):
    """Each panel width x height.  {"ldr": (3H, 3W, 3) u8 sheet, "panels":
    [u8 panel per model], "gb": the GBuffer}."""
    vp, zn, zf = simple_camera(width, height, EYE, (0, 0, 0),
                               device=scene["device"])
    panels = []
    for name in MODELS:
        ldr, gb = render_forward(
            scene["batch"], scene["models"], scene["nmats"], vp, zn, zf,
            scene["ctx"], width, height, model_name=name,
            background=(0.05, 0.06, 0.09))
        panels.append(ldr)
    rows = [torch.cat(panels[r * 3:(r + 1) * 3], dim=1) for r in range(3)]
    return {"ldr": torch.cat(rows, dim=0), "panels": panels, "gb": gb}


def main(argv=None):
    args = parser(__doc__, 256, 256).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    out = render(scene, args.width, args.height)
    path = write_frame(args.out, "torch_hello_shading_models.png",
                       out["ldr"])
    panels = [np.asarray(p.cpu()) for p in out["panels"]]
    dupes = sum(bool((panels[i] == panels[j]).all())
                for i in range(9) for j in range(i + 1, 9))
    print(f"wrote {path} (duplicate panels: {dupes})")
    if dupes:
        raise SystemExit("distinct shading models produced identical panels")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
