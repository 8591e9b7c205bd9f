"""Config #2: Blinn-Phong mesh: filled triangles, z-buffer, texture (port
of demos/hello_blinn_phong.py).

render_forward on one frame: setup -> kernel B1 -> G-buffer -> Blinn-Phong
-> tonemap, the floor checkered."""

from __future__ import annotations

import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.demos.common import (
    batch_of, covered, parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.io.obj import make_plane
from lsr_tpu_torch.render import render_forward, simple_camera
from lsr_tpu_torch.scene.scene import concat_scene, geometry_from_numpy
from lsr_tpu_torch.shading.common import checkerboard_texture, make_materials
from lsr_tpu_torch.shading.models import make_shade_context

EYE = (0.8, 0.9, -3.2)


def build_scene(mesh, device=None):
    device = setup_device(device)
    floor = make_plane(4.0, y=-1.2)
    geom = geometry_from_numpy(concat_scene([mesh, floor]), device)
    rot = m3.rotate_y(0.5, device)
    models = torch.stack([rot, torch.eye(4, device=device)])
    nmats = torch.stack([m3.normal_matrix(rot), torch.eye(3, device=device)])
    mats = make_materials(
        base_color=[(0.85, 0.55, 0.35), (0.6, 0.62, 0.65)],
        metallic=[0.05, 0.0], roughness=[0.4, 0.8], tex_id=[-1, 0],
        device=device)
    ctx = make_shade_context(
        mats, light_dir_ws=(0.45, -0.7, 0.55), light_color=(1.0, 0.97, 0.92),
        light_intensity=2.8, camera_pos=EYE,
        textures=torch.as_tensor(checkerboard_texture(128),
                                 device=device)[None],
        device=device)
    return {"batch": batch_of(geom), "models": models, "nmats": nmats,
            "ctx": ctx, "device": device}


def render(scene, width: int, height: int):
    """{"ldr": (H, W, 3) u8, "gb": GBuffer}."""
    vp, zn, zf = simple_camera(width, height, EYE, (0, -0.2, 0),
                               device=scene["device"])
    ldr, gb = render_forward(
        scene["batch"], scene["models"], scene["nmats"], vp, zn, zf,
        scene["ctx"], width, height, model_name="blinn_phong",
        background=(0.04, 0.06, 0.1))
    return {"ldr": ldr, "gb": gb}


def main(argv=None):
    args = parser(__doc__, 800, 600).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    out = render(scene, args.width, args.height)
    path = write_frame(args.out, "torch_hello_blinn_phong.png", out["ldr"])
    print(f"wrote {path} covered={covered(out['gb'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
