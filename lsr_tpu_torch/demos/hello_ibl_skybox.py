"""IBL skybox from a file-loaded cubemap (port of demos/hello_ibl_skybox.py,
HelloIblSkybox parity).

The mesh is lit by irradiance + prefiltered-specular maps baked from the
loaded cubemap; the background is the cubemap itself; an environment probe
adds local image-based ambience near the floor.  The camera goes through
kernel B1 and the lighting through kernel B2 with env_probes.

--skybox DIR loads DIR/{right,left,top,bottom,front,back}.png.  Without it
the six faces are the port's procedural sky (procedural_sky_cubemap),
written as sRGB PNGs to a temporary directory and loaded back through
load_cubemap, so the loader stays on the path."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.demos.common import (
    covered, parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.io.obj import make_plane
from lsr_tpu_torch.io.png import save_canvas_png
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.passes.forward_plus import shade_forward_plus
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import scene_setup
from lsr_tpu_torch.raster.tiled import rasterize_direct
from lsr_tpu_torch.resources.cubemap import FACE_FILES, load_cubemap
from lsr_tpu_torch.resources.ibl import (
    compute_irradiance_map,
    compute_prefiltered_specular,
)
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.shading.common import make_materials
from lsr_tpu_torch.shading.models import make_shade_context
from lsr_tpu_torch.sky.sky_models import procedural_sky_cubemap, render_sky
from lsr_tpu_torch.utils.host import fetch

EYE = (1.2, 1.0, -3.4)
SUN = (0.4, -0.7, 0.5)
SKY_SIZE = 256


def _linear_to_srgb_u8(x: np.ndarray) -> np.ndarray:
    """Linear [0, 1] -> sRGB u8 (the inverse of load_cubemap's decode)."""
    x = np.clip(x, 0.0, 1.0)
    s = np.where(x <= 0.0031308, x * 12.92,
                 1.055 * np.power(x, 1.0 / 2.4) - 0.055)
    return np.clip(np.floor(s * 255.0 + 0.5), 0, 255).astype(np.uint8)


def write_sky_faces(out_dir: str, size: int, device=None) -> str:
    """The procedural sky's six faces as sRGB PNGs in out_dir, named as
    load_cubemap reads them (each face's row 0 is its bottom row, so it is
    saved as a bottom-left-origin canvas).  Returns out_dir."""
    faces = fetch(procedural_sky_cubemap(size, device=device))
    for name, face in zip(FACE_FILES, faces):
        save_canvas_png(os.path.join(out_dir, f"{name}.png"),
                        _linear_to_srgb_u8(face))
    return out_dir


def load_sky(skybox=None, size: int = SKY_SIZE, device=None):
    """(6, size, size, 3) linear faces: skybox's PNGs, or the procedural
    sky's at twice the size, box-downsampled on load."""
    if skybox:
        return load_cubemap(skybox, size=size)
    with tempfile.TemporaryDirectory() as tmp:
        return load_cubemap(write_sky_faces(tmp, 2 * size, device), size=size)


def build_scene(mesh, device=None, faces=None, skybox=None,
                sky_size: int = SKY_SIZE):
    """faces: (6, S, S, 3) linear cubemap (numpy or tensor); default
    load_sky(skybox, sky_size).  The IBL maps are baked here, once."""
    device = setup_device(device)
    if faces is None:
        faces = load_sky(skybox, sky_size, device)
    faces = torch.as_tensor(np.asarray(fetch(faces), np.float32),
                            device=device)
    irr = compute_irradiance_map(faces, out_size=8, samples=128)
    pref = tuple(compute_prefiltered_specular(faces, out_size=32, samples=64,
                                              mips=4))
    sb = SceneBuilder()
    sb.add(mesh, (m3.translate([0.0, 0.3, 0.0]) @ m3.rotate_y(0.5)).numpy(),
           material=0)
    sb.add(make_plane(6.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build(device)
    mats = make_materials(base_color=[(0.95, 0.93, 0.9), (0.4, 0.42, 0.45)],
                          metallic=[0.9, 0.0], roughness=[0.15, 0.6],
                          device=device)
    lb = LightSetBuilder()
    lb.env_probe((0.0, -0.5, 0.0), color=(1.0, 1.0, 1.0), intensity=1.2,
                 range=3.0)
    ctx = make_shade_context(
        mats, light_dir_ws=SUN, light_color=(1.0, 0.97, 0.9),
        light_intensity=1.4, camera_pos=EYE, ibl=(irr, pref), device=device)
    return {"geom": geom, "objects": objects, "lights": lb.build(device),
            "ctx": ctx, "faces": faces, "device": device}


def render(scene, width: int, height: int):
    """{"ldr", "hdr", "gb"}."""
    geom, objects, ctx = scene["geom"], scene["objects"], scene["ctx"]
    cam = make_camera(width, height, EYE, (0, 0.1, 0),
                      device=scene["device"])
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, cam.viewproj, width,
        height)
    depth, tid, _ = rasterize_direct(setup, width, height, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    sky = render_sky(cam.viewproj, width, height, kind="cubemap",
                     cubemap=scene["faces"])
    hdr, _ = shade_forward_plus(
        gb, ctx, scene["lights"], cam.view, cam.proj, cam.zn, cam.zf, width,
        height, tile_size=16, cap=8, sun_model="pbr_mr", env_probes=True,
        background=(0, 0, 0))
    hdr = torch.where(gb.covered[..., None], hdr, sky)
    return {"ldr": tonemap_pass(hdr), "hdr": hdr, "gb": gb}


def main(argv=None):
    p = parser(__doc__, 800, 600)
    p.add_argument("--skybox", default=None,
                   help="directory of right/left/top/bottom/front/back.png")
    args = p.parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device,
                        skybox=args.skybox)
    out = render(scene, args.width, args.height)
    path = write_frame(args.out, "torch_hello_ibl_skybox.png", out["ldr"])
    print(f"wrote {path} covered={covered(out['gb'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
