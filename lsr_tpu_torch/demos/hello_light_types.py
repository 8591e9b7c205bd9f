"""All six reference light types lighting one scene, with tiled culling
(port of demos/hello_light_types.py).

The sun is the directional light; one point, spot, rect-area and
tube-area light and an environment probe are binned per tile and lit in
kernel B2 (tiled, cap 8).  The camera goes through kernel B1, or
rasterize_brute with use_tiled=False; main renders both and compares the
LDR frames, as lsr_tpu's demo compares its two backends."""

from __future__ import annotations

import hashlib

import numpy as np

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.demos.common import (
    parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.io.obj import make_plane
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.passes.forward_plus import shade_forward_plus
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.raster.brute import rasterize_brute
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import scene_setup
from lsr_tpu_torch.raster.tiled import rasterize_direct
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.shading.common import make_materials
from lsr_tpu_torch.shading.models import make_shade_context
from lsr_tpu_torch.utils.host import fetch_image

EYE = (0.2, 1.5, -5.2)


def build_scene(mesh, device=None):
    device = setup_device(device)
    sb = SceneBuilder()
    for i, x in enumerate((-2.4, -0.8, 0.8, 2.4)):
        sb.add(mesh, (m3.translate([x, 0.0, 0.6])
                      @ m3.rotate_y(np.pi + 0.25 * i)).numpy(),
               material=i % 2)
    sb.add(make_plane(9.0, y=-1.0), material=2, casts_shadow=False)
    geom, objects = sb.build(device)
    mats = make_materials(
        base_color=[(0.8, 0.55, 0.35), (0.55, 0.6, 0.8), (0.45, 0.47, 0.5)],
        metallic=[0.05, 0.3, 0.0], roughness=[0.45, 0.3, 0.85],
        device=device)
    lb = LightSetBuilder()
    # One of each local type, spread across the meshes.
    lb.point((-2.4, 1.4, -1.0), color=(0.2, 0.9, 0.3), intensity=5.0,
             range=4.0)
    lb.spot((-0.8, 2.4, -1.4), (0.0, -0.85, 0.55), color=(0.95, 0.3, 0.2),
            intensity=5.0, range=5.0, inner_angle=0.25, outer_angle=0.5)
    lb.rect_area((0.8, 1.6, -1.2), (0.0, -0.6, 0.8),
                 half_extents=(0.8, 0.45), color=(0.3, 0.5, 1.0),
                 intensity=5.0, range=4.5)
    lb.tube_area((2.4, 1.1, -1.2), axis=(1.0, 0.0, 0.2), half_length=0.9,
                 radius=0.08, color=(1.0, 0.8, 0.25), intensity=4.5,
                 range=3.2)
    lb.env_probe((0.0, 0.6, 0.6), color=(0.9, 0.6, 1.0), intensity=1.6,
                 range=2.2)
    ctx = make_shade_context(
        mats, light_dir_ws=(0.25, -0.7, 0.65),   # the directional light
        light_color=(1.0, 0.97, 0.9), light_intensity=1.6, camera_pos=EYE,
        device=device)
    return {"geom": geom, "objects": objects, "lights": lb.build(device),
            "ctx": ctx, "device": device}


def render(scene, width: int, height: int, use_tiled: bool = True):
    """{"ldr", "hdr", "gb", "stats"} (stats: shade_forward_plus's)."""
    geom, objects, ctx = scene["geom"], scene["objects"], scene["ctx"]
    cam = make_camera(width, height, EYE, (0.0, 0.2, 0.0), fov=np.pi / 3.1,
                      device=scene["device"])
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, cam.viewproj, width,
        height)
    if use_tiled:
        depth, tid, _ = rasterize_direct(setup, width, height, cam.zn, cam.zf)
    else:
        depth, tid = rasterize_brute(setup, width, height, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    hdr, stats = shade_forward_plus(
        gb, ctx, scene["lights"], cam.view, cam.proj, cam.zn, cam.zf, width,
        height, tile_size=16, cap=8, mode="tiled", sun_model="pbr_mr")
    return {"ldr": tonemap_pass(hdr), "hdr": hdr, "gb": gb, "stats": stats}


def main(argv=None):
    args = parser(__doc__, 640, 360).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    imgs = {}
    for name, use_tiled in (("kernel", True), ("brute", False)):
        out = render(scene, args.width, args.height, use_tiled)
        imgs[name] = fetch_image(out["ldr"])
        print(f"{name}: ldr_hash="
              f"{hashlib.sha1(imgs[name].tobytes()).hexdigest()[:16]} "
              f"max_lights_per_tile={int(out['stats']['max_lights_per_bin'])}")
    match = bool((imgs["kernel"] == imgs["brute"]).all())
    print(f"backend parity: match={match}")
    path = write_frame(args.out, "torch_hello_light_types.png",
                       imgs["kernel"])
    print(f"wrote {path}")
    if not match:
        raise SystemExit("rasterizer backends disagree")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
