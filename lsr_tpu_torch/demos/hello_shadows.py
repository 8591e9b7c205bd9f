"""Config #3: shadow-mapped multi-mesh scene with frustum + occlusion
culling (port of demos/hello_shadows.py).

cull_scene, then the software occlusion pass (occluders through kernel B1
at 320x180, HiZ tests), the 2048^2 PCF sun map (B1), the camera through the
binned tile raster (kernel B3, cap 2048, 32x128 tiles), Blinn-Phong with
the sun shadow, tonemap.  A tile listing more than 2048 triangles would
drop some, as lsr_tpu's raster drops them: here the cap is raised to fit
the largest list instead (rasterize_tiled's fit_cap), so none is."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.frame import ShadowPassParams
from lsr_tpu_torch.demos.common import (
    covered, parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.geometry.occlusion import run_occlusion_pass
from lsr_tpu_torch.io.obj import make_plane
from lsr_tpu_torch.passes.shadow import make_sun_shadow
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import scene_setup
from lsr_tpu_torch.raster.tiled import rasterize_tiled
from lsr_tpu_torch.scene.scene import SceneBuilder, cull_scene, make_camera
from lsr_tpu_torch.shading.common import make_materials
from lsr_tpu_torch.shading.models import (
    composite_over_background,
    make_shade_context,
    shade_blinn_phong,
)

SUN = (0.35, -0.8, 0.45)
EYE = (0.5, 2.2, -6.0)
CAP = 2048
BACKGROUND = (0.05, 0.07, 0.12)


def build_scene(mesh, device=None):
    device = setup_device(device)
    b = SceneBuilder()
    rng = np.random.default_rng(7)
    for i in range(6):
        x = (i % 3 - 1) * 2.2
        z = (i // 3) * 2.5 - 0.5
        rot = float(rng.uniform(0, 2 * np.pi))
        b.add(mesh, (m3.translate([x, 0.0, z]) @ m3.rotate_y(rot)).numpy(),
              material=i % 3)
    b.add(make_plane(8.0, y=-1.0), material=3, casts_shadow=False)
    geom, objects = b.build(device)
    mats = make_materials(
        base_color=[(0.85, 0.5, 0.3), (0.4, 0.65, 0.85), (0.6, 0.8, 0.45),
                    (0.55, 0.55, 0.58)],
        metallic=[0.05, 0.3, 0.0, 0.0], roughness=[0.4, 0.3, 0.7, 0.85],
        device=device)
    return {"geom": geom, "objects": objects, "materials": mats,
            "device": device}


def render(scene, width: int, height: int, shadow_size: int = 2048):
    """{"ldr", "hdr", "gb", "visible", "max_bin"}: the frame, its HDR, the
    G-buffer, the per-object visibility after the cull and the binned
    raster's largest tile list (over CAP: the cap was raised to fit it)."""
    geom, objects, dev = scene["geom"], scene["objects"], scene["device"]
    cam = make_camera(width, height, EYE, (0, 0, 0.5), device=dev)

    # Culling: frustum + software occlusion.
    frustum = cull_scene(objects, cam.viewproj)
    vis = run_occlusion_pass(geom, objects, cam.viewproj, cam.zn, cam.zf,
                             frustum)
    objects = dataclasses.replace(objects, visible=vis)

    shadow = make_sun_shadow(geom, objects, torch.tensor(SUN, device=dev),
                             ShadowPassParams(map_size=shadow_size,
                                              pcf_radius=2))
    ctx = make_shade_context(
        scene["materials"], light_dir_ws=SUN, light_color=(1.0, 0.96, 0.88),
        light_intensity=3.0, camera_pos=EYE, shadow=shadow, device=dev)
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, cam.viewproj, width,
        height, obj_visible=objects.visible)
    depth, tid, max_bin = rasterize_tiled(setup, width, height, cam.zn,
                                          cam.zf, cap=CAP, fit_cap=True)
    gb = interpolate_gbuffer(setup, depth, tid)
    shaded = shade_blinn_phong(gb, ctx)
    bg = torch.tensor(BACKGROUND, device=dev).expand(shaded.shape)
    hdr = composite_over_background(shaded, gb, bg)
    return {"ldr": tonemap_pass(hdr), "hdr": hdr, "gb": gb, "visible": vis,
            "max_bin": max_bin}


def main(argv=None):
    args = parser(__doc__, 800, 600).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    out = render(scene, args.width, args.height)
    path = write_frame(args.out, "torch_hello_shadows.png", out["ldr"])
    print(f"wrote {path} covered={covered(out['gb'])} "
          f"visible_objects={out['visible'].cpu().tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
