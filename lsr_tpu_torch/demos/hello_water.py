"""The mesh over a rippling planar-reflection water surface (port of
demos/hello_water.py).

A reflection pass through the camera mirrored about the water plane, with
front faces culled and the water object masked out (kernel B1), the main
pass (B1), each over the procedural sky; then shade_water's Fresnel
composite, depth fog and the tonemap."""

from __future__ import annotations

import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.demos.common import (
    covered, parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.io.obj import make_plane
from lsr_tpu_torch.passes.post import fog_pass
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.passes.water import mirrored_camera, shade_water
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import CULL_BACK, CULL_FRONT, scene_setup
from lsr_tpu_torch.raster.tiled import rasterize_direct
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.shading.common import make_materials
from lsr_tpu_torch.shading.models import (
    composite_over_background,
    make_shade_context,
    shade_blinn_phong,
)
from lsr_tpu_torch.sky.sky_models import render_sky

WATER_Y = -0.8
SUN = (0.35, -0.75, 0.5)
EYE = (1.2, 1.2, -4.2)


def build_scene(mesh, device=None):
    device = setup_device(device)
    b = SceneBuilder()
    b.add(mesh, (m3.translate([0.0, 0.35, 0.0]) @ m3.rotate_y(0.4)).numpy())
    water_id = b.add(make_plane(8.0, y=WATER_Y), material=1,
                     casts_shadow=False)
    geom, objects = b.build(device)
    mats = make_materials(base_color=[(0.85, 0.55, 0.35), (0.1, 0.2, 0.25)],
                          roughness=[0.4, 0.1], metallic=[0.05, 0.0],
                          device=device)
    ctx = make_shade_context(mats, light_dir_ws=SUN,
                             light_color=(1.0, 0.96, 0.9),
                             light_intensity=2.6, camera_pos=EYE,
                             device=device)
    return {"geom": geom, "objects": objects, "ctx": ctx,
            "water_id": water_id, "device": device}


def render_view(geom, objects, ctx, viewproj, zn, zf, width, height,
                cull_mode=CULL_BACK, skip_obj=None):
    """One lit view over the sky: (hdr, GBuffer).  skip_obj leaves that
    object out of the raster."""
    vis = objects.visible
    if skip_obj is not None:
        vis = vis & (torch.arange(vis.shape[0], device=vis.device)
                     != skip_obj)
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, viewproj, width,
        height, cull_mode=cull_mode, obj_visible=vis)
    depth, tid, _ = rasterize_direct(setup, width, height, zn, zf)
    gb = interpolate_gbuffer(setup, depth, tid)
    shaded = shade_blinn_phong(gb, ctx)
    sky = render_sky(viewproj, width, height,
                     sun_dir_ws=torch.tensor(SUN, device=viewproj.device))
    return composite_over_background(shaded, gb, sky), gb


def render(scene, width: int, height: int, time: float = 1.0):
    """{"ldr", "hdr", "gb", "reflection"}: the final frame, its HDR before
    the tonemap, the main view's G-buffer and the reflection pass's HDR."""
    geom, objects, ctx = scene["geom"], scene["objects"], scene["ctx"]
    cam = make_camera(width, height, EYE, (0, -0.1, 0),
                      device=scene["device"])
    refl_vp = m3.matmul4(cam.proj, mirrored_camera(cam.view, WATER_Y))
    refl_hdr, _ = render_view(geom, objects, ctx, refl_vp, cam.zn, cam.zf,
                              width, height, cull_mode=CULL_FRONT,
                              skip_obj=scene["water_id"])
    main_hdr, gb = render_view(geom, objects, ctx, cam.viewproj, cam.zn,
                               cam.zf, width, height)
    hdr = shade_water(gb, refl_hdr, scene["water_id"], main_hdr, cam.eye,
                      time=time)
    hdr = fog_pass(hdr, gb.depth01, fog_color=(0.55, 0.62, 0.7),
                   fog_density=0.5)
    return {"ldr": tonemap_pass(hdr), "hdr": hdr, "gb": gb,
            "reflection": refl_hdr}


def main(argv=None):
    args = parser(__doc__, 800, 600).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    out = render(scene, args.width, args.height)
    path = write_frame(args.out, "torch_hello_water.png", out["ldr"])
    print(f"wrote {path} covered={covered(out['gb'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
