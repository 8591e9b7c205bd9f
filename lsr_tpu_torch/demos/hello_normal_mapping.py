"""Textured and normal-mapped mesh with multi-slot materials (port of
demos/hello_normal_mapping.py).

The mesh carries a base-color texture, a tangent-space bump normal map and
an ORM map; the floor is checkered.  The camera goes through kernel B1 and
the lighting (sun + two point lights) through kernel B2 with the surface
maps applied to its inputs."""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.demos.common import (
    covered, parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.io.obj import make_plane
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.passes.forward_plus import shade_forward_plus
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.raster.interp import interpolate_gbuffer
from lsr_tpu_torch.raster.setup import scene_setup
from lsr_tpu_torch.raster.tiled import rasterize_direct
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.shading.common import (
    bump_normal_texture,
    checkerboard_texture,
    make_materials,
)
from lsr_tpu_torch.shading.models import make_shade_context

EYE = (0.8, 1.2, -3.2)


def texture_stack() -> np.ndarray:
    """(3, 128, 128, 3): [0] checker base, [1] bump normal map, [2] ORM
    with roughness bands."""
    orm = np.full((128, 128, 3), [1.0, 0.8, 0.1], np.float32)
    yy = np.linspace(0, 4 * np.pi, 128, dtype=np.float32)
    orm[..., 1] = 0.4 + 0.35 * np.sin(yy)[None, :]
    return np.stack([checkerboard_texture(128),
                     bump_normal_texture(128, bumps=7, amplitude=1.0), orm])


def build_scene(mesh, device=None):
    device = setup_device(device)
    sb = SceneBuilder()
    sb.add(mesh, (m3.translate([0.0, 0.25, 0.0]) @ m3.rotate_y(0.4)).numpy(),
           material=0)
    sb.add(make_plane(5.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build(device)
    mats = make_materials(
        base_color=[(0.85, 0.6, 0.4), (0.55, 0.56, 0.6)],
        metallic=[0.5, 0.0], roughness=[0.9, 0.8], tex_id=[0, 0],
        normal_tex=[1, -1], orm_tex=[2, -1], device=device)
    lb = LightSetBuilder()
    lb.point((1.5, 1.5, -1.5), color=(1.0, 0.8, 0.6), intensity=3.0,
             range=6.0)
    lb.point((-1.5, 1.0, -1.0), color=(0.5, 0.7, 1.0), intensity=2.0,
             range=5.0)
    ctx = make_shade_context(
        mats, light_dir_ws=(0.45, -0.7, 0.55), light_color=(1.0, 0.97, 0.92),
        light_intensity=2.2, camera_pos=EYE,
        textures=torch.as_tensor(texture_stack(), device=device),
        device=device)
    if not ctx.surface_maps:
        raise RuntimeError("hello_normal_mapping: no surface maps in use")
    return {"geom": geom, "objects": objects, "lights": lb.build(device),
            "ctx": ctx, "device": device}


def render(scene, width: int, height: int):
    """{"ldr", "hdr", "gb"}."""
    geom, objects, ctx = scene["geom"], scene["objects"], scene["ctx"]
    cam = make_camera(width, height, EYE, (0, 0, 0), device=scene["device"])
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, cam.viewproj, width,
        height)
    depth, tid, _ = rasterize_direct(setup, width, height, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    hdr, _ = shade_forward_plus(
        gb, ctx, scene["lights"], cam.view, cam.proj, cam.zn, cam.zf, width,
        height, tile_size=16, cap=8, sun_model="pbr_mr")
    return {"ldr": tonemap_pass(hdr), "hdr": hdr, "gb": gb}


def main(argv=None):
    args = parser(__doc__, 800, 600).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    out = render(scene, args.width, args.height)
    path = write_frame(args.out, "torch_hello_normal_mapping.png",
                       out["ldr"])
    print(f"wrote {path} covered={covered(out['gb'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
