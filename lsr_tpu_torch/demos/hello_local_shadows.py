"""Local light shadows: six meshes in a ring, two shadowed spots and
shadowed points, plus unshadowed fill lights (port of
demos/hello_local_shadows.py).

plan_shadow_casters picks the casters; the atlas renders each slot through
kernel B1 ("map", one launch a slot) or each stack through B1's stacked
variant B1a ("packed"); PCF (reference-exact) or ESM tables; the camera
goes through B1 (or rasterize_brute with use_tiled=False) and the lighting
through kernel B2 with the local-shadow planes (B2a).  --filter and
--atlas take the place of lsr_tpu's LSR_DEMO_SHADOW_FILTER and
LSR_DEMO_ATLAS; the atlas always goes through B1 (lsr_tpu's use_tiled
also switches its atlas to rasterize_brute; here it picks the camera's
raster only)."""

from __future__ import annotations

import hashlib

import numpy as np

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.demos.common import (
    parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.io.obj import make_plane
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.lighting.local_shadows import (
    plan_shadow_casters,
    render_local_shadow_maps,
)
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

EYE = (5.5, 4.5, -6.5)


def build_scene(mesh, device=None):
    device = setup_device(device)
    b = SceneBuilder()
    for i in range(6):
        ang = i * np.pi / 3.0
        x, z = 2.4 * np.cos(ang), 2.4 * np.sin(ang)
        b.add(mesh, (m3.translate([x, 0.2, z])
                     @ m3.rotate_y(-ang + np.pi / 2)).numpy(),
              material=i % 3)
    b.add(make_plane(9.0, y=-1.0), material=3, casts_shadow=False)
    geom, objects = b.build(device)

    lb = LightSetBuilder()
    # Two shadowed spots aimed across the ring + a shadowed point inside it.
    lb.spot((3.5, 4.0, 0.0), (-0.6, -1.0, 0.0), color=(1.0, 0.85, 0.6),
            intensity=6.0, range=12.0, inner_angle=0.5, outer_angle=0.9)
    lb.spot((-3.5, 4.0, 0.0), (0.6, -1.0, 0.0), color=(0.6, 0.8, 1.0),
            intensity=6.0, range=12.0, inner_angle=0.5, outer_angle=0.9)
    lb.point((0.0, 0.8, 0.0), color=(0.9, 1.0, 0.8), intensity=4.0, range=7.0)
    # Fill lights (the first one also takes the second point budget slot).
    rng = np.random.default_rng(5)
    for _ in range(24):
        lb.point(tuple(rng.uniform([-4, 0.2, -4], [4, 2.0, 4]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=0.8, range=2.0)
    mats = make_materials(
        base_color=[(0.85, 0.55, 0.35), (0.5, 0.65, 0.85), (0.7, 0.8, 0.5),
                    (0.55, 0.56, 0.6)],
        metallic=[0.1, 0.3, 0.0, 0.0], roughness=[0.45, 0.3, 0.7, 0.85],
        device=device)
    ctx = make_shade_context(
        mats, light_dir_ws=(0.3, -0.8, 0.4), light_color=(1.0, 0.97, 0.9),
        light_intensity=0.6, camera_pos=EYE, device=device)
    lights = lb.build(device)
    return {"geom": geom, "objects": objects, "lights": lights, "ctx": ctx,
            "casters": plan_shadow_casters(lights, max_spot=8, max_point=2),
            "device": device}


def render(scene, width: int, height: int, use_tiled: bool = True,
           shadow_filter: str = "pcf", atlas: str = "map",
           map_size: int = 512):
    """{"ldr", "hdr", "gb", "shadows"} (shadows: the LocalShadowMaps)."""
    geom, objects, ctx = scene["geom"], scene["objects"], scene["ctx"]
    lights = scene["lights"]
    cam = make_camera(width, height, EYE, (0, 0, 0), fov=np.pi / 3.0,
                      device=scene["device"])
    spot_ids, point_ids = scene["casters"]
    sh = render_local_shadow_maps(
        geom, objects, lights, spot_ids=spot_ids, point_ids=point_ids,
        map_size=map_size, pcf_radius=1, filter_mode=shadow_filter,
        atlas_packed=atlas == "packed")
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, cam.viewproj, width,
        height)
    if use_tiled:
        depth, tid, _ = rasterize_direct(setup, width, height, cam.zn, cam.zf)
    else:
        depth, tid = rasterize_brute(setup, width, height, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    hdr, _ = shade_forward_plus(
        gb, ctx, lights, cam.view, cam.proj, cam.zn, cam.zf, width, height,
        tile_size=16, cap=32, mode="tiled", sun_model="blinn_phong",
        local_shadows=sh)
    return {"ldr": tonemap_pass(hdr), "hdr": hdr, "gb": gb, "shadows": sh}


def main(argv=None):
    p = parser(__doc__, 640, 480)
    p.add_argument("--filter", choices=("pcf", "esm"), default="pcf",
                   help="local shadow filter (default pcf, reference-exact)")
    p.add_argument("--atlas", choices=("map", "packed"), default="map",
                   help="atlas: one B1 launch a slot, or one B1a a stack")
    args = p.parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    imgs = {}
    for name, use_tiled in (("kernel", True), ("brute", False)):
        out = render(scene, args.width, args.height, use_tiled, args.filter,
                     args.atlas)
        imgs[name] = fetch_image(out["ldr"])
        print(f"{name}: ldr_hash="
              f"{hashlib.sha1(imgs[name].tobytes()).hexdigest()[:16]}")
    match = bool((imgs["kernel"] == imgs["brute"]).all())
    print(f"backend parity: match={match}")
    path = write_frame(args.out, "torch_hello_local_shadows.png",
                       imgs["kernel"])
    print(f"wrote {path}")
    if not match:
        diff = imgs["kernel"].astype(int) - imgs["brute"].astype(int)
        print(f"  max |diff| = {np.abs(diff).max()}, "
              f"pixels differing = {(diff != 0).any(-1).sum()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
