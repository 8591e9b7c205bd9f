"""Parallelization strategies: the hello-parallelization family (port of
demos/hello_parallelization.py).

The reference family shows scanline-band threading, tile jobs, job graphs,
fibers and SIMD (hello-parallelization/*.cpp).  lsr_tpu maps them onto
device-mesh axes; the port keeps its mesh paths (parallel/sharding.py):

  dp  - cameras per rank (batch parallelism)
  sp  - framebuffer row bands per rank (kernel B1's y_offset bands)
  lp  - light-set shards, partial sums added by psum
  pp  - 2-stage frame pipeline, G-buffer handed on by ppermute

lsr_tpu re-runs itself on 8 virtual CPU devices.  The port takes 8 ranks
on the one card by default (devices=[cuda:0] * 8: they run one after
another on it), or on the CPU with --device cpu.  The scene: the mesh (a
UV sphere standing in for the monkey) on a plane, 16 point lights.  Checks,
each raising when it fails: dp2 x sp4 equals the (1, 1) mesh bit for bit;
the pp stream is deterministic; under 0.1% of pp pixels differ from
(1, 1)."""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.demos.common import (
    parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.io.obj import make_plane
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.parallel.sharding import (
    make_light_sharded_forward,
    make_mesh,
    make_mesh_lp,
    make_mesh_pp,
    make_pipelined_render,
    make_sharded_render,
)
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.shading.common import make_materials
from lsr_tpu_torch.shading.models import make_shade_context

EYE = (0.6, 1.1, -3.4)
RANKS = 8
PP_MAX_DIFF = 1e-3      # share of pp pixels allowed to differ from (1, 1)
PANELS = ("single", "dp2xsp4", "sp4xlp2", "pp2")


def build_scene(mesh, device=None):
    device = setup_device(device)
    sb = SceneBuilder()
    sb.add(mesh, (m3.translate([0, 0.2, 0]) @ m3.rotate_y(0.5)).numpy())
    sb.add(make_plane(5.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build(device)
    mats = make_materials(base_color=[(0.8, 0.55, 0.35), (0.5, 0.55, 0.6)],
                          roughness=[0.4, 0.8], device=device)
    ctx = make_shade_context(mats, light_dir_ws=(0.4, -0.7, 0.5),
                             camera_pos=EYE, light_intensity=2.2,
                             device=device)
    lb = LightSetBuilder()
    rng = np.random.default_rng(5)
    for _ in range(16):
        lb.point(tuple(rng.uniform([-2, 0.3, -2], [2, 1.5, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.6, range=2.5)
    return {"geom": geom, "objects": objects, "ctx": ctx,
            "lights": lb.build(device), "device": device}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"hello_parallelization: {msg}")


def render(scene, width: int, height: int, devices=None, log=print):
    """Every strategy on `devices` (default: RANKS ranks on the scene's
    device).  Returns {"panels": {name: (H, W, 3) u8}, "pp_diff": share of
    pp pixels off the (1, 1) mesh, "ldr": the panels side by side}."""
    dev = scene["device"]
    devices = [dev] * RANKS if devices is None else list(devices)
    geom, objects, ctx = scene["geom"], scene["objects"], scene["ctx"]
    cam = make_camera(width, height, EYE, (0, 0, 0), device=dev)
    # The reference runs the same sharded step on a (1, 1) mesh.
    step1 = make_sharded_render(make_mesh(1, devices=devices[:1]), geom,
                                objects, ctx, width, height, cap=256)
    ref = step1(cam.viewproj[None], cam.zn, cam.zf)[0]
    panels = {"single": ref}

    # dp x sp: cameras x row bands.
    mesh = make_mesh(8, devices=devices)               # dp=2, sp=4
    step = make_sharded_render(mesh, geom, objects, ctx, width, height,
                               cap=256)
    out = step(torch.stack([cam.viewproj, cam.viewproj]), cam.zn, cam.zf)
    panels["dp2xsp4"] = out[0]
    check(torch.equal(out[0], ref), "dp/sp mismatch")
    log("dp=2 x sp=4: bit-exact vs the 1-device mesh")

    # sp x lp: row bands x light shards (+ psum).
    mesh_lp = make_mesh_lp(8, sp=4, lp=2, devices=devices)
    step_lp, _ = make_light_sharded_forward(
        mesh_lp, geom, objects, ctx, scene["lights"], width, height, cap=32)
    panels["sp4xlp2"] = step_lp(cam.viewproj, cam.view, cam.proj, cam.zn,
                                cam.zf)
    log("sp=4 x lp=2: lights sharded, partial sums added by psum")

    # pp: 2-stage frame pipeline.
    stream = make_pipelined_render(make_mesh_pp(2, devices=devices), geom,
                                   objects, ctx, width, height)
    out_pp = stream(torch.stack([cam.viewproj] * 3), cam.zn, cam.zf)
    panels["pp2"] = out_pp[1]
    # Steady-state determinism: identical cameras -> identical frames.
    check(torch.equal(out_pp[1], out_pp[2]), "pp stream nondeterministic")
    frac = float((out_pp[1] != ref).any(-1).float().mean())
    check(frac < PP_MAX_DIFF, f"pp diverges from 1-device: {frac}")
    log(f"pp=2: raster|shade staged over ppermute, {frac * 100:.4f}% px "
        f"differ from the 1-device mesh")
    row = torch.cat([panels[k].to(ref.device) for k in PANELS], dim=1)
    return {"panels": panels, "pp_diff": frac, "ldr": row}


def main(argv=None):
    args = parser(__doc__, 256, 128).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    out = render(scene, args.width, args.height)
    path = write_frame(args.out, "torch_hello_parallelization.png",
                       out["ldr"])
    print(f"wrote {path} (panels: {' | '.join(PANELS)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
