"""Multi-rank dry run of the sharded paths (port of
lsr_tpu/parallel/dryrun.py: run_dryrun, run_flagship_dryrun).

    python -m lsr_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]

runs N ranks on one device (default: the card; lsr_tpu forces N virtual
XLA host devices instead), checks each mesh's frames against the (1, 1)
mesh's or the unsharded render, and prints one JSON row per mesh shape:
{"phase": "multichip", "path", "dp" / "sp" / "lp" / "pp", "ranks", "w",
"h", "step_ms", "platform", "device", ...}.  All ranks share the device,
so each step is one program (parallel.sharding, utils.jit): on the card
step_ms is the time of a replayed step, the ranks' work one after another
on the device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.io.obj import make_cube, make_plane
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.parallel.sharding import (
    make_light_sharded_forward,
    make_mesh,
    make_mesh_lp,
    make_mesh_pp,
    make_pipelined_render,
    make_sharded_flagship,
    make_sharded_render,
    render_band,
)
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.shading.common import make_materials
from lsr_tpu_torch.shading.models import make_shade_context


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(run, device, iters=3):
    """(last output, mean host ms of `iters` runs after two: the step's
    warm-up and, on the card, its capture)."""
    run()
    out = run()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run()
    _sync(device)
    return out, (time.perf_counter() - t0) / iters * 1e3


def _row(path, device, ranks, w, h, ms, **axes):
    row = {"phase": "multichip", "path": path, **axes, "ranks": ranks,
           "w": w, "h": h, "step_ms": ms, "platform": device.type,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "ranks_share_one_device": True}
    print(json.dumps(row), flush=True)
    return row


def run_dryrun(n_devices: int, device=None, width: int = 128,
               height: int = 64, flagship_size: int = 128,
               shadow_size: int = 256) -> list:
    """The screen-sharded render step over an n-rank ("dp", "sp") mesh on
    the tiny cube, each camera checked bit for bit against its unsharded
    render_band; then run_flagship_dryrun.  Returns the printed rows."""
    dev = resolve_device(device)
    mesh = make_mesh(n_devices, devices=[dev] * n_devices)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    sb = SceneBuilder()
    sb.add(make_cube(1.2), (m3.rotate_y(0.4) @ m3.rotate_x(0.2)).numpy())
    geom, objects = sb.build(dev)
    mats = make_materials(base_color=[(0.8, 0.5, 0.3)], device=dev)
    ctx = make_shade_context(mats, light_dir_ws=(0.4, -0.7, 0.5),
                             camera_pos=(0, 0.5, -3.0), light_intensity=2.0,
                             device=dev)
    step = make_sharded_render(mesh, geom, objects, ctx, width, height,
                               cap=256)
    cams = [make_camera(width, height,
                        (np.sin(a) * -3.0, 0.5, np.cos(a) * -3.0), (0, 0, 0),
                        device=dev)
            for a in np.linspace(0.0, 0.5, dp)]
    vps = torch.stack([c.viewproj for c in cams])
    out, ms = _timed(lambda: step(vps, cams[0].zn, cams[0].zf), dev)
    assert out.shape == (dp, height, width, 3), out.shape
    assert bool(out.any()), "sharded render produced an empty image"
    for b, cam in enumerate(cams):
        ref = render_band(geom, objects, cam.viewproj, cam.zn, cam.zf, ctx,
                          width, height, height, 0, cap=256)
        assert torch.equal(ref, out[b]), (
            f"sharded output differs from the unsharded render (camera {b})")
    rows = [_row("render", dev, n_devices, width, height, ms, dp=dp, sp=sp)]
    return rows + run_flagship_dryrun(n_devices, dev, flagship_size,
                                      shadow_size)


def _flagship_scene(dev):
    """The cube over a plane, two shadowed spots and two shadowed points
    then eight fill points (lsr_tpu's dry-run scene, default_rng(2))."""
    sb = SceneBuilder()
    sb.add(make_cube(1.1),
           (m3.translate([0.0, 0.3, 0.0]) @ m3.rotate_y(0.4)).numpy())
    sb.add(make_plane(5.0, y=-1.0), material=1, casts_shadow=False)
    geom, objects = sb.build(dev)
    mats = make_materials(base_color=[(0.8, 0.5, 0.3), (0.5, 0.55, 0.6)],
                          roughness=[0.4, 0.8], device=dev)
    ctx = make_shade_context(mats, light_dir_ws=(0.35, -0.7, 0.5),
                             camera_pos=(0.5, 1.8, -3.5), light_intensity=2.0,
                             device=dev)
    lb = LightSetBuilder()
    rng = np.random.default_rng(2)
    for sx in (-1.5, 1.5):
        lb.spot((sx, 2.5, 0.5), (0, -1, 0), color=(1.0, 0.9, 0.7),
                intensity=2.5, range=4.0, inner_angle=0.4, outer_angle=0.7)
    for _ in range(2):
        lb.point(tuple(rng.uniform([-2, 0.8, -2], [2, 1.4, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.6, range=2.5)
    for _ in range(8):
        lb.point(tuple(rng.uniform([-2, 0.2, -2], [2, 1.5, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.5, range=2.0)
    return geom, objects, ctx, lb.build(dev)


def run_flagship_dryrun(n_devices: int, device=None, size: int = 128,
                        shadow_size: int = 256) -> list:
    """The flagship frame (sun map bands + all_gather, sharded local atlas,
    cull, forward+, FXAA with ppermute halos) on meshes (1, 1), (1, n) and,
    for even n >= 4, (2, n / 2), every camera bit for bit its (1, 1) frame;
    the light-sharded frame on (n / 2, 2) and (1, n) within 1 LSB of its
    (1, 1) frame; the two-stage pipeline over three cameras, output i bit
    for bit camera i - 1's render_band.  Returns the printed rows."""
    dev = resolve_device(device)
    ranks = lambda n: [dev] * n  # noqa: E731
    width = height = size
    geom, objects, ctx, lights = _flagship_scene(dev)
    sun = torch.tensor([0.35, -0.7, 0.5], dtype=torch.float32, device=dev)

    def cams_for(dp):
        return [make_camera(width, height,
                            (np.sin(a) * -3.5, 1.8, np.cos(a) * -3.5),
                            (0, 0, 0), device=dev)
                for a in np.linspace(0.0, 0.5, dp)]

    def run_on(mesh, cams):
        step = make_sharded_flagship(mesh, geom, objects, ctx, lights, width,
                                     height, shadow_size=shadow_size)
        vps = torch.stack([c.viewproj for c in cams])
        views = torch.stack([c.view for c in cams])
        return _timed(lambda: step(vps, views, cams[0].proj, cams[0].zn,
                                   cams[0].zf, sun), dev)

    rows = []
    ref_cache = {}

    def ref_for(cam):
        key = float(cam.viewproj.sum())
        if key not in ref_cache:
            ref_cache[key] = run_on(make_mesh(1, devices=ranks(1)), [cam])
        return ref_cache[key]

    _, ms1 = ref_for(cams_for(1)[0])
    rows.append(_row("flagship", dev, 1, width, height, ms1, dp=1, sp=1,
                     shadow=shadow_size))
    shapes = [(1, n_devices)]
    if n_devices % 2 == 0 and n_devices >= 4:
        shapes.append((2, n_devices // 2))
    for dp, sp in shapes:
        cams = cams_for(dp)
        out, ms = run_on(make_mesh(dp * sp, dp=dp, devices=ranks(dp * sp)),
                         cams)
        assert out.shape == (dp, height, width, 3), out.shape
        for b, cam in enumerate(cams):
            assert torch.equal(out[b], ref_for(cam)[0][0]), (
                f"flagship dp={dp} sp={sp} camera {b} differs from its "
                f"(1, 1) frame")
        rows.append(_row("flagship", dev, dp * sp, width, height, ms, dp=dp,
                         sp=sp, shadow=shadow_size))

    cam0 = cams_for(1)[0]

    def run_lp(mesh):
        step, _ = make_light_sharded_forward(mesh, geom, objects, ctx, lights,
                                             width, height, cap=32)
        return _timed(lambda: step(cam0.viewproj, cam0.view, cam0.proj,
                                   cam0.zn, cam0.zf), dev)

    ref_lp, _ = run_lp(make_mesh_lp(1, sp=1, lp=1, devices=ranks(1)))
    for sp_n, lp_n in ((n_devices // 2, 2), (1, n_devices)):
        if sp_n * lp_n != n_devices or height % max(sp_n, 1):
            continue
        out, ms = run_lp(make_mesh_lp(n_devices, sp=sp_n, lp=lp_n,
                                      devices=ranks(n_devices)))
        d = (out.to(torch.int32) - ref_lp.to(torch.int32)).abs()
        assert int(d.max()) <= 1, (
            f"lp={lp_n}: the light sum's order moved a pixel by {d.max()}")
        rows.append(_row("light_sharded", dev, n_devices, width, height, ms,
                         dp=1, sp=sp_n, lp=lp_n))

    stream = make_pipelined_render(make_mesh_pp(2, devices=ranks(2)), geom,
                                   objects, ctx, width, height)
    pp_cams = cams_for(1) + cams_for(2)
    vps = torch.stack([c.viewproj for c in pp_cams])
    out, ms = _timed(lambda: stream(vps, pp_cams[0].zn, pp_cams[0].zf), dev,
                     iters=1)
    for i in range(1, len(pp_cams)):
        ref = render_band(geom, objects, pp_cams[i - 1].viewproj,
                          pp_cams[0].zn, pp_cams[0].zf, ctx, width, height,
                          height, 0)
        assert torch.equal(out[i], ref), f"pp frame {i} differs"
    rows.append(_row("pipelined", dev, 2, width, height,
                     ms / (len(pp_cams) - 1), pp=2))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (default: the card)")
    args = ap.parse_args()
    run_dryrun(args.n, args.device)


if __name__ == "__main__":
    main()
