"""The high-poly scene and its two paths (the counterpart of
scripts/bench_highpoly.py).

Scene: a grid x grid field of make_uv_sphere(rings=16, sectors=32)
instances (1,024 triangles each; 33 x 33 gives 1,115,136 triangles) at
1.2 spacing, each rotated about y by default_rng(seed) and given material
i % 4 (bench_highpoly.py:28-43, with the monkey mesh replaced by the
sphere).  Lights, materials and texture are the flagship's
(frame.build_flagship_scene: 256 lights from default_rng(42)).

- make_highpoly_frame: the pipeline's forward+ frame on it:
  _raster (compact setup -> B1 or B3) -> interpolate_gbuffer ->
  fused forward+ (B2, tiled depth range) -> tonemap -> FXAA.
- e2e_compact_chunklist: the bench's end-to-end step,
  scene_setup_compact -> rasterize_chunklist (B4) (bench_highpoly.py:156-166).

Both run as one program with checked capacities (utils.capacity), as
lsr_tpu traces them into one jit (execute_jitted's trace;
bench_highpoly.py:156-160): captured once into a CUDA graph on the card
and replayed, with no host read in mid-frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.frame import (
    FrameParams,
    LightCullingMode,
    TechniqueMode,
)
from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.frame import build_flagship_scene
from lsr_tpu_torch.io.obj import make_uv_sphere
from lsr_tpu_torch.passes.post import fxaa_pass
from lsr_tpu_torch.passes.standard_passes import _raster, fused_lighting
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.raster.setup import scene_setup, scene_setup_compact
from lsr_tpu_torch.raster.tiled import rasterize_chunklist
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.utils.capacity import checked

SPACING = 1.2


def build_highpoly_scene(grid: int = 33, seed: int = 7, n_lights: int = 256,
                         device=None):
    """Returns (geom, objects, lights, ctx) on `device` (default: the
    card, core.util.default_device)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    sphere = make_uv_sphere(rings=16, sectors=32)
    sb = SceneBuilder()
    for i in range(grid * grid):
        x = (i % grid - grid // 2) * SPACING
        z = (i // grid - grid // 2) * SPACING
        rot = float(rng.uniform(0, 2 * np.pi))
        sb.add(sphere, (m3.translate([x, 0.0, z]) @ m3.rotate_y(rot)).numpy(),
               material=i % 4)
    geom, objects = sb.build(device)
    _, _, lights, ctx = build_flagship_scene(n_lights, 42, device=device)
    return geom, objects, lights, ctx


def highpoly_camera(ctx, width: int, height: int, grid: int = 33,
                    device=None):
    """The bench's high, oblique view over the whole grid
    (bench_highpoly.py:61-64).  Returns (cam, ctx with its camera_pos)."""
    device = resolve_device(device)
    ext = grid * SPACING * 0.72
    eye = (ext, ext * 0.9, -ext)
    cam = make_camera(width, height, eye, (0, 0, 0), fov=np.pi / 3.0,
                      device=device)
    return cam, dataclasses.replace(
        ctx, camera_pos=torch.as_tensor(eye, dtype=torch.float32,
                                        device=device))


def highpoly_frame_params(width: int, height: int) -> FrameParams:
    """Forward+ with tiled depth-range light culling, pbr_mr, FXAA, no
    shadows; the raster knobs keep FrameParams' defaults (compact setup
    above 300K triangles, 64x128 binned tiles, chunk 16)."""
    fp = FrameParams(width=width, height=height, enable_shadows=False,
                     enable_fxaa=True, shading_model="pbr_mr")
    fp.technique.mode = TechniqueMode.FORWARD_PLUS
    fp.technique.light_culling = LightCullingMode.TILED_DEPTH_RANGE
    return fp


def make_highpoly_frame(geom, objects, lights, ctx, fp: FrameParams):
    """frame(cam, ctx_t) -> (ldr_u8 (H, W, 3), frame state: setup, depth,
    tid, gbuffer, hdr and raster_stats), one program with checked
    capacities (a utils.capacity.Checked: the first call of each key runs
    eagerly and sizes its lists; the frame body is frame.fn(cam, ctx_t,
    caps)).

    Float32 products on the card run in full precision (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tm = fp.pass_params.tonemap

    def frame(cam, ctx_t, caps):
        state = {"geom": geom, "objects": objects, "lights": lights,
                 "shade_ctx": ctx_t, "camera": cam, "capacities": caps}
        state = fused_lighting(_raster(state, fp), fp)
        state.pop("capacities")           # an input, not frame state
        ldr = tonemap_pass(state["hdr"], exposure=tm.exposure,
                           gamma=tm.gamma)
        if fp.enable_fxaa:
            ldr = fxaa_pass(ldr)
        return (ldr, state), state["raster_stats"]

    return checked(frame, name="highpoly_frame")


def compact_setup(geom, objects, cam, width: int, height: int):
    """scene_setup_compact of the scene for a camera: (TriSetup,
    CompactStats)."""
    return scene_setup_compact(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, cam.viewproj,
        width, height)


def e2e_compact_chunklist(geom, objects, cam, width: int, height: int):
    """Compact setup + chunk-worklist raster in one step, one program
    (e2e_compact_chunklist.program).  Returns (depth01, tid,
    max_chunks_per_tile, setup, CompactStats); after a compact overflow
    the step rasterizes scene_setup's rows instead and returns None for
    the CompactStats."""
    return e2e_compact_chunklist.program(geom, objects, cam, width, height)


def _e2e_step(geom, objects, cam, width, height, caps):
    """e2e_compact_chunklist's step: (its result, raster_stats).  caps=None
    reads the compact overflow on the host (the eager route)."""
    cstats = None
    stats = {}
    if caps is None or caps.compact:
        setup, cstats = compact_setup(geom, objects, cam, width, height)
        stats["compact_overflow"] = cstats.overflow
        if caps is not None:
            stats["capacity_exceeded"] = cstats.overflow
        elif bool(cstats.overflow):
            stats["compact_fallback"] = True
    if cstats is None or stats.get("compact_fallback"):
        setup, cstats = scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, width, height), None
    depth, tid, max_cnt = rasterize_chunklist(setup, width, height, cam.zn,
                                              cam.zf)
    return (depth, tid, max_cnt, setup, cstats), stats


e2e_compact_chunklist.program = checked(_e2e_step,
                                        name="e2e_compact_chunklist")
