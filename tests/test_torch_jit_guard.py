"""The capture-safety guard over warm frames (CPU): CaptureCheck, the
class lsr_tpu_torch.utils.jit captures under on the card, runs over one
warm frame of bench.py's whole flagship frame at 192x108 in each of the
four configurations of chip_smoke.py phase 4, and of each render-path
preset, both compositions and Config #5 at 128x96 (execute_jitted's plan),
maps cut; and of the high-poly route with checked capacities
(utils.capacity): render_forward on kernel B1 and on kernel B3,
make_highpoly_frame (compact setup, B3, B2), e2e_compact_chunklist
(compact setup, B4) and execute_jitted above compact_setup_threshold.
It fails on a host read (aten._local_scalar_dense and the
Tensor methods that read values), an op whose output shape depends on the
data (nonzero, masked_select, unique, boolean indexing, repeat_interleave
without output_size), a constant made from host data after the warm-up,
or a new device_const.  Exempt, by name, are only the kernels' plain
versions (PLAIN): on the card their kernels run instead.
"""

from __future__ import annotations

import importlib

import numpy as np

import pytest

from lsr_tpu_torch.core import util
from lsr_tpu_torch.utils import jit as jm
from torch_scenes import preset_pipeline

PW, PH = 128, 96


# The kernels' plain versions (module, name): on the card the kernel runs.
PLAIN = (("lsr_tpu_torch.raster.tiled", "rasterize_brute"),
         ("lsr_tpu_torch.raster.tiled", "_banded_brute"),
         ("lsr_tpu_torch.raster.tiled", "rasterize_tiled_plain"),
         ("lsr_tpu_torch.raster.tiled", "rasterize_chunklist_plain"),
         ("lsr_tpu_torch.lighting.shade_kernel", "_shade_plain"),
         ("lsr_tpu_torch.lighting.resolve_kernel", "_resolve_plain"))


def _guarded(monkeypatch, run):
    """run() once to warm up, then again under CaptureCheck with the plain
    versions exempt; no device_const may be made by the second run."""
    check = jm.CaptureCheck()
    for mod_name, name in PLAIN:
        mod = importlib.import_module(mod_name)
        plain = getattr(mod, name)

        def exempt(*a, _plain=plain, **k):
            with check.pause():
                return _plain(*a, **k)

        monkeypatch.setattr(mod, name, exempt)
    run()
    n_consts = len(util._CONSTS)
    with check:
        run()
    assert len(util._CONSTS) == n_consts, "a constant made after warm-up"


@pytest.mark.parametrize("config", ["esm", "packed", "resolve", "pcf"])
def test_flagship_frame_is_capture_safe(monkeypatch, config):
    """bench.py's whole frame (cull, 8 + 2 atlas, planes) at 192x108 in the
    four configurations of chip_smoke.py phase 4, maps cut (sun 128^2,
    slots 64^2, faces 32^2)."""
    from lsr_tpu_torch import frame as fr

    w, h = 192, 108
    geom, objects, lights, ctx = fr.build_flagship_scene(16, grid=2,
                                                         device="cpu")
    cam, ctx_t = fr.flagship_camera(2, ctx, w, h, device="cpu")
    cfg = fr.bench_config("pcf" if config == "pcf" else "esm", w, h)
    cfg.update(shadow_size=128, local_map=64, local_point=32)
    frame = fr.make_flagship_frame(geom, objects, lights, ctx, w, h,
                                   use_resolve=config == "resolve",
                                   atlas_packed=config == "packed", **cfg)
    _guarded(monkeypatch, lambda: frame(cam, ctx_t))


@pytest.mark.parametrize("name", ["forward_classic", "forward_plus",
                                  "deferred", "tiled_deferred",
                                  "clustered_forward", "forward_classic+ssao",
                                  "forward_plus+full", "config5"])
def test_pipeline_frame_is_capture_safe(monkeypatch, name):
    """execute_jitted's plan for each preset, both compositions and Config
    #5 (TAA history carried) at 128x96, maps cut."""
    from lsr_tpu_torch.pipeline.executor import RenderContext

    if name == "config5":
        from lsr_tpu_torch.full_pipeline import build_full_pipeline

        frame_fn, _, fp = build_full_pipeline(PW, PH, taa=True, device="cpu")
        fp.pass_params.shadow.map_size = 128
        frame_fn(0)
        _guarded(monkeypatch, lambda: frame_fn(1))
        return
    if name == "forward_plus+full":
        from lsr_tpu_torch.render_paths import POST_STACK_PRESETS

        pipe, fp, state_fn = preset_pipeline("forward_plus", PW, PH,
                                             POST_STACK_PRESETS["full"])
    else:
        pipe, fp, state_fn = preset_pipeline(name, PW, PH)
    pipe.execute_jitted(RenderContext(), state_fn(0), fp)
    _guarded(monkeypatch,
             lambda: pipe.execute_jitted(RenderContext(), state_fn(1), fp))


HW, HH, HGRID = 160, 96, 3


@pytest.fixture(scope="module")
def highpoly():
    """The high-poly sphere field cut to a 3x3 grid (9,216 triangles) and
    the bench's camera over it, at 160x96."""
    from lsr_tpu_torch.highpoly import build_highpoly_scene, highpoly_camera

    geom, objects, lights, ctx = build_highpoly_scene(HGRID, n_lights=16,
                                                      device="cpu")
    cam, ctx_t = highpoly_camera(ctx, HW, HH, HGRID, device="cpu")
    return geom, objects, lights, ctx, cam, ctx_t


def _sized(prog, *args):
    """The frame body of a checked program at the capacities its first
    (eager, sizing) call keeps: what jit warms up and captures."""
    prog(*args)
    return lambda: prog.fn(*args, prog.caps[prog.key(*args)])


@pytest.mark.parametrize("path", ["render_forward_b1", "render_forward_b3",
                                  "highpoly_frame", "e2e_compact_chunklist",
                                  "execute_jitted"])
def test_highpoly_route_is_capture_safe(monkeypatch, highpoly, path):
    """One warm frame of each path of the high-poly route at its sized
    capacities: render_forward on B1, and on B3 (DIRECT_ROW_LIMIT 0);
    make_highpoly_frame, and execute_jitted on the forward_plus preset at
    128x96, with the compact setup (threshold 0) and B3 (DIRECT_ROW_LIMIT
    0); e2e_compact_chunklist (compact setup, B4)."""
    from lsr_tpu_torch import highpoly as hp
    from lsr_tpu_torch import render
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.utils.capacity import Checked, checked

    geom, objects, lights, ctx, cam, ctx_t = highpoly
    if path != "render_forward_b1":
        monkeypatch.setattr(tiled, "DIRECT_ROW_LIMIT", 0)
    if path.startswith("render_forward"):
        batch = {k: getattr(geom, k) for k in (
            "positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")}
        run = _sized(checked(render._forward_frame), batch, objects.model,
                     objects.normal_mat, cam.viewproj, cam.zn, cam.zf,
                     ctx_t, HW, HH, "pbr_mr", (0.05, 0.07, 0.12), True, 1024,
                     1.0, 2.2, tiled.DIRECT_ROW_LIMIT)
    elif path == "highpoly_frame":
        fp = hp.highpoly_frame_params(HW, HH)
        fp.compact_setup_threshold = 0
        run = _sized(hp.make_highpoly_frame(geom, objects, lights, ctx, fp),
                     cam, ctx_t)
    elif path == "e2e_compact_chunklist":
        run = _sized(checked(hp._e2e_step), geom, objects, cam, HW, HH)
    else:
        pipe, fp, state_fn = preset_pipeline("forward_plus", PW, PH)
        fp.compact_setup_threshold = 0
        key = Checked.key(pipe._start(state_fn(0)))
        pipe.execute_jitted(RenderContext(), state_fn(0), fp)
        prog, state = pipe._jitted, pipe._start(state_fn(1))
        run = lambda: prog.fn(state, prog.caps[key])  # noqa: E731
    _guarded(monkeypatch, run)


@pytest.mark.parametrize("path", ["render", "flagship", "light_sharded",
                                  "pipelined"])
def test_sharded_step_is_capture_safe(monkeypatch, path):
    """One warm step of each of parallel.sharding's four steps (the
    undecorated step, Jitted.fn) on a mesh of four CPU ranks (two for pp)
    at 64x32, the flagship with its 128^2 sun map and local atlas: the
    all_gathers, ppermute halos, psum and, for pp, the camera stream."""
    from test_torch_sharding_jit import CARD_MESH, STEP_CAMS, _build

    from lsr_tpu.scene.scene import make_camera
    from lsr_tpu_torch import convert
    from test_torch_sharding import _lit_scene, _tiny_scene, _to_torch

    tiny, lit = _tiny_scene(), _lit_scene(2, 8, 1.5, 2.0)
    scenes = {"tiny": (tiny, _to_torch(*tiny)), "lit": (lit, _to_torch(*lit))}
    step, args_of = _build(path, scenes, CARD_MESH[path])
    cams = [convert.camera_state(make_camera(
        64, 32, (np.sin(a) * -3.5, 1.8, np.cos(a) * -3.5), (0, 0, 0)), "cpu")
        for a in np.linspace(0.0, 0.4, STEP_CAMS[path])]
    args = args_of(cams)
    _guarded(monkeypatch, lambda: step.fn(*args))


def test_flagship_frame_with_moving_planes_is_capture_safe(monkeypatch):
    """bench.py's whole frame at 192x108 (maps cut) whose camera's zn / zf
    change between the warm-up and the guarded frame: data, so no host
    read and no constant made for the new pair."""
    import dataclasses

    from lsr_tpu_torch import frame as fr
    from lsr_tpu_torch.scene.scene import f32_scalar

    w, h = 192, 108
    geom, objects, lights, ctx = fr.build_flagship_scene(16, grid=2,
                                                         device="cpu")
    cam, ctx_t = fr.flagship_camera(2, ctx, w, h, device="cpu")
    cfg = fr.bench_config("esm", w, h)
    cfg.update(shadow_size=128, local_map=64, local_point=32)
    frame = fr.make_flagship_frame(geom, objects, lights, ctx, w, h, **cfg)
    cams = iter([dataclasses.replace(cam, zn=f32_scalar(zn, "cpu"),
                                     zf=f32_scalar(zf, "cpu"))
                 for zn, zf in ((0.1, 100.0), (0.25, 40.0))])

    def run():
        frame(next(cams), ctx_t)

    _guarded(monkeypatch, run)


@pytest.mark.parametrize("config", ["esm", "pcf"])
def test_crop_windows_are_capture_safe(monkeypatch, config):
    """Kernels V1 and V2's plain versions on the planes of bench.py's whole
    frame with its crop cascade (flagship (a) ESM, (d) PCF; 192x108, maps
    cut), warmed up at camera 2 of the bench orbit and run under
    CaptureCheck at camera 80, whose windows differ: the windows stay on
    the device, and no constant is made for the new camera."""
    import torch

    from lsr_tpu_torch import frame as fr
    from lsr_tpu_torch.lighting import vis_kernel
    from lsr_tpu_torch.shading.models import _norm

    w, h = 192, 108
    geom, objects, lights, ctx = fr.build_flagship_scene(16, grid=2,
                                                         device="cpu")
    cfg = fr.bench_config(config, w, h)
    cfg.update(shadow_size=128, local_map=64, local_point=32)
    stages = []
    for i in (2, 80):
        cam, ctx_t = fr.flagship_camera(i, ctx, w, h, device="cpu")
        st = fr.flagship_stages(geom, objects, lights, ctx, cam, ctx_t, w, h,
                                **cfg)
        stages.append((st["local"], st["gb"].world_pos,
                       _norm(st["gb"].normal_ws)))
    assert stages[0][0].vis_crop
    outs = []

    def run(it=iter(stages)):
        sh, wp, nm = next(it)
        win, go = vis_kernel.vis_windows(sh, wp)
        outs.append((win, vis_kernel.vis_planes(sh, wp, nm, win, go)))

    _guarded(monkeypatch, run)
    assert not torch.equal(outs[0][0], outs[1][0])
    assert outs[1][1].shape == ((stages[1][0].n_shadowed + 1,)
                                + tuple(stages[1][1].shape[:2]))
