"""The flagship analog: composition switching across the render paths at
run time (port of demos/hello_rendering_paths.py; parity target:
HelloRenderingPaths, hello_rendering_paths.cpp, render path x technique x
post stack with pipeline rebuild counting).

lsr_tpu's five presets and the forward_classic+ssao composition, each
under FXAA at 480x270 on render_paths.scene_state.  Each is configured and
planned once; lsr_tpu counts the compile of each plan as a rebuild, and
the port, which compiles nothing, counts each configure + plan, which
gives the same count.  The demo then cycles the compositions twice (a first
frame, then 5 frames each along its camera orbit), prints their frame
times and writes a contact sheet of one frame per composition.  The first
frame of the first cycle includes loading the kernel library."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from lsr_tpu_torch.core.frame import FrameParams, TechniqueMode
from lsr_tpu_torch.demos.common import parser, setup_device, write_frame
from lsr_tpu_torch.passes.standard_passes import make_standard_registry
from lsr_tpu_torch.pipeline.executor import RenderContext, synchronize
from lsr_tpu_torch.pipeline.pipeline import PluggablePipeline
from lsr_tpu_torch.pipeline.recipe import (
    builtin_render_path_presets,
    ssao_composition_recipe,
)
from lsr_tpu_torch.render_paths import MODE_FOR, scene_state
from lsr_tpu_torch.scene.scene import make_camera

CYCLES, FRAMES = 2, 5


def build_scene(width: int, height: int, device=None):
    """render_paths.scene_state on `device` (the UV-sphere stand-ins)."""
    device = setup_device(device)
    return {"state": scene_state(width, height, device=device),
            "device": device}


def composition_params(preset, width: int, height: int) -> FrameParams:
    """The demo's FrameParams for a preset: its technique and light
    culling, FXAA on, TAA off, everything else at its default."""
    fp = FrameParams(width=width, height=height)
    fp.technique.mode = TechniqueMode[MODE_FOR[preset.name]]
    fp.technique.light_culling = preset.light_culling
    fp.enable_fxaa = True
    fp.enable_taa = False
    return fp


def build_pipelines(width: int, height: int):
    """({name: (pipeline, fp, RenderContext)}, rebuilds): every
    composition configured and planned once."""
    reg = make_standard_registry()
    pipelines, rebuilds = {}, 0
    for preset in builtin_render_path_presets() + [ssao_composition_recipe()]:
        recipe = dataclasses.replace(preset, post_stack=("fxaa",))
        fp = composition_params(preset, width, height)
        pipe = PluggablePipeline(preexisting_semantics=())
        rep = pipe.configure_from_recipe(recipe, reg)
        if not rep.ok:
            raise RuntimeError(f"{preset.name}: {rep.errors}")
        plan = pipe.build_plan(fp)
        if not plan.ok:
            raise RuntimeError(f"{preset.name}: {plan.errors}")
        pipelines[preset.name] = (pipe, fp, RenderContext())
        rebuilds += 1
    return pipelines, rebuilds


def frame_state(scene, width: int, height: int, i: int) -> dict:
    """The scene state with frame i's camera of the demo's orbit."""
    a = 0.05 * i
    state = dict(scene["state"])
    state["camera"] = make_camera(width, height,
                                  (0.6 + 0.3 * np.sin(a), 1.6, -4.5),
                                  (0, 0, 0), device=scene["device"])
    return state


def render(scene, pipelines, name: str, state) -> torch.Tensor:
    """One frame of composition `name` on a frame state: (H, W, 3) u8."""
    pipe, fp, rt = pipelines[name]
    return pipe.execute_jitted(rt, state, fp)["ldr"]


def cycle(scene, pipelines, width: int, height: int, cycles: int = CYCLES,
          frames: int = FRAMES, log=print):
    """The demo's loop: per cycle and composition, a first frame, then
    `frames` frames, each timed to its end on the device.  Returns
    ({name: last frame}, [(cycle, name, first ms, ms a frame)])."""
    shots, times = {}, []
    for c in range(cycles):
        for name in pipelines:
            t0 = time.perf_counter()
            out = render(scene, pipelines, name,
                         frame_state(scene, width, height, c * 7))
            synchronize({"ldr": out})
            first_ms = (time.perf_counter() - t0) * 1000
            t0 = time.perf_counter()
            for i in range(frames):
                out = render(scene, pipelines, name,
                             frame_state(scene, width, height, c * 7 + i))
            synchronize({"ldr": out})
            ms = (time.perf_counter() - t0) / frames * 1000
            tag = "first, library load" if c == 0 else "first"
            log(f"cycle {c} {name:20s} first {first_ms:8.1f} ms ({tag}), "
                f"then {ms:6.1f} ms/frame")
            shots[name] = out
            times.append((c, name, first_ms, ms))
    return shots, times


def contact_sheet(shots) -> torch.Tensor:
    """The compositions' frames side by side (bottom-left origin)."""
    return torch.cat([s.cpu() for s in shots.values()], dim=1)


def main(argv=None):
    args = parser(__doc__, 480, 270, mesh=False).parse_args(argv)
    w, h = args.width, args.height
    scene = build_scene(w, h, args.device)
    pipelines, rebuilds = build_pipelines(w, h)
    print(f"compositions: {list(pipelines)} (rebuilds={rebuilds})")
    shots, _ = cycle(scene, pipelines, w, h)
    sheet = contact_sheet(shots)
    path = write_frame(args.out, "torch_hello_rendering_paths.png", sheet)
    print(f"wrote {path} ({sheet.shape[1]}x{sheet.shape[0]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
