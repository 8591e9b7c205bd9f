"""The system under test: lsr_tpu_torch's one-program frames, built from the
benchmark's inputs.

- "flagship_frame": jit(frame.make_flagship_frame(...)), called as
  (cam, ctx_t), as bench.py calls its jitted frame.  Its first call is the
  eager warm-up, its second captures the CUDA graph, later calls replay it.
- "preset_pipeline": the composition's PluggablePipeline from
  render_paths.build_preset_pipelines, driven by execute_jitted on the
  benchmark's scene.  Its first call sizes the checked capacities
  (eager); the second, the first with a visibility history, is another
  key and sizes again; the third is jit's warm-up (eager), the fourth
  captures.

The program takes only what the benchmark made (scene.SceneInputs and the
staged cameras); the benchmark takes from it the frame's outputs, its
launch counters and its kernel names.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from lsr_tpu_torch.frame import make_flagship_frame
from lsr_tpu_torch.io.obj import MeshData
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters
from lsr_tpu_torch.pipeline.executor import RenderContext
from lsr_tpu_torch.render_paths import build_preset_pipelines
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.shading.common import make_materials
from lsr_tpu_torch.shading.models import make_shade_context
from lsr_tpu_torch.utils.cuda_build import load_kernels
from lsr_tpu_torch.utils.jit import jit, launch_counters

from renderbench import scene

BUILDERS = types.SimpleNamespace(
    MeshData=MeshData, SceneBuilder=SceneBuilder,
    LightSetBuilder=LightSetBuilder, make_materials=make_materials,
    make_shade_context=make_shade_context)


def counters() -> dict:
    """{"<wrapper>.<attribute>": launches so far} of every kernel wrapper."""
    return {f"{owner.__name__}.{attr}": getattr(owner, attr)
            for owner, attr in launch_counters()}


class Program:
    """One cell's program on `device`.  call(index) issues a frame at
    staged camera `index` and returns its raw outputs; compared(out) the
    outputs the check compares; warm_calls the eager calls it makes before
    its first capture (on the card captures() tells)."""

    def __init__(self, cfg: dict, traffic: dict, inputs, device):
        self.cfg, self.device = cfg, device
        w, h = cfg["resolution"]
        geom, objects, lights, ctx = scene.build_with(BUILDERS, inputs, device)
        cam = cfg["camera"]
        staged = traffic["path"]["staged"]
        eyes = [scene.camera_eye(cfg, traffic, i) for i in range(staged)]
        self.cams = [make_camera(w, h, e, tuple(cam["target"]),
                                 fov=cam["fov"], zn=cam["zn"], zf=cam["zf"],
                                 device=device) for e in eyes]
        if cfg["program"] == "flagship_frame":
            f = dict(cfg["frame"])
            f["vis_crop"] = tuple(tuple(c) for c in f["vis_crop"])
            self.jitted = jit(make_flagship_frame(geom, objects, lights, ctx,
                                                  w, h, **f))
            self.args = [(c, dataclasses.replace(
                ctx, camera_pos=torch.as_tensor(e, dtype=torch.float32,
                                                device=device)))
                         for c, e in zip(self.cams, eyes)]
            self.warm_calls = 2
        elif cfg["program"] == "preset_pipeline":
            p = cfg["pipeline"]
            name = traffic["composition"]
            _, pipes = build_preset_pipelines(
                w, h, {name}, post=tuple(p["post"]), use_tiled=p["use_tiled"],
                local_map=p["local_map"], local_point=p["local_point"],
                shadow_filter=p["shadow_filter"], device=device,
                with_pipes=True)
            self.pipe, self.fp, _ = pipes[name]
            self.fp.pass_params.shadow = dataclasses.replace(
                self.fp.pass_params.shadow, map_size=p["sun_map"])
            lp = self.fp.pass_params.local_shadow
            if (tuple(lp.spot_ids), tuple(lp.point_ids)) != \
                    plan_shadow_casters(lights):
                raise RuntimeError("the composition's shadow casters are not "
                                   "those of the benchmark's light set")
            self.base = {"geom": geom, "objects": objects, "lights": lights,
                         "shade_ctx": ctx}
            self.rt_ctx = RenderContext()
            self.jitted = None
            # Sizing, then jit's warm-up; the first frame has no visibility
            # history, so the second frame is a key of its own.
            self.warm_calls = 4
        else:
            raise ValueError(f"unknown program {cfg['program']!r}")

    def call(self, index: int):
        if self.jitted is not None:
            return self.jitted(*self.args[index])
        return self.pipe.execute_jitted(
            self.rt_ctx, dict(self.base, camera=self.cams[index]), self.fp)

    def compared(self, out) -> dict:
        if self.jitted is not None:
            ldr, n_valid, _, max_lights, overflow = out
            return {"ldr": ldr, "n_valid": n_valid,
                    "max_lights_per_bin": max_lights,
                    "overflow_bins": overflow}
        return {"ldr": out["ldr"]}

    def captures(self) -> int:
        j = self.jitted if self.jitted is not None else self.pipe._jitted.jitted
        return j.captures


def load_library():
    """The port's kernel library, built into its checkout's build/kernels
    on the first run there; returns the build's seconds and whether it
    built."""
    from lsr_tpu_torch.utils.cuda_build import build_info

    load_kernels()
    return build_info["seconds"], build_info["built"]
