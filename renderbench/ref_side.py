"""The plain reference: each frame worked out again from the benchmark's
inputs by renderbench.reference, a frozen copy of the port's plain route
(torch ops on any device, no kernel, no capture), which imports nothing of
lsr_tpu_torch.

- "flagship_frame": the copy's make_flagship_frame, called eagerly.
- "preset_pipeline": the copy's composition through PluggablePipeline
  .execute.  The scene cull's visibility hysteresis carries the last
  frames' visibility: before frame k the copy's scene cull pass runs alone
  on the cameras of frames k - 4 .. k - 1 (an object seen in none of them
  is hidden after hold_frames = 4 whatever came before), so the reference
  follows no state of the program.

Every rasterize_direct and shade_fused call of a frame is recorded
(reference.raster.tiled.record, reference.lighting.shade_kernel.record)
for the kernels' bound counts.

The controls, the reference computed in a lower precision than the
configuration states (frame_outputs(control=...)):
- "tf32": every matmul and einsum of the copy takes its float32 operands
  rounded to TF32 (10 mantissa bits, to nearest even) and sums in
  float32, which is what a TF32 tensor-core product computes;
- "bf16_hdr": the HDR image rounded to bfloat16 before the tonemap, as
  a bfloat16 HDR target would hold it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import torch
from torch.overrides import TorchFunctionMode

from renderbench import scene
from renderbench.reference import frame as ref_frame
from renderbench.reference.io.obj import MeshData
from renderbench.reference.lighting import shade_kernel
from renderbench.reference.lighting.light_types import LightSetBuilder
from renderbench.reference.passes import tonemap
from renderbench.reference.pipeline.executor import RenderContext
from renderbench.reference.raster import tiled
from renderbench.reference.render_paths import build_preset_pipelines
from renderbench.reference.scene.scene import SceneBuilder, make_camera
from renderbench.reference.shading.common import make_materials
from renderbench.reference.shading.models import make_shade_context

BUILDERS = types.SimpleNamespace(
    MeshData=MeshData, SceneBuilder=SceneBuilder,
    LightSetBuilder=LightSetBuilder, make_materials=make_materials,
    make_shade_context=make_shade_context)

CONTROL_HDR = {"bf16_hdr": torch.bfloat16}
HOLD_FRAMES = 4      # the scene cull's hysteresis (CullingParams.hold_frames)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (8 exponent, 10 mantissa bits), to nearest
    with ties to even; other dtypes pass through."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = (b + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.einsum,
             torch.nn.functional.linear}


class TF32(TorchFunctionMode):
    """Rounds the float32 operands of every matrix product to TF32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(tf32_round(a) if isinstance(a, torch.Tensor) else
                         [tf32_round(t) for t in a]
                         if isinstance(a, (list, tuple)) else a
                         for a in args)
        return func(*args, **kwargs)


class Reference:
    """The cell's reference on `device`; frames(ordinals) works out the
    compared outputs of the program's frames with those ordinals."""

    def __init__(self, cfg: dict, traffic: dict, inputs, start: int,
                 device):
        self.cfg, self.traffic, self.start = cfg, traffic, start
        self.device = device
        w, h = cfg["resolution"]
        self.geom, self.objects, self.lights, self.ctx = scene.build_with(
            BUILDERS, inputs, device)
        if cfg["program"] == "flagship_frame":
            f = dict(cfg["frame"])
            f["vis_crop"] = tuple(tuple(c) for c in f["vis_crop"])
            self.frame = ref_frame.make_flagship_frame(
                self.geom, self.objects, self.lights, self.ctx, w, h, **f)
        else:
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
            self.frame = None

    def camera(self, ordinal: int):
        """(cam, eye) of the program's frame `ordinal`."""
        c = self.cfg["camera"]
        eye = scene.camera_eye(self.cfg, self.traffic,
                               scene.camera_of(self.traffic, self.start,
                                               ordinal))
        cam = make_camera(*self.cfg["resolution"], eye,
                          tuple(c["target"]), fov=c["fov"], zn=c["zn"],
                          zf=c["zf"], device=self.device)
        return cam, eye

    def _state(self, ordinal):
        return {"geom": self.geom, "objects": self.objects,
                "lights": self.lights, "shade_ctx": self.ctx,
                "camera": self.camera(ordinal)[0]}

    def _pipeline_frame(self, ordinal: int) -> dict:
        cull = self.pipe.find_pass("scene_cull")
        hist = None
        for k in range(max(0, ordinal - HOLD_FRAMES), ordinal):
            st = self._state(k)
            if hist is not None:
                st["vis_history"] = hist
            req = cull.build_execution_request(RenderContext(), st, self.fp)
            hist = cull.execute_resolved(RenderContext(), st, self.fp,
                                         req)["vis_history"]
        self.pipe.reset_history()
        if hist is not None:
            self.pipe._persistent_state = {"vis_history": hist}
        out = self.pipe.execute(RenderContext(), self._state(ordinal),
                                self.fp)
        return {"ldr": out["ldr"]}

    def _flagship(self, ordinal: int) -> dict:
        cam, eye = self.camera(ordinal)
        ctx_t = dataclasses.replace(
            self.ctx, camera_pos=torch.as_tensor(eye, dtype=torch.float32,
                                                 device=self.device))
        ldr, n_valid, _, max_lights, overflow = self.frame(cam, ctx_t)
        return {"ldr": ldr, "n_valid": n_valid,
                "max_lights_per_bin": max_lights, "overflow_bins": overflow}

    def frame_outputs(self, ordinal: int, control: str | None = None,
                      rasters: list | None = None,
                      shades: list | None = None) -> dict:
        """The compared outputs of frame `ordinal` (in a control's
        precision, given one); with rasters / shades, the frame's raster
        and shade calls are appended to them."""
        with contextlib.ExitStack() as stack:
            if rasters is not None:
                stack.enter_context(tiled.record(rasters))
            if shades is not None:
                stack.enter_context(shade_kernel.record(shades))
            if control == "tf32":
                stack.enter_context(TF32())
            elif control in CONTROL_HDR:
                stack.enter_context(tonemap.hdr_in(CONTROL_HDR[control]))
            elif control is not None:
                raise ValueError(f"unknown control {control!r}")
            with torch.no_grad():
                if self.frame is not None:
                    return self._flagship(ordinal)
                return self._pipeline_frame(ordinal)
