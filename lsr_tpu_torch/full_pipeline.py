"""Config #5, the full multi-pass frame, through the pass pipeline: the port
of demos/hello_full_pipeline.py:40-124 as functions.

A procedural sky with IBL baked from it (irradiance 8^2 from 128 samples,
prefiltered specular 16^2 from 64 samples, 4 mips, both from a 32^2 sky
cubemap), the sun shadow map, tiled deferred with the tile depth range
(kernel B2), motion vectors of a moving object, and the "full" post stack
(light shafts, motion blur, bloom, depth of field, TAA, FXAA), at 800x600 by
default.

The scene is the demo's: two monkeys (one moving: its prev_model differs),
a sphere, a textured ground plane and 48 point lights from default_rng(9).
The monkey mesh is not in the repository, so each monkey is a UV sphere
(rings 16, sectors 32) at the monkey's transform, as
frame.build_flagship_scene does for bench.py.  Everything lives on the card
unless the caller passes device="cpu".

    frame_fn, pipe, fp = build_full_pipeline(device="cpu")
    ldr = frame_fn(0)["ldr"]    # (600, 800, 3) uint8, row 0 at the bottom
"""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.frame import (
    FrameParams,
    LightCullingMode,
    TechniqueMode,
)
from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.io.obj import make_plane, make_uv_sphere
from lsr_tpu_torch.lighting.light_types import LightSetBuilder
from lsr_tpu_torch.passes.standard_passes import make_standard_registry
from lsr_tpu_torch.pipeline.executor import RenderContext
from lsr_tpu_torch.pipeline.pipeline import PluggablePipeline
from lsr_tpu_torch.pipeline.recipe import POST_STACK_PRESETS, RenderPathRecipe
from lsr_tpu_torch.resources.ibl import (
    compute_irradiance_map,
    compute_prefiltered_specular,
)
from lsr_tpu_torch.scene.scene import SceneBuilder, make_camera
from lsr_tpu_torch.shading.common import checkerboard_texture, make_materials
from lsr_tpu_torch.shading.models import make_shade_context
from lsr_tpu_torch.sky.sky_models import procedural_sky_cubemap

WIDTH, HEIGHT = 800, 600
SUN = (0.35, -0.7, 0.5)
EYE = (0.8, 1.6, -4.5)
MOVING = 0          # the object whose prev_model differs
SKY_SIZE = 32       # the sky cubemap the IBL is baked from
IRR_SIZE, IRR_SAMPLES = 8, 128
PREF_SIZE, PREF_SAMPLES, PREF_MIPS = 16, 64, 4


def bake_ibl(device=None):
    """(irradiance faces, (prefiltered mips...)) baked from the procedural
    sky with the demo's sun, at the demo's sizes, on `device`."""
    sky = procedural_sky_cubemap(SKY_SIZE, sun_dir_ws=SUN,
                                 device=resolve_device(device))
    irr = compute_irradiance_map(sky, out_size=IRR_SIZE, samples=IRR_SAMPLES)
    pref = tuple(compute_prefiltered_specular(
        sky, out_size=PREF_SIZE, samples=PREF_SAMPLES, mips=PREF_MIPS))
    return irr, pref


def full_scene(width: int = WIDTH, height: int = HEIGHT, ibl=None,
               device=None, mesh=None) -> dict:
    """The demo's frame state {"geom", "objects", "camera", "lights",
    "shade_ctx"} on `device`; ibl: the maps of bake_ibl (baked here when
    None); mesh: the monkey's mesh (default: the UV-sphere stand-in)."""
    device = resolve_device(device)
    monkey = make_uv_sphere(rings=16, sectors=32) if mesh is None else mesh
    sb = SceneBuilder()
    cur = (m3.translate([0.3, 0.3, 0.0]) @ m3.rotate_y(0.6)).numpy()
    prev = (m3.translate([-0.3, 0.3, 0.0]) @ m3.rotate_y(0.45)).numpy()
    sb.add(monkey, cur, material=0, prev_model=prev)
    sb.add(monkey, (m3.translate([-2.2, 0.3, 2.0])
                    @ m3.rotate_y(2.2)).numpy(), material=2)
    sb.add(make_uv_sphere(0.7), m3.translate([2.0, 0.0, 1.5]).numpy(),
           material=3)
    sb.add(make_plane(8.0, y=-0.9), material=1, casts_shadow=False)
    geom, objects = sb.build(device)
    cam = make_camera(width, height, EYE, (0, 0, 0.5), device=device)

    lb = LightSetBuilder()
    rng = np.random.default_rng(9)
    for _ in range(48):
        lb.point(tuple(rng.uniform([-4, 0.0, -3], [4, 2.2, 4]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.2, range=2.2)
    mats = make_materials(
        base_color=[(0.85, 0.55, 0.35), (0.55, 0.56, 0.6), (0.4, 0.6, 0.85),
                    (0.95, 0.9, 0.6)],
        metallic=[0.1, 0.0, 0.3, 0.9], roughness=[0.4, 0.7, 0.35, 0.2],
        tex_id=[-1, 0, -1, -1], device=device)
    ctx = make_shade_context(
        mats, light_dir_ws=SUN, light_color=(1.0, 0.96, 0.9),
        light_intensity=2.6, camera_pos=EYE,
        textures=torch.as_tensor(checkerboard_texture(128),
                                 device=device)[None],
        ibl=bake_ibl(device) if ibl is None else ibl, device=device)
    return {"geom": geom, "objects": objects, "camera": cam,
            "lights": lb.build(device), "shade_ctx": ctx}


def full_multipass_recipe() -> RenderPathRecipe:
    """The demo's recipe: sky, G-buffer, tiled light culling with the tile
    depth range, tiled deferred lighting, the "full" post stack; the sun
    shadow map ahead of them."""
    return RenderPathRecipe(
        name="full_multipass", technique=TechniqueMode.TILED_DEFERRED,
        light_culling=LightCullingMode.TILED_DEPTH_RANGE, shadows=True,
        pass_chain=("sky", "gbuffer", "light_culling",
                    "deferred_lighting_tiled"),
        post_stack=POST_STACK_PRESETS["full"])


def full_frame_params(width: int = WIDTH, height: int = HEIGHT,
                      taa: bool = False) -> FrameParams:
    """The demo's FrameParams: motion vectors, motion blur (strength 1.5),
    light shafts, depth of field (focus range 0.05), bloom, FXAA; TAA off
    for the demo's single still frame, on with taa (its history is carried
    from frame to frame)."""
    fp = FrameParams(width=width, height=height)
    fp.technique.mode = TechniqueMode.TILED_DEFERRED
    fp.technique.light_culling = LightCullingMode.TILED_DEPTH_RANGE
    fp.enable_motion_vectors = True
    fp.enable_motion_blur = True
    fp.enable_light_shafts = True
    fp.enable_dof = True
    fp.enable_bloom = True
    fp.enable_fxaa = True
    fp.enable_taa = taa
    fp.pass_params.dof.focus_range = 0.05
    fp.pass_params.motion_blur.strength = 1.5
    return fp


def build_full_pipeline(width: int = WIDTH, height: int = HEIGHT,
                        taa: bool = False, state=None, device=None):
    """(frame_fn, pipeline, fp): frame_fn(i) renders frame i of the demo's
    still camera through execute_jitted (the persistent keys, TAA's
    history among them, carried from call to call) and returns the frame's
    state, its LDR (H, W, 3) uint8 under "ldr".  state: a full_scene state
    to render (made here when None)."""
    device = resolve_device(device)
    state = full_scene(width, height, device=device) if state is None \
        else state
    fp = full_frame_params(width, height, taa)
    pipe = PluggablePipeline(preexisting_semantics=())
    rep = pipe.configure_from_recipe(full_multipass_recipe(),
                                     make_standard_registry())
    if not rep.ok:
        raise RuntimeError(f"full_multipass: {rep.errors}")
    plan = pipe.build_plan(fp)
    if not plan.ok:
        raise RuntimeError(f"full_multipass: {plan.errors}")
    rt_ctx = RenderContext()

    def frame_fn(i):
        return pipe.execute_jitted(rt_ctx, state, fp)

    return frame_fn, pipe, fp


def write_frame_png(path: str, ldr) -> None:
    """Writes an LDR frame of frame_fn as a PNG (row 0 at the top)."""
    from lsr_tpu_torch.io.png import write_png

    write_png(path, ldr.flip(0).cpu().numpy())
