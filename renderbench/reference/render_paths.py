"""The render-path presets through the pass pipeline: the port of
scripts/run_phases.py's scene_state (:51-92), _staged_camera, _MODE_FOR and
build_preset_pipelines (:131-230), as frame.py ports bench.py's frame.

build_preset_pipelines compiles and plans each of lsr_tpu's five presets
(forward_classic, forward_plus, deferred, tiled_deferred,
clustered_forward; pipeline/recipe.py) and the forward_classic+ssao
composition, each with the flagship workload: scene_cull (frustum, the
320x180 occluder proxy, hysteresis), the sun shadow map, the budgeted local
shadow atlas (8 spots + 2 points, one kernel B1 launch a slot) and a depth
prepass, lit by kernel B2 in the technique's mode (clustered_forward takes
its clustered-slice branch, B2b).  The SSAO composition lights through the
general branch (the SSAO mask sends it there, as in lsr_tpu): the sun by
the shading model and the binned local lights by accumulate_local_lights,
no B2.  build_forward_plus_full gives forward_plus under the "full" post
stack (POST_STACK_PRESETS, run_phases.py:383-393).

The scene is scene_state's: two objects, the ground plane, 48 lights (8
spots and 2 points first, seed 4), three materials and the camera.  The
monkey mesh of lsr_tpu's scene is not in the repository, so each monkey is
a UV sphere (rings 16, sectors 32) at the monkey's transform, as
frame.build_flagship_scene does for bench.py.  Everything lives on the card
unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses

import numpy as np

from renderbench.reference.core import math3d as m3
from renderbench.reference.core.frame import FrameParams, TechniqueMode
from renderbench.reference.core.util import resolve_device
from renderbench.reference.io.obj import make_plane, make_uv_sphere
from renderbench.reference.lighting.light_types import LightSetBuilder
from renderbench.reference.lighting.local_shadows import (
    default_vis_crop,
    plan_shadow_casters,
)
from renderbench.reference.passes.standard_passes import make_standard_registry
from renderbench.reference.pipeline.executor import RenderContext
from renderbench.reference.pipeline.pipeline import PluggablePipeline
from renderbench.reference.pipeline.recipe import (  # noqa: F401 (re-exported)
    POST_STACK_PRESETS,
    builtin_render_path_presets,
    ssao_composition_recipe,
)
from renderbench.reference.scene.scene import SceneBuilder, make_camera
from renderbench.reference.shading.common import make_materials
from renderbench.reference.shading.models import make_shade_context

EYE = (0.6, 1.6, -4.5)
STAGED_N = 360          # cameras of the staged orbit, cycled

MODE_FOR = {
    "forward_classic": "FORWARD",
    "forward_classic+ssao": "FORWARD",
    "forward_plus": "FORWARD_PLUS",
    "deferred": "DEFERRED",
    "tiled_deferred": "TILED_DEFERRED",
    "clustered_forward": "CLUSTERED_FORWARD",
}


def scene_state(width: int, height: int, n_lights: int = 48, seed: int = 4,
                device=None) -> dict:
    """The presets' frame state: {"geom", "objects", "camera", "lights",
    "shade_ctx"} on `device` (default: the card)."""
    device = resolve_device(device)
    sphere = make_uv_sphere(rings=16, sectors=32)
    sb = SceneBuilder()
    sb.add(sphere, (m3.translate([0, 0.2, 0]) @ m3.rotate_y(0.5)).numpy())
    sb.add(sphere, (m3.translate([-2.0, 0.2, 1.5])
                    @ m3.rotate_y(2.0)).numpy(), material=1)
    sb.add(make_plane(6.0, y=-1.0), material=2, casts_shadow=False)
    geom, objects = sb.build(device)
    cam = make_camera(width, height, EYE, (0, 0, 0), device=device)

    lb = LightSetBuilder()
    rng = np.random.default_rng(seed)
    # The budgeted shadow casters first: 8 spots + 2 points get maps.
    for _ in range(8):
        p = rng.uniform([-3, 2.0, -3], [3, 3.2, 3])
        lb.spot(tuple(p.tolist()), (0, -1, 0),
                color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                intensity=2.0, range=4.5, inner_angle=0.4, outer_angle=0.7)
    for _ in range(2):
        lb.point(tuple(rng.uniform([-2, 0.8, -2], [2, 1.6, 2]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.6, range=3.5)
    for _ in range(max(0, n_lights - 10)):
        lb.point(tuple(rng.uniform([-3, 0.2, -3], [3, 2, 3]).tolist()),
                 color=tuple(rng.uniform(0.3, 1.0, 3).tolist()),
                 intensity=1.4, range=2.4)
    mats = make_materials(
        base_color=[(0.85, 0.5, 0.3), (0.4, 0.65, 0.85), (0.55, 0.56, 0.6)],
        roughness=[0.4, 0.3, 0.8], metallic=[0.05, 0.4, 0.0], device=device)
    ctx = make_shade_context(mats, light_dir_ws=(0.35, -0.7, 0.5),
                             camera_pos=EYE, light_intensity=2.2,
                             device=device)
    return {"geom": geom, "objects": objects, "camera": cam,
            "lights": lb.build(device), "shade_ctx": ctx}


def orbit_camera(width: int, height: int, i: int, device=None):
    """Camera of frame i of the presets' orbit (cycled modulo STAGED_N)."""
    a = 0.03 * float(i % STAGED_N)
    return make_camera(width, height, (0.6 + 0.2 * np.sin(a), 1.6, -4.5),
                       (0, 0, 0), device=device)


def preset_frame_params(preset, width: int, height: int, post=("fxaa",),
                        use_tiled: bool = True, local_map: int = 1024,
                        local_point: int = 512, shadow_filter: str = "pcf",
                        casters=((), ())) -> FrameParams:
    """The FrameParams build_preset_pipelines gives a preset recipe: its
    technique and light culling, the post flags, the raster route, the
    local atlas of the given casters and sizes; "esm" halves the atlas
    sizes, takes the 1024^2 ESM sun map and samples both visibilities at
    half resolution (run_phases.py:162-200)."""
    esm = shadow_filter == "esm"
    if esm:
        local_map, local_point = local_map // 2, local_point // 2
    fp = FrameParams(width=width, height=height)
    fp.technique.mode = TechniqueMode[MODE_FOR[preset.name]]
    fp.technique.light_culling = preset.light_culling
    fp.enable_fxaa = "fxaa" in post
    fp.enable_bloom = "bloom" in post
    fp.enable_taa = "taa" in post
    fp.enable_motion_blur = "motion_blur" in post
    fp.enable_light_shafts = "light_shafts" in post
    fp.enable_dof = "depth_of_field" in post
    fp.enable_motion_vectors = ("taa" in post) or ("motion_blur" in post)
    fp.use_tiled_raster = use_tiled
    fp.pass_params.local_shadow = dataclasses.replace(
        fp.pass_params.local_shadow, spot_ids=casters[0],
        point_ids=casters[1], map_size=local_map, point_size=local_point,
        vis_crop=default_vis_crop(height, width), filter_mode=shadow_filter,
        **({"vis_scale": 2} if esm else {}))
    if esm:
        fp.pass_params.shadow = dataclasses.replace(
            fp.pass_params.shadow, map_size=1024, filter_mode="esm",
            sun_vis_scale=2)
    return fp


def build_preset_pipelines(width: int, height: int, presets=None,
                           post=("fxaa",), use_tiled: bool = True,
                           local_map: int = 1024, local_point: int = 512,
                           shadow_filter: str = "pcf", device=None,
                           with_pipes: bool = False):
    """{preset name: frame_fn(i) -> ldr (H, W, 3) uint8} through the
    pipeline, for lsr_tpu's five presets and the forward_classic+ssao
    composition (presets: a set of names to keep).  frame_fn runs
    execute_jitted on scene_state with orbit camera i.  post: the post
    stack appended before tonemap; use_tiled=False rasterizes the camera
    with rasterize_brute (Phase I's parity backend); local_map /
    local_point: spot slot and cube face size; shadow_filter "pcf" (the
    exact filter; sun 2048^2 by default) or "esm".  with_pipes also returns
    {name: (pipeline, fp, state_fn)}."""
    device = resolve_device(device)
    base_state = scene_state(width, height, device=device)
    casters = plan_shadow_casters(base_state["lights"])
    cams: dict = {}

    def state_fn(i):
        # The orbit's cameras are built once each and shared by the presets.
        k = i % STAGED_N
        if k not in cams:
            cams[k] = orbit_camera(width, height, k, device)
        state = dict(base_state)
        state["camera"] = cams[k]
        return state

    out, pipes = {}, {}
    for preset in builtin_render_path_presets() + [ssao_composition_recipe()]:
        if presets and preset.name not in presets:
            continue
        recipe = dataclasses.replace(preset, post_stack=tuple(post))
        fp = preset_frame_params(preset, width, height, post, use_tiled,
                                 local_map, local_point, shadow_filter,
                                 casters)
        pipe = PluggablePipeline(preexisting_semantics=())
        rep = pipe.configure_from_recipe(recipe, make_standard_registry())
        if not rep.ok:
            raise RuntimeError(f"{preset.name}: {rep.errors}")
        plan = pipe.build_plan(fp)
        if not plan.ok:
            raise RuntimeError(f"{preset.name}: {plan.errors}")
        rt_ctx = RenderContext()

        def frame_fn(i, pipe=pipe, fp=fp, rt_ctx=rt_ctx):
            return pipe.execute_jitted(rt_ctx, state_fn(i), fp)["ldr"]

        out[preset.name] = frame_fn
        pipes[preset.name] = (pipe, fp, state_fn)
    if with_pipes:
        return out, pipes
    return out


def build_forward_plus_full(width: int, height: int, with_pipes: bool = False,
                            **kw):
    """The "forward_plus+full" composition of Phase F
    (run_phases.py:383-393): the forward_plus preset under
    POST_STACK_PRESETS["full"] (light shafts, motion blur, bloom, depth of
    field, TAA, FXAA), with motion vectors.  kw: build_preset_pipelines'
    other arguments.  Returns {"forward_plus+full": frame_fn} (and the
    pipes, as build_preset_pipelines)."""
    fns, pipes = build_preset_pipelines(
        width, height, {"forward_plus"}, post=POST_STACK_PRESETS["full"],
        with_pipes=True, **kw)
    name = "forward_plus+full"
    out = {name: fns["forward_plus"]}
    if with_pipes:
        return out, {name: pipes["forward_plus"]}
    return out
