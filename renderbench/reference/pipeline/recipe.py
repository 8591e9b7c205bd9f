"""Render-path recipes: data-first pipeline configuration + compiler
(port of lsr_tpu/pipeline/recipe.py, carried over as it is).

Mirrors the reference recipe system (render_path_recipe.hpp:106,
render_path_compiler.hpp:67-85, render_path_presets.hpp:26,
render_composition_presets.hpp:23): a recipe is a declarative description of
a render path (technique, culling, shadows, pass chain, knobs) which the
compiler validates/expands against a pass registry and capability set,
producing a report with errors/warnings.  Permissive mode downgrades
compile errors to warnings (the reference's permissive block).
"""

from __future__ import annotations

import dataclasses
from typing import List

from renderbench.reference.core.frame import LightCullingMode, TechniqueMode


@dataclasses.dataclass
class RenderPathCapabilitySet:
    """render_path_capabilities.hpp:17 analog."""

    shadows: bool = True
    occlusion_culling: bool = True
    light_culling: bool = True
    compute_heavy_post: bool = True


@dataclasses.dataclass
class RenderPathRecipe:
    name: str
    technique: TechniqueMode = TechniqueMode.FORWARD
    backend: str = "torch"
    light_culling: LightCullingMode = LightCullingMode.NONE
    shadows: bool = False
    local_shadows: bool = False  # budgeted local shadow atlas (flagship
                                 # workload, hello_rendering_paths.cpp:104-109)
    occlusion_culling: bool = False
    frustum_culling: bool = True
    per_frame_culling: bool = False  # scene_cull pass in the chain (frustum
                                 # + occlusion proxy + hysteresis per frame,
                                 # hello_rendering_paths.cpp:94-97/:8360)
    pass_chain: tuple = ()
    tile_size: int = 16
    max_lights_per_tile: int = 128
    cluster_slices: int = 16
    post_stack: tuple = ()  # extra post passes appended before tonemap/fxaa


@dataclasses.dataclass
class RecipeCompileReport:
    passes: List[str] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self):
        return not self.errors


_TECHNIQUE_LIGHTING = {
    TechniqueMode.FORWARD: ("pbr_forward",),
    TechniqueMode.FORWARD_PLUS: ("light_culling", "pbr_forward_plus"),
    TechniqueMode.DEFERRED: ("gbuffer", "deferred_lighting"),
    TechniqueMode.TILED_DEFERRED: ("gbuffer", "light_culling",
                                   "deferred_lighting_tiled"),
    TechniqueMode.CLUSTERED_FORWARD: ("cluster_build", "cluster_light_assign",
                                      "pbr_forward_clustered"),
}


def default_pass_chain(technique: TechniqueMode) -> tuple:
    """make_default_technique_profile analog (technique_profile.hpp:42)."""
    return _TECHNIQUE_LIGHTING[technique] + ("tonemap",)


def compile_recipe(
    recipe: RenderPathRecipe,
    registry,
    caps: RenderPathCapabilitySet | None = None,
    permissive: bool = False,
    duplicate_policy: str = "error",   # "error" | "drop" | "allow"
    unknown_policy: str = "error",     # "error" | "drop"
) -> RecipeCompileReport:
    """Expand + validate a recipe into an ordered pass-id list."""
    caps = caps or RenderPathCapabilitySet()
    report = RecipeCompileReport()

    def problem(msg):
        if permissive:
            report.warnings.append(f"(downgraded) {msg}")
        else:
            report.errors.append(msg)

    chain = list(recipe.pass_chain) or list(
        _TECHNIQUE_LIGHTING[recipe.technique]
    )

    # Rule: shadows => a shadow_map pass must precede lighting
    # (render_path_compiler.hpp rules).
    if recipe.shadows:
        if not caps.shadows:
            problem(f"{recipe.name}: shadows requested but capability missing")
        if "shadow_map" not in chain:
            chain.insert(0, "shadow_map")
        # Rule: local shadow atlas right after the sun map (the flagship
        # records sun + local maps together, record_shadow_passes :6912).
        if recipe.local_shadows and "local_shadows" not in chain:
            chain.insert(chain.index("shadow_map") + 1, "local_shadows")

    # Rule: occlusion culling => depth prepass.
    if recipe.occlusion_culling:
        if not caps.occlusion_culling:
            problem(f"{recipe.name}: occlusion requested but capability missing")
        if "depth_prepass" not in chain:
            insert_at = 1 if chain and chain[0] == "shadow_map" else 0
            chain.insert(insert_at, "depth_prepass")

    # Rule: per-frame culling => a scene_cull pass leads the chain (cull
    # before shadows/raster, draw_frame :8360 order).
    if recipe.per_frame_culling:
        if recipe.occlusion_culling and not caps.occlusion_culling:
            problem(f"{recipe.name}: occlusion requested but capability missing")
        if "scene_cull" not in chain:
            chain.insert(0, "scene_cull")

    # Rule: a light-culling mode needs the light culling capability.
    if recipe.light_culling != LightCullingMode.NONE and not caps.light_culling:
        problem(f"{recipe.name}: light culling requested but capability missing")

    # Post stack + resolve.
    for p in recipe.post_stack:
        chain.append(p)
    if "tonemap" not in chain:
        chain.append("tonemap")
    # LDR-space post must come after tonemap.
    if "fxaa" in chain:
        chain.remove("fxaa")
        chain.append("fxaa")

    # Unknown / duplicate policies.
    out = []
    seen = set()
    for pid in chain:
        if not registry.known(pid):
            if unknown_policy == "drop":
                report.warnings.append(f"{recipe.name}: dropping unknown pass '{pid}'")
                continue
            problem(f"{recipe.name}: unknown pass '{pid}'")
            continue
        if pid in seen:
            if duplicate_policy == "drop":
                report.warnings.append(f"{recipe.name}: dropping duplicate '{pid}'")
                continue
            if duplicate_policy == "error":
                problem(f"{recipe.name}: duplicate pass '{pid}'")
                continue
        desc = registry.descriptor(pid)
        if desc is not None:
            if not desc.supports_mode(recipe.technique):
                problem(
                    f"{recipe.name}: pass '{pid}' does not support technique "
                    f"{recipe.technique.name}"
                )
                continue
            if not desc.supports_backend(recipe.backend):
                problem(
                    f"{recipe.name}: pass '{pid}' does not support backend "
                    f"{recipe.backend}"
                )
                continue
        seen.add(pid)
        out.append(pid)

    report.passes = out
    return report


# ---------------------------------------------------------------------------
# Presets (render_path_presets.hpp:26, render_composition_presets.hpp:23-170)
# ---------------------------------------------------------------------------

def builtin_render_path_presets() -> List[RenderPathRecipe]:
    """The 5 flagship render paths (render_path_presets.hpp:26), each with
    the flagship's full per-frame workload: scene+light culling (frustum +
    occlusion proxy) and the budgeted local shadow atlas on top of the sun
    map (hello_rendering_paths.cpp:94-109)."""
    common = dict(shadows=True, local_shadows=True, per_frame_culling=True,
                  occlusion_culling=True)
    return [
        RenderPathRecipe(
            name="forward_classic",
            technique=TechniqueMode.FORWARD,
            **common,
        ),
        RenderPathRecipe(
            name="forward_plus",
            technique=TechniqueMode.FORWARD_PLUS,
            light_culling=LightCullingMode.TILED,
            **common,
        ),
        RenderPathRecipe(
            name="deferred",
            technique=TechniqueMode.DEFERRED,
            **common,
        ),
        RenderPathRecipe(
            name="tiled_deferred",
            technique=TechniqueMode.TILED_DEFERRED,
            light_culling=LightCullingMode.TILED_DEPTH_RANGE,
            **common,
        ),
        RenderPathRecipe(
            name="clustered_forward",
            technique=TechniqueMode.CLUSTERED_FORWARD,
            light_culling=LightCullingMode.CLUSTERED,
            **common,
        ),
    ]


def ssao_composition_recipe() -> RenderPathRecipe:
    """The classic-forward + SSAO composition: the reference's
    demo_forward_classic_renderpath registers ssao_forward as a CUSTOM pass
    in its classic path (demo_forward_classic_renderpath.cpp:113-114,
    ssao_frames accounting :328).  SSAO runs depth-only off the prepass
    (occlusion_culling inserts depth_prepass ahead of it); the lighting
    pass modulates ambient by the mask (standard_passes._LightingBase)."""
    return RenderPathRecipe(
        name="forward_classic+ssao",
        technique=TechniqueMode.FORWARD,
        pass_chain=("ssao", "pbr_forward"),
        shadows=True, local_shadows=True, per_frame_culling=True,
        occlusion_culling=True,
    )


POST_STACK_PRESETS = {
    "minimal": (),
    "default": ("bloom",),
    "temporal": ("taa",),
    "full": ("light_shafts", "motion_blur", "bloom", "depth_of_field", "taa",
             "fxaa"),
}
