"""Pass contracts: semantic produce/consume declarations + validation
(port of lsr_tpu/pipeline/contracts.py, carried over as it is).

The analog of pass_contract.hpp:34-356 and pass_contract_registry.hpp:22-262:
each standard pass declares which *semantics* it produces/consumes, with a
representation (space/encoding) and a technique-mode support mask, so the
planner can validate a pass chain *before* executing anything.
"""

from __future__ import annotations

import dataclasses

from renderbench.reference.core.frame import TechniqueMode

# The 15 standard semantics (pass_contract.hpp:34) as lsr_tpu adapted them,
# plus two extensions for subsystems the reference wires outside its contract
# system (the flagship's per-frame culling results and local shadow atlas,
# hello_rendering_paths.cpp:94-109 — passed as demo-level state there).
SEMANTICS = (
    "scene_color_hdr",
    "scene_color_ldr",
    "scene_depth",
    "velocity",
    "shadow_map",
    "gbuffer_worldpos",
    "gbuffer_normal",
    "gbuffer_material",
    "light_grid",
    "cluster_grid",
    "ssao_mask",
    "history_color",
    "sky_color",
    "luma",
    "debug_overlay",
    "visibility",
    "local_shadow_atlas",
)

# Default representation per semantic (pass_contract.hpp:218).
DEFAULT_SPACE = {
    "scene_color_hdr": "linear_f32",
    "scene_color_ldr": "srgb_u8",
    "scene_depth": "depth01",
    "velocity": "pixels_f32",
    "shadow_map": "depth01",
    "gbuffer_worldpos": "world_f32",
    "gbuffer_normal": "unit_f32",
    "gbuffer_material": "params_f32",
    "light_grid": "indices_i32",
    "cluster_grid": "indices_i32",
    "ssao_mask": "scalar01",
    "history_color": "linear_f32",
    "sky_color": "linear_f32",
    "luma": "scalar01",
    "debug_overlay": "linear_f32",
    "visibility": "mask_bool",
    "local_shadow_atlas": "depth01",
}


@dataclasses.dataclass(frozen=True)
class SemanticRef:
    semantic: str
    space: str = ""           # "" = default for the semantic
    lifetime: str = "frame"   # "frame" | "persistent"
    temporal: str = "current" # "current" | "history"

    def resolved_space(self) -> str:
        return self.space or DEFAULT_SPACE.get(self.semantic, "linear_f32")


@dataclasses.dataclass(frozen=True)
class PassContract:
    role: str
    modes: TechniqueMode = TechniqueMode.ALL
    produces: tuple = ()
    consumes: tuple = ()


def _ref(sem, **kw):
    return SemanticRef(sem, **kw)


# Contract registry for the standard passes (pass_contract_registry.hpp:22-262).
STANDARD_CONTRACTS = {
    "scene_cull": PassContract(
        role="culling", produces=(_ref("visibility"),),
    ),
    "shadow_map": PassContract(
        role="shadow", produces=(_ref("shadow_map"),),
    ),
    "local_shadows": PassContract(
        role="shadow", produces=(_ref("local_shadow_atlas"),),
    ),
    "depth_prepass": PassContract(
        role="depth", produces=(_ref("scene_depth"),),
    ),
    "light_culling": PassContract(
        role="light_bin",
        modes=TechniqueMode.FORWARD_PLUS | TechniqueMode.TILED_DEFERRED,
        produces=(_ref("light_grid"),),
    ),
    "cluster_build": PassContract(
        role="light_bin",
        modes=TechniqueMode.CLUSTERED_FORWARD,
        produces=(_ref("cluster_grid"),),
    ),
    "cluster_light_assign": PassContract(
        role="light_bin",
        modes=TechniqueMode.CLUSTERED_FORWARD,
        consumes=(_ref("cluster_grid"),),
        produces=(_ref("cluster_grid"),),
    ),
    "gbuffer": PassContract(
        role="geometry",
        modes=TechniqueMode.DEFERRED | TechniqueMode.TILED_DEFERRED,
        produces=(
            _ref("gbuffer_worldpos"),
            _ref("gbuffer_normal"),
            _ref("gbuffer_material"),
            _ref("scene_depth"),
            _ref("velocity"),
        ),
    ),
    "ssao": PassContract(
        role="post_geometry",
        # Depth-only AO (fp_stress_ssao.comp's depth term; the normal
        # reconstruction is not used by this implementation).
        consumes=(_ref("scene_depth"),),
        produces=(_ref("ssao_mask"),),
    ),
    "deferred_lighting": PassContract(
        role="lighting",
        modes=TechniqueMode.DEFERRED,
        consumes=(
            _ref("gbuffer_worldpos"),
            _ref("gbuffer_normal"),
            _ref("gbuffer_material"),
        ),
        produces=(_ref("scene_color_hdr"),),
    ),
    "deferred_lighting_tiled": PassContract(
        role="lighting",
        modes=TechniqueMode.TILED_DEFERRED,
        consumes=(
            _ref("gbuffer_worldpos"),
            _ref("gbuffer_normal"),
            _ref("gbuffer_material"),
            _ref("light_grid"),
        ),
        produces=(_ref("scene_color_hdr"),),
    ),
    "pbr_forward": PassContract(
        role="lighting",
        modes=TechniqueMode.FORWARD,
        produces=(_ref("scene_color_hdr"), _ref("scene_depth"), _ref("velocity")),
    ),
    "pbr_forward_plus": PassContract(
        role="lighting",
        modes=TechniqueMode.FORWARD_PLUS,
        consumes=(_ref("light_grid"),),
        produces=(_ref("scene_color_hdr"), _ref("scene_depth"), _ref("velocity")),
    ),
    "pbr_forward_clustered": PassContract(
        role="lighting",
        modes=TechniqueMode.CLUSTERED_FORWARD,
        consumes=(_ref("cluster_grid"),),
        produces=(_ref("scene_color_hdr"), _ref("scene_depth"), _ref("velocity")),
    ),
    "sky": PassContract(
        role="background", produces=(_ref("sky_color"),),
    ),
    "light_shafts": PassContract(
        role="post",
        consumes=(_ref("scene_color_hdr"), _ref("scene_depth")),
        produces=(_ref("scene_color_hdr"),),
    ),
    "motion_blur": PassContract(
        role="post",
        consumes=(_ref("scene_color_hdr"), _ref("velocity"), _ref("scene_depth")),
        produces=(_ref("scene_color_hdr"),),
    ),
    "depth_of_field": PassContract(
        role="post",
        consumes=(_ref("scene_color_hdr"), _ref("scene_depth")),
        produces=(_ref("scene_color_hdr"),),
    ),
    "bloom": PassContract(
        role="post",
        consumes=(_ref("scene_color_hdr"),),
        produces=(_ref("scene_color_hdr"),),
    ),
    "taa": PassContract(
        role="post",
        consumes=(
            _ref("scene_color_hdr"),
            _ref("velocity"),
            _ref("history_color", temporal="history", lifetime="persistent"),
        ),
        produces=(
            _ref("scene_color_hdr"),
            _ref("history_color", lifetime="persistent"),
        ),
    ),
    "tonemap": PassContract(
        role="resolve",
        consumes=(_ref("scene_color_hdr"),),
        produces=(_ref("scene_color_ldr"),),
    ),
    "fxaa": PassContract(
        role="post_ldr",
        consumes=(_ref("scene_color_ldr"),),
        produces=(_ref("scene_color_ldr"),),
    ),
}


@dataclasses.dataclass
class ContractReport:
    errors: list = dataclasses.field(default_factory=list)
    warnings: list = dataclasses.field(default_factory=list)

    @property
    def ok(self):
        return not self.errors


def validate_contracts(ordered_passes, mode: TechniqueMode,
                       preexisting=()) -> ContractReport:
    """Semantic produce/consume + representation + mode validation
    (the planner checks of pluggable_pipeline.hpp:506-628)."""
    report = ContractReport()
    produced: dict = {s: "preexisting" for s in preexisting}
    produced_space: dict = {}

    for p in ordered_passes:
        c = p.describe_contract()
        if c is None:
            report.warnings.append(f"{p.pass_id}: no contract declared")
            continue
        if not (c.modes & mode):
            report.errors.append(
                f"{p.pass_id}: not supported in technique mode {mode.name}"
            )
            continue
        for ref in c.consumes:
            if ref.temporal == "history":
                continue  # history reads resolve to the previous frame
            if ref.semantic not in produced:
                report.errors.append(
                    f"{p.pass_id}: consumes '{ref.semantic}' which no earlier "
                    f"pass produces"
                )
            else:
                want = ref.resolved_space()
                have = produced_space.get(ref.semantic, want)
                if want != have:
                    report.errors.append(
                        f"{p.pass_id}: representation mismatch on "
                        f"'{ref.semantic}': wants {want}, produced as {have}"
                    )
        for ref in c.produces:
            produced[ref.semantic] = p.pass_id
            produced_space[ref.semantic] = ref.resolved_space()
    return report
