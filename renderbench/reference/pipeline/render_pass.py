"""Render-pass protocol and execution value types (port of
lsr_tpu/pipeline/render_pass.py, unchanged but for the backend name).

A pass is a named, contract-carrying unit whose `execute` maps frame state
(a dict of named tensors and dataclasses) to new frame state; it never
mutates the dict it is given.  The two-phase split of the reference
renderer (pipeline/render_pass.hpp:265-310) -- `build_execution_request`
(pure validation, may reject) then `execute_resolved` (the only entry the
runtime may call) -- is kept, because it makes the planner and runtime
testable with fakes.

"Backends" are execution targets for validation and grouping: the default
live target is "torch" (the device the state's tensors live on); tests use
dummy backends to exercise planner rules without hardware.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class PassIO:
    """Declared reads/writes on named frame resources (render_pass.hpp:183).

    optional_reads order the pass after the resource's producer when one is
    in the chain but do NOT gate the execution request — the pass runs
    (without the input) when no producer exists (e.g. the lighting passes'
    ssao_mask modulation, present only in the classic+ssao composition)."""

    reads: tuple = ()
    writes: tuple = ()
    optional_reads: tuple = ()


@dataclasses.dataclass
class PassExecutionRequest:
    """Validated inputs for one pass execution (render_pass.hpp:60-88)."""

    pass_id: str
    valid: bool = True
    error: str = ""
    payload: Any = None


@dataclasses.dataclass
class PassExecutionResult:
    ok: bool = True
    error: str = ""
    stats: dict = dataclasses.field(default_factory=dict)


class RenderPass:
    """Base render pass.  Subclasses override describe_io / execute_resolved."""

    def __init__(
        self,
        pass_id: str,
        reads: Sequence[str] = (),
        writes: Sequence[str] = (),
        preferred_backend: str = "any",
        enabled: bool = True,
        fn: Optional[Callable] = None,
        contract=None,
        optional_reads: Sequence[str] = (),
    ):
        self.pass_id = pass_id
        self._io = PassIO(tuple(reads), tuple(writes),
                          tuple(optional_reads))
        self.preferred_backend = preferred_backend
        self.enabled = enabled
        self._fn = fn
        self._contract = contract

    # -- declarations ------------------------------------------------------
    def describe_io(self) -> PassIO:
        return self._io

    def describe_contract(self):
        return self._contract

    # -- two-phase execution (render_pass.hpp:282-302) ---------------------
    def build_execution_request(self, ctx, frame_state, fp) -> PassExecutionRequest:
        missing = [r for r in self._io.reads if r not in frame_state]
        if missing:
            return PassExecutionRequest(
                self.pass_id, valid=False,
                error=f"missing inputs: {missing}",
            )
        return PassExecutionRequest(self.pass_id, valid=True)

    def execute_resolved(self, ctx, frame_state: dict, fp, request) -> dict:
        """Pure: returns the new frame_state dict.  Never called with an
        invalid request (enforced by the runtime executor)."""
        if self._fn is None:
            return frame_state
        return self._fn(ctx, frame_state, fp)

    def on_resize(self, width: int, height: int) -> None:  # pragma: no cover
        pass

    def reset_history(self) -> None:  # pragma: no cover
        """Clear temporal state (TAA history etc.; render_pass.hpp:298)."""

    def __repr__(self):
        return f"<RenderPass {self.pass_id}>"


class LambdaPass(RenderPass):
    """Quick functional pass: fn(ctx, frame_state, fp) -> frame_state."""


# Standard pass ids (pass_id.hpp:19 — 16 standard passes + extras).
STANDARD_PASS_IDS = (
    "shadow_map",
    "depth_prepass",
    "light_culling",
    "cluster_build",
    "cluster_light_assign",
    "gbuffer",
    "ssao",
    "deferred_lighting",
    "deferred_lighting_tiled",
    "pbr_forward",
    "pbr_forward_plus",
    "pbr_forward_clustered",
    "tonemap",
    "light_shafts",
    "motion_blur",
    "depth_of_field",
    "taa",
    "fxaa",
    "bloom",
    "sky",
)
