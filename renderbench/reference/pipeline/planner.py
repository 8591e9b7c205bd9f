"""Execution planner: validate pass chains and group them by backend
(port of lsr_tpu/pipeline/planner.py, carried over as it is).

The analog of PipelineExecutionPlanner (pluggable_pipeline.hpp:242-349):
- filter passes by technique mode (via contracts),
- select a backend per pass (preferred -> fallback, capability-checked),
- group consecutive same-backend passes into submission groups,
- run semantic contract validation over the frame-graph order,
- emit a value report (errors/warnings) — planning itself never executes.

The planner deliberately ignores runtime context flags (vop_core_tests.cpp:320):
it is a pure function of the declared pass properties + frame params.
"""

from __future__ import annotations

import dataclasses
from typing import List

from renderbench.reference.pipeline.contracts import validate_contracts
from renderbench.reference.pipeline.frame_graph import compile_frame_graph


@dataclasses.dataclass
class BackendCaps:
    """Capability flags of an execution target (rhi capabilities analog)."""

    name: str
    available: bool = True
    supports_compute_heavy: bool = True


@dataclasses.dataclass
class BackendGroup:
    backend: str
    pass_indices: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ExecutionPlan:
    groups: List[BackendGroup] = dataclasses.field(default_factory=list)
    order: List[int] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def build_execution_plan(
    passes,
    fp,
    backends: dict | None = None,
    default_backend: str = "torch",
    preexisting_semantics=("scene_depth",),
    allow_cross_backend: bool = True,
) -> ExecutionPlan:
    """Pure planning over pass declarations.  `backends` maps name -> BackendCaps."""
    plan = ExecutionPlan()
    if backends is None:
        backends = {default_backend: BackendCaps(default_backend)}

    graph = compile_frame_graph(passes)
    plan.errors.extend(graph.errors)
    plan.warnings.extend(graph.warnings)
    plan.order = graph.order

    ordered = [passes[i] for i in graph.order]
    contract_report = validate_contracts(
        ordered, fp.technique.mode, preexisting=preexisting_semantics
    )
    plan.errors.extend(contract_report.errors)
    plan.warnings.extend(contract_report.warnings)

    # Backend selection with fallback (pluggable_pipeline.hpp:680).
    chosen: List[str] = []
    for idx in graph.order:
        p = passes[idx]
        want = p.preferred_backend
        if want in ("any", ""):
            want = default_backend
        caps = backends.get(want)
        if caps is None or not caps.available:
            fallback = default_backend
            if want != fallback and fallback in backends and backends[fallback].available:
                plan.warnings.append(
                    f"{p.pass_id}: backend '{want}' unavailable, falling back "
                    f"to '{fallback}'"
                )
                want = fallback
            else:
                plan.errors.append(
                    f"{p.pass_id}: no available backend (wanted '{want}')"
                )
                want = default_backend
        chosen.append(want)

    # Cross-backend data flow check (frame_graph.hpp:120-141 warning analog).
    if not allow_cross_backend:
        for a, b in graph.edges:
            ia = graph.order.index(a) if a in graph.order else None
            ib = graph.order.index(b) if b in graph.order else None
            if ia is None or ib is None:
                continue
            if chosen[ia] != chosen[ib]:
                plan.errors.append(
                    f"cross-backend edge {passes[a].pass_id}->{passes[b].pass_id} "
                    f"blocked ({chosen[ia]} -> {chosen[ib]})"
                )

    # Group consecutive same-backend passes (pluggable_pipeline.hpp:349).
    for pos, idx in enumerate(graph.order):
        be = chosen[pos]
        if plan.groups and plan.groups[-1].backend == be:
            plan.groups[-1].pass_indices.append(idx)
        else:
            plan.groups.append(BackendGroup(backend=be, pass_indices=[idx]))

    return plan
