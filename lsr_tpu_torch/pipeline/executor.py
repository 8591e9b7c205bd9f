"""Runtime executor: run a validated plan with per-pass timing and gating
(port of lsr_tpu/pipeline/executor.py).

The analog of PipelineRuntimeExecutor (pluggable_pipeline.hpp:62-236):
- begin/end frame per backend group,
- for each pass: build_execution_request -> (gate) -> execute_resolved --
  an invalid request means the pass is SKIPPED and recorded, never executed
  (vop_core_tests.cpp:258),
- wall-clock per-pass timing recorded into the context debug stats: each
  pass a host span (utils.trace, recorded whether tracing is on or not).
  The card runs asynchronously, so that is the time to enqueue a pass
  unless `sync_timing` synchronizes the state's device after each pass
  (lsr_tpu blocks on the state's arrays there).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from lsr_tpu_torch.utils import trace


@dataclasses.dataclass
class DebugStats:
    """RenderDebugStats analog (core/context.hpp:29)."""

    pass_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    skipped_passes: List[str] = dataclasses.field(default_factory=list)
    frames: int = 0


@dataclasses.dataclass
class RenderContext:
    """Engine context (core/context.hpp:116 analog): debug stats + backends."""

    debug: DebugStats = dataclasses.field(default_factory=DebugStats)
    backends: dict = dataclasses.field(default_factory=dict)
    sync_timing: bool = False
    frame_index: int = 0


class IBackend:
    """Execution-target hooks (IRenderBackend analog, rhi/core/backend.hpp:47)."""

    name = "torch"

    def begin_frame(self, ctx):  # pragma: no cover - trivial
        pass

    def end_frame(self, ctx):  # pragma: no cover - trivial
        pass


class TorchBackend(IBackend):
    name = "torch"


def state_device(state: dict):
    """The device of the first tensor found in the frame state (a value, or
    a field of a dataclass value); None when it holds no tensor."""
    for v in state.values():
        if isinstance(v, torch.Tensor):
            return v.device
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                t = getattr(v, f.name)
                if isinstance(t, torch.Tensor):
                    return t.device
    return None


def synchronize(state: dict) -> None:
    """Wait for the card that holds the state's tensors (no-op on the
    CPU)."""
    dev = state_device(state)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def execute_plan(plan, passes, ctx, frame_state: dict, fp) -> dict:
    """Run the plan's groups/passes over frame_state; returns new frame_state."""
    if not plan.ok:
        raise RuntimeError(f"refusing to execute invalid plan: {plan.errors}")
    for group in plan.groups:
        backend = ctx.backends.get(group.backend)
        if backend is not None:
            backend.begin_frame(ctx)
        for idx in group.pass_indices:
            p = passes[idx]
            req = p.build_execution_request(ctx, frame_state, fp)
            if not req.valid:
                ctx.debug.skipped_passes.append(f"{p.pass_id}: {req.error}")
                continue
            with trace.recording(), trace.span(p.pass_id) as sp:
                frame_state = p.execute_resolved(ctx, frame_state, fp, req)
                if ctx.sync_timing:
                    synchronize(frame_state)
            ctx.debug.pass_ms[p.pass_id] = sp.host_ms
        if backend is not None:
            backend.end_frame(ctx)
    ctx.debug.frames += 1
    ctx.frame_index += 1
    return frame_state
