"""PluggablePipeline: pass container + plan + execute (port of
lsr_tpu/pipeline/pipeline.py).

The analog of PluggablePipeline (pluggable_pipeline.hpp:743-1000): holds the
pass list, lazily rebuilds the frame graph + execution plan when the pass set
changes, exposes graph/plan reports, and executes through the runtime
executor.  Temporal state reset hooks mirror reset_history/on_scene_reset
(pluggable_pipeline.hpp:960-978).

The three ways to execute give the same frame bit for bit and differ in
how they run it: execute() times each pass on the host (the device with
ctx.sync_timing), execute_segmented() times each pass on the device by CUDA
events, both eagerly; execute_jitted() is lsr_tpu's one compiled program:
the whole plan through utils.jit with checked capacities
(utils.capacity), captured once into a CUDA graph and replayed on the
card (run eagerly for a state on the CPU).
"""

from __future__ import annotations

from typing import List, Optional

from lsr_tpu_torch.pipeline.executor import (
    RenderContext,
    TorchBackend,
    execute_plan,
    synchronize,
)
from lsr_tpu_torch.pipeline.planner import BackendCaps, build_execution_plan
from lsr_tpu_torch.pipeline.recipe import compile_recipe
from lsr_tpu_torch.pipeline.render_pass import RenderPass
from lsr_tpu_torch.utils import trace
from lsr_tpu_torch.utils.capacity import checked


class PluggablePipeline:
    def __init__(self, backends: Optional[dict] = None,
                 default_backend: str = "torch",
                 preexisting_semantics=("scene_depth",)):
        self._passes: List[RenderPass] = []
        self._plan = None
        self._dirty = True
        self._persistent_state: dict = {}
        self._default_backend = default_backend
        self._preexisting = tuple(preexisting_semantics)
        self.backend_caps = backends or {
            default_backend: BackendCaps(default_backend)
        }
        self.backend_impls = {default_backend: TorchBackend()}
        self._jit_key = None
        self._jitted = None

    # -- pass management ----------------------------------------------------
    def add_pass(self, p: RenderPass):
        self._passes.append(p)
        self._dirty = True
        return self

    def find_pass(self, pass_id: str) -> Optional[RenderPass]:
        for p in self._passes:
            if p.pass_id == pass_id:
                return p
        return None

    def set_enabled(self, pass_id: str, enabled: bool) -> bool:
        p = self.find_pass(pass_id)
        if p is None:
            return False
        if p.enabled != enabled:
            p.enabled = enabled
            self._dirty = True
        return True

    def clear(self):
        self._passes.clear()
        self._dirty = True

    @property
    def passes(self):
        return tuple(self._passes)

    # -- configuration from recipes ------------------------------------------
    def configure_from_recipe(self, recipe, registry, caps=None,
                              permissive: bool = False, **factory_kwargs):
        """Compile a recipe and instantiate its pass chain via the registry."""
        report = compile_recipe(recipe, registry, caps, permissive=permissive)
        if report.ok:
            self.clear()
            for pid in report.passes:
                self.add_pass(registry.create(pid, **factory_kwargs))
        return report

    # -- planning -------------------------------------------------------------
    def build_plan(self, fp):
        if self._dirty or self._plan is None:
            self._plan = build_execution_plan(
                self._passes, fp,
                backends=self.backend_caps,
                default_backend=self._default_backend,
                preexisting_semantics=self._preexisting,
            )
            self._dirty = False
        return self._plan

    def execution_report(self):
        return self._plan

    def _valid_plan(self, fp):
        plan = self.build_plan(fp)
        if not plan.ok:
            raise RuntimeError(
                f"refusing to execute invalid plan: {plan.errors}")
        return plan

    def _start(self, frame_state: dict) -> dict:
        state = dict(frame_state)
        state.update(self._persistent_state)
        return state

    def _finish(self, ctx: RenderContext, state: dict) -> dict:
        ctx.debug.frames += 1
        ctx.frame_index += 1
        self._capture_persistent(state)
        return state

    # -- execution -------------------------------------------------------------
    def execute(self, ctx: RenderContext, frame_state: dict, fp) -> dict:
        """The instrumented path: the plan's backend groups with their
        begin / end hooks, skipped passes recorded, each pass's host ms in
        ctx.debug.pass_ms."""
        plan = self.build_plan(fp)
        ctx.backends = self.backend_impls
        out = execute_plan(plan, self._passes, ctx,
                           self._start(frame_state), fp)
        self._capture_persistent(out)
        return out

    PERSISTENT_KEYS = ("history_color", "vis_history")

    def execute_jitted(self, ctx: RenderContext, frame_state: dict, fp) -> dict:
        """The production frame path, lsr_tpu's (pipeline.py:104-134): the
        whole plan as one program, no per-pass timing, the persistent keys
        carried to the next frame through the program's inputs.  The plan
        runs through utils.capacity.checked: the first frame of each key
        (TAA's first frame, which has no history yet, and the frames after
        it are two keys) runs eagerly and sizes the raster's capacities
        (state["capacities"], a host leaf of jit's key), later frames go
        through utils.jit (on the card
        captured once into a CUDA graph and replayed, a key's first frame
        the warm-up, a failed capture raising; on the CPU eagerly), and a
        frame whose raster exceeded its capacities (a compact setup above
        fp.compact_setup_threshold, kernel B3's lists) runs again eagerly
        at grown capacities.  Each pass is a stage named by its pass_id
        (utils.trace, with tracing on).  As in lsr_tpu, the jitted plan is
        cached on (tuple(plan.order), id(fp)) and closes over ctx and fp:
        both are fixed at capture, as lsr_tpu's trace fixes them."""
        plan = self._valid_plan(fp)
        key = (tuple(plan.order), id(fp))
        if self._jit_key != key:
            passes = self._passes

            def run(state, caps):
                state = dict(state, capacities=caps)
                for idx in plan.order:
                    p = passes[idx]
                    req = p.build_execution_request(ctx, state, fp)
                    if req.valid:
                        with trace.stage(p.pass_id):
                            state = p.execute_resolved(ctx, state, fp, req)
                state.pop("capacities")       # an input, not frame state
                return state, state.get("raster_stats")

            self._jitted = checked(run, name="execute_jitted")
            self._jit_key = key
        return self._finish(ctx, self._jitted(self._start(frame_state)))

    def execute_segmented(self, ctx: RenderContext, frame_state: dict,
                          fp) -> dict:
        """Per-pass DEVICE timing (profiling mode): each pass is a stage
        (utils.trace, recorded whether tracing is on or not), bracketed by
        CUDA events on the current stream, and its device ms lands in
        ctx.debug.pass_ms after one synchronize at the end of the frame
        (the reference's per-pass GPU timestamps,
        hello_rendering_paths.cpp:111); for a state on the CPU, wall ms.
        A pass that reads a value on the host waits for the passes before
        it, which the events still place on the device's time line."""
        plan = self._valid_plan(fp)
        state = self._start(frame_state)
        stages = []
        with trace.recording():
            for idx in plan.order:
                p = self._passes[idx]
                req = p.build_execution_request(ctx, state, fp)
                if not req.valid:
                    ctx.debug.skipped_passes.append(
                        f"{p.pass_id}: {req.error}")
                    continue
                with trace.stage(p.pass_id) as st:
                    state = p.execute_resolved(ctx, state, fp, req)
                stages.append(st)
        synchronize(state)
        for st in stages:
            ctx.debug.pass_ms[st.name] = st.device_ms()
        return self._finish(ctx, state)

    def _capture_persistent(self, state: dict):
        for k in self.PERSISTENT_KEYS:
            if k in state:
                self._persistent_state[k] = state[k]

    # -- temporal state ---------------------------------------------------------
    def reset_history(self):
        self._persistent_state = {}
        for p in self._passes:
            p.reset_history()
