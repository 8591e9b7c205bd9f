"""lsr_tpu_torch's pipeline framework (lsr_tpu_torch/pipeline) and standard
pass registry vs lsr_tpu's (CPU, no device work).

The framework cases of tests/test_pipeline.py run on the port's modules,
with the same dummy backends and passes (the reference renderer's
vop_core_tests.cpp:150-401 equivalents); then the port's compile_recipe
reports and plan orders are held equal to lsr_tpu's for the five presets,
the SSAO composition and every post stack, on the real registries.
"""

import dataclasses

import pytest

from lsr_tpu_torch.core.frame import FrameParams, TechniqueMode
from lsr_tpu_torch.pipeline.contracts import STANDARD_CONTRACTS
from lsr_tpu_torch.pipeline.executor import IBackend, RenderContext, execute_plan
from lsr_tpu_torch.pipeline.frame_graph import compile_frame_graph
from lsr_tpu_torch.pipeline.pipeline import PluggablePipeline
from lsr_tpu_torch.pipeline.planner import BackendCaps, build_execution_plan
from lsr_tpu_torch.pipeline.recipe import (
    RenderPathCapabilitySet,
    RenderPathRecipe,
    builtin_render_path_presets,
    compile_recipe,
)
from lsr_tpu_torch.pipeline.registry import PassDescriptor, PassFactoryRegistry
from lsr_tpu_torch.pipeline.render_pass import PassExecutionRequest, RenderPass


class DummyBackend(IBackend):
    """Counts begin/end frames (vop_core_tests.cpp:21)."""

    def __init__(self, name):
        self.name = name
        self.begins = 0
        self.ends = 0

    def begin_frame(self, ctx):
        self.begins += 1

    def end_frame(self, ctx):
        self.ends += 1


class DummyPass(RenderPass):
    def __init__(self, pass_id, reads=(), writes=(), backend="any"):
        super().__init__(pass_id, reads, writes, preferred_backend=backend)
        self.executed = 0

    def execute_resolved(self, ctx, frame_state, fp, request):
        self.executed += 1
        out = dict(frame_state)
        for w in self.describe_io().writes:
            out[w] = out.get(w, 0) + 1
        return out


class RejectingRequestPass(DummyPass):
    """Always produces an invalid request (vop_core_tests.cpp:63)."""

    def build_execution_request(self, ctx, frame_state, fp):
        return PassExecutionRequest(self.pass_id, valid=False, error="nope")


def fp():
    return FrameParams()


def test_frame_graph_raw_order():
    a = DummyPass("a", writes=("hdr",))
    b = DummyPass("b", reads=("hdr",), writes=("ldr",))
    c = DummyPass("c", reads=("ldr",))
    # Insert out of order; graph must reorder by dependencies.
    g = compile_frame_graph([c, b, a])
    assert g.ok
    assert g.order == [2, 1, 0]


def test_frame_graph_stable_insertion_for_independent():
    ps = [DummyPass(f"p{i}", writes=(f"r{i}",)) for i in range(4)]
    g = compile_frame_graph(ps)
    assert g.order == [0, 1, 2, 3]


def test_frame_graph_cycle_fallback():
    a = DummyPass("a", reads=("y",), writes=("x",))
    b = DummyPass("b", reads=("x",), writes=("y",))
    g = compile_frame_graph([a, b])
    assert not g.ok
    assert g.order == [0, 1]  # insertion-order fallback, not an abort


def test_plan_groups_by_backend():
    backends = {
        "torch": BackendCaps("torch"),
        "aux": BackendCaps("aux"),
    }
    ps = [
        DummyPass("a", writes=("r1",), backend="torch"),
        DummyPass("b", reads=("r1",), writes=("r2",), backend="torch"),
        DummyPass("c", reads=("r2",), writes=("r3",), backend="aux"),
        DummyPass("d", reads=("r3",), backend="torch"),
    ]
    plan = build_execution_plan(ps, fp(), backends=backends)
    assert plan.ok
    assert [g.backend for g in plan.groups] == ["torch", "aux", "torch"]
    assert [len(g.pass_indices) for g in plan.groups] == [2, 1, 1]


def test_plan_backend_fallback_and_block():
    backends = {"torch": BackendCaps("torch")}
    ps = [DummyPass("a", writes=("r",), backend="missing")]
    plan = build_execution_plan(ps, fp(), backends=backends)
    assert plan.ok
    assert any("falling back" in w for w in plan.warnings)

    # Cross-backend edge blocked when disallowed (vop_core_tests.cpp:201).
    backends2 = {"torch": BackendCaps("torch"), "aux": BackendCaps("aux")}
    ps2 = [
        DummyPass("a", writes=("r",), backend="torch"),
        DummyPass("b", reads=("r",), backend="aux"),
    ]
    plan2 = build_execution_plan(ps2, fp(), backends=backends2,
                                 allow_cross_backend=False)
    assert not plan2.ok


def test_invalid_request_never_executed():
    ps = [RejectingRequestPass("reject", writes=("x",)), DummyPass("ok", writes=("y",))]
    plan = build_execution_plan(ps, fp())
    ctx = RenderContext()
    state = execute_plan(plan, ps, ctx, {}, fp())
    assert ps[0].executed == 0
    assert ps[1].executed == 1
    assert "x" not in state and state["y"] == 1
    assert any("reject" in s for s in ctx.debug.skipped_passes)


def test_executor_refuses_invalid_plan():
    a = DummyPass("a", reads=("y",), writes=("x",))
    b = DummyPass("b", reads=("x",), writes=("y",))
    plan = build_execution_plan([a, b], fp())
    assert not plan.ok
    with pytest.raises(RuntimeError):
        execute_plan(plan, [a, b], RenderContext(), {}, fp())


def test_registry_hints_before_instantiation():
    """Mode support is queryable without creating the pass (vop_core_tests.cpp:284)."""
    created = []

    def factory(**kw):
        created.append(1)
        return DummyPass("fp_only")

    reg = PassFactoryRegistry()
    reg.register("fp_only", factory,
                 PassDescriptor(modes=TechniqueMode.FORWARD_PLUS))
    desc = reg.descriptor("fp_only")
    assert not desc.supports_mode(TechniqueMode.DEFERRED)
    assert desc.supports_mode(TechniqueMode.FORWARD_PLUS)
    assert created == []  # descriptor query did not instantiate


def test_planner_is_pure_of_runtime_ctx():
    """Planner output can't depend on runtime context (vop_core_tests.cpp:320)
    — enforced structurally: build_execution_plan takes no ctx at all."""
    import inspect

    sig = inspect.signature(build_execution_plan)
    assert "ctx" not in sig.parameters


def test_contract_validation_detects_missing_producer():
    class ContractPass(RenderPass):
        pass

    tm = ContractPass("tonemap", reads=("hdr",), writes=("ldr",),
                      contract=STANDARD_CONTRACTS["tonemap"])
    plan = build_execution_plan([tm], fp(), preexisting_semantics=())
    assert not plan.ok
    assert any("scene_color_hdr" in e for e in plan.errors)

    fwd = ContractPass("pbr_forward", writes=("hdr",),
                       contract=STANDARD_CONTRACTS["pbr_forward"])
    tm2 = ContractPass("tonemap", reads=("hdr",), writes=("ldr",),
                       contract=STANDARD_CONTRACTS["tonemap"])
    plan2 = build_execution_plan([fwd, tm2], fp(), preexisting_semantics=())
    assert plan2.ok, plan2.errors


def test_contract_mode_filter():
    class ContractPass(RenderPass):
        pass

    fplus = ContractPass("pbr_forward_plus", writes=("hdr",),
                         contract=STANDARD_CONTRACTS["pbr_forward_plus"])
    params = fp()
    params.technique.mode = TechniqueMode.FORWARD
    plan = build_execution_plan([fplus], params, preexisting_semantics=())
    assert not plan.ok  # forward+ lighting pass invalid in FORWARD mode


def _registry_with(*ids):
    reg = PassFactoryRegistry()
    for pid in ids:
        reg.register(pid, lambda pid=pid, **kw: DummyPass(pid))
    return reg


def test_recipe_rules_shadows_and_occlusion():
    reg = _registry_with("shadow_map", "depth_prepass", "pbr_forward", "tonemap")
    r = RenderPathRecipe(name="t", technique=TechniqueMode.FORWARD,
                         shadows=True, occlusion_culling=True)
    rep = compile_recipe(r, reg)
    assert rep.ok, rep.errors
    assert rep.passes[0] == "shadow_map"
    assert rep.passes[1] == "depth_prepass"
    assert rep.passes[-1] == "tonemap"


def test_recipe_unknown_and_permissive():
    reg = _registry_with("pbr_forward", "tonemap")
    r = RenderPathRecipe(name="t", technique=TechniqueMode.FORWARD,
                         pass_chain=("pbr_forward", "wat"))
    rep = compile_recipe(r, reg)
    assert not rep.ok
    rep2 = compile_recipe(r, reg, permissive=True)
    assert rep2.ok and any("downgraded" in w for w in rep2.warnings)


def test_recipe_capability_check():
    reg = _registry_with("shadow_map", "pbr_forward", "tonemap")
    caps = RenderPathCapabilitySet(shadows=False)
    r = RenderPathRecipe(name="t", technique=TechniqueMode.FORWARD, shadows=True)
    rep = compile_recipe(r, reg, caps)
    assert not rep.ok


def test_builtin_presets_compile():
    reg = _registry_with(
        "scene_cull", "shadow_map", "local_shadows", "depth_prepass",
        "light_culling", "cluster_build",
        "cluster_light_assign", "gbuffer", "deferred_lighting",
        "deferred_lighting_tiled", "pbr_forward", "pbr_forward_plus",
        "pbr_forward_clustered", "tonemap", "fxaa", "bloom", "taa",
        "light_shafts", "motion_blur", "depth_of_field",
    )
    for preset in builtin_render_path_presets():
        rep = compile_recipe(preset, reg)
        assert rep.ok, (preset.name, rep.errors)
        assert rep.passes[-1] == "tonemap"
        # The flagship workload is part of every preset chain
        # (hello_rendering_paths.cpp:94-109).
        assert rep.passes[0] == "scene_cull"
        assert "local_shadows" in rep.passes
        assert rep.passes.index("local_shadows") \
            > rep.passes.index("shadow_map")


def test_ssao_composition_compiles():
    """forward_classic+ssao (demo_forward_classic_renderpath.cpp:113-114
    registers ssao as a custom pass): ssao must land after the depth
    prepass that feeds it and before the lighting pass that consumes the
    mask."""
    from lsr_tpu_torch.pipeline.recipe import ssao_composition_recipe

    reg = _registry_with(
        "scene_cull", "shadow_map", "local_shadows", "depth_prepass",
        "ssao", "pbr_forward", "tonemap",
    )
    rep = compile_recipe(ssao_composition_recipe(), reg)
    assert rep.ok, rep.errors
    assert "ssao" in rep.passes
    assert rep.passes.index("ssao") > rep.passes.index("depth_prepass")
    assert rep.passes.index("ssao") < rep.passes.index("pbr_forward")


def test_pipeline_end_to_end_with_dummy_backend():
    pipe = PluggablePipeline()
    be = DummyBackend("torch")
    pipe.backend_impls["torch"] = be
    pipe.add_pass(DummyPass("a", writes=("r1",)))
    pipe.add_pass(DummyPass("b", reads=("r1",), writes=("r2",)))
    ctx = RenderContext()
    state = pipe.execute(ctx, {}, fp())
    assert state == {"r1": 1, "r2": 1}
    assert be.begins == 1 and be.ends == 1
    assert ctx.debug.frames == 1
    assert set(ctx.debug.pass_ms) == {"a", "b"}

    # Disabling a pass dirties and rebuilds the plan.
    pipe.set_enabled("b", False)
    state2 = pipe.execute(ctx, {}, fp())
    assert state2 == {"r1": 1}


# ---------------------------------------------------------------------------
# The port's three ways to execute a plan
# ---------------------------------------------------------------------------

def test_execute_jitted_and_segmented_equal_execute():
    """execute, execute_jitted (the whole plan eagerly, no per-pass
    bookkeeping) and execute_segmented (per-pass timing; wall ms on the
    CPU) give the same state and carry the persistent keys to the next
    frame; segmented records every pass's ms."""
    import torch

    class Hist(DummyPass):
        def execute_resolved(self, ctx, frame_state, fp, request):
            out = dict(frame_state)
            out["vis_history"] = frame_state.get(
                "vis_history", torch.zeros(3)) + 1
            out["x"] = out["vis_history"] * 2
            return out

    states = []
    for how in ("execute", "execute_jitted", "execute_segmented"):
        pipe = PluggablePipeline()
        pipe.add_pass(Hist("h", writes=("vis_history", "x")))
        pipe.add_pass(DummyPass("b", reads=("x",), writes=("y",)))
        ctx = RenderContext()
        for _ in range(2):
            st = getattr(pipe, how)(ctx, {"t": torch.ones(2)}, fp())
        assert ctx.debug.frames == 2
        if how != "execute_jitted":
            assert set(ctx.debug.pass_ms) == {"h", "b"}
        states.append(st)
    for st in states[1:]:
        assert st.keys() == states[0].keys()
        assert torch.equal(st["x"], states[0]["x"])
        assert torch.equal(st["vis_history"], torch.full((3,), 2.0))


def test_sync_timing_waits_for_the_state_device():
    """sync_timing synchronizes the device of the state's tensors after each
    pass (a no-op on the CPU); state_device finds a tensor in a dataclass
    value too."""
    import torch

    from lsr_tpu_torch.pipeline.executor import state_device
    from lsr_tpu_torch.scene.scene import make_camera

    cam = make_camera(8, 8, (0, 1, -3), (0, 0, 0), device="cpu")
    assert state_device({"camera": cam}) == torch.device("cpu")
    assert state_device({"n": 3}) is None
    pipe = PluggablePipeline()
    pipe.add_pass(DummyPass("a", writes=("r",)))
    ctx = RenderContext(sync_timing=True)
    assert pipe.execute(ctx, {"camera": cam}, fp())["r"] == 1


# ---------------------------------------------------------------------------
# The standard registry and the presets against lsr_tpu's
# ---------------------------------------------------------------------------

def _recipes(module):
    """lsr_tpu's (or the port's) five presets and the SSAO composition."""
    return {r.name: r for r in module.builtin_render_path_presets()
            + [module.ssao_composition_recipe()]}


def test_registry_registers_every_pass_id_of_jax():
    """The port's make_standard_registry knows every pass id of lsr_tpu's,
    in the same order, with the same descriptors (backends, modes)."""
    from lsr_tpu.passes.standard_passes import make_standard_registry as jreg

    from lsr_tpu_torch.passes.standard_passes import (
        make_standard_registry as treg)

    j, t = jreg(), treg()
    assert t.pass_ids() == j.pass_ids()
    for pid in j.pass_ids():
        jd, td = j.descriptor(pid), t.descriptor(pid)
        assert td.backends == jd.backends, pid
        assert int(td.modes) == int(jd.modes), pid
        p = t.create(pid)
        jp = j.create(pid)
        assert p.describe_io() == type(p.describe_io())(
            *dataclasses.astuple(jp.describe_io())), pid
        assert (p.describe_contract().role
                == jp.describe_contract().role), pid


POSTS = {"fxaa": ("fxaa",), "minimal": (), "default": ("bloom",),
         "temporal": ("taa",),
         "full": ("light_shafts", "motion_blur", "bloom", "depth_of_field",
                  "taa", "fxaa")}


@pytest.mark.parametrize("post", sorted(POSTS))
@pytest.mark.parametrize("name", [
    "forward_classic", "forward_plus", "deferred", "tiled_deferred",
    "clustered_forward", "forward_classic+ssao"])
def test_compile_and_plan_match_jax(name, post):
    """compile_recipe's report (passes, errors, warnings) and the plan
    (order, backend groups' passes, errors, warnings) of the port equal
    lsr_tpu's for each preset and the SSAO composition with each post
    stack (POST_STACK_PRESETS, and fxaa alone as run_phases' default), on
    the real registries and each preset's technique mode."""
    import lsr_tpu.core.frame as jframe
    import lsr_tpu.pipeline.recipe as jrecipe
    from lsr_tpu.passes.standard_passes import make_standard_registry as jreg
    from lsr_tpu.pipeline.pipeline import PluggablePipeline as JPipe
    from lsr_tpu.pipeline.recipe import POST_STACK_PRESETS as JPOSTS

    import lsr_tpu_torch.pipeline.recipe as trecipe
    from lsr_tpu_torch.passes.standard_passes import (
        make_standard_registry as treg)
    from lsr_tpu_torch.pipeline.recipe import POST_STACK_PRESETS as TPOSTS
    from lsr_tpu_torch.render_paths import MODE_FOR

    assert TPOSTS == JPOSTS
    assert all(JPOSTS[k] == POSTS[k] for k in JPOSTS)
    stack = POSTS[post]
    jr = dataclasses.replace(_recipes(jrecipe)[name], post_stack=stack)
    tr = dataclasses.replace(_recipes(trecipe)[name], post_stack=stack)
    jp, tp = JPipe(preexisting_semantics=()), PluggablePipeline(
        preexisting_semantics=())
    jrep = jp.configure_from_recipe(jr, jreg())
    trep = tp.configure_from_recipe(tr, treg())
    assert (trep.passes, trep.errors, trep.warnings) == (
        jrep.passes, jrep.errors, jrep.warnings)
    assert trep.ok and "scene_cull" in trep.passes
    jfp, tfp = jframe.FrameParams(), FrameParams()
    jfp.technique.mode = jframe.TechniqueMode[MODE_FOR[name]]
    tfp.technique.mode = TechniqueMode[MODE_FOR[name]]
    jplan, tplan = jp.build_plan(jfp), tp.build_plan(tfp)
    assert tplan.order == jplan.order
    assert ([g.pass_indices for g in tplan.groups]
            == [g.pass_indices for g in jplan.groups])
    assert (tplan.errors, tplan.warnings) == (jplan.errors, jplan.warnings)
    assert tplan.ok


@pytest.mark.parametrize("pid,item", [
    ("sky", "A15"), ("ssao", "A14"), ("motion_blur", "A14"),
    ("light_shafts", "A14"), ("depth_of_field", "A14"), ("bloom", "A14"),
    ("taa", "A14")])
def test_unported_passes_raise(pid, item):
    """A pass the port does not have raises NotImplementedError naming its
    ROADMAP item when executed; it is never skipped."""
    from lsr_tpu_torch.passes.standard_passes import make_standard_registry

    p = make_standard_registry().create(pid)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        p.execute_resolved(RenderContext(), {}, fp(),
                           PassExecutionRequest(pid))


@pytest.mark.parametrize("change", ["shading_model", "debug_view", "ssao"])
def test_non_fused_lighting_raises(change):
    """The lighting passes' general branch (another sun model, a debug
    view, an SSAO mask) is not ported: it raises (ROADMAP A14, A6)
    before any work."""
    from lsr_tpu_torch.core.frame import DebugViewMode
    from lsr_tpu_torch.passes.standard_passes import DeferredLightingPass

    params, state = fp(), {"light_grid": {}}
    if change == "shading_model":
        params.shading_model = "toon"
    elif change == "debug_view":
        params.debug_view = DebugViewMode.ALBEDO
    else:
        state["ssao_mask"] = 1.0
    with pytest.raises(NotImplementedError, match="A14, A6"):
        DeferredLightingPass().execute_resolved(
            RenderContext(), state, params, PassExecutionRequest("x"))


def test_frame_params_carry_local_shadow_and_culling():
    """convert.frame_params carries lsr_tpu's LocalShadowParams and
    CullingPassParams field for field, with the technique and the
    shadow block."""
    import lsr_tpu.core.frame as jframe

    from lsr_tpu_torch import convert

    jfp = jframe.FrameParams(width=320, height=180)
    jfp.technique.mode = jframe.TechniqueMode.CLUSTERED_FORWARD
    jfp.technique.cluster_slices = 8
    jfp.pass_params.local_shadow = dataclasses.replace(
        jfp.pass_params.local_shadow, spot_ids=(0, 3), point_ids=(5,),
        map_size=256, point_size=128, vis_scale=2, vis_crop=((96, 128),),
        filter_mode="esm")
    jfp.pass_params.culling = dataclasses.replace(
        jfp.pass_params.culling, occ_width=160, occ_height=90,
        hold_frames=2, cull_lights=False)
    tfp = convert.frame_params(jfp)
    for block in ("local_shadow", "culling", "shadow"):
        assert (dataclasses.asdict(getattr(tfp.pass_params, block))
                == dataclasses.asdict(getattr(jfp.pass_params, block)))
    assert tfp.technique.mode == TechniqueMode.CLUSTERED_FORWARD
    assert tfp.technique.cluster_slices == 8


def test_pipeline_modules_import_no_jax():
    """The pipeline, the standard passes and render_paths import torch and
    numpy only: never jax or lsr_tpu."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import lsr_tpu_torch.render_paths\n"
        "import lsr_tpu_torch.pipeline.pipeline\n"
        "import lsr_tpu_torch.passes.standard_passes\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lsr_tpu' or m.startswith('lsr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
