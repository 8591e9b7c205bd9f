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


def _post_state(width=64, height=48, seed=13):
    """A frame state for one pass on each side, made from a numpy seed:
    lsr_tpu's render-path scene context and a camera looking at the sun
    (light shafts on screen), a depth buffer with a covered disc, an HDR
    image with values past the bloom threshold, a velocity field and a TAA
    history.  Returns (lsr_tpu state, port state)."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from lsr_tpu.scene.scene import make_camera

    from lsr_tpu_torch import convert
    from torch_scenes import jax_render_path_scene

    js = jax_render_path_scene(width, height, 16)
    sun = np.asarray(js["shade_ctx"].light_dir_ws)
    eye = np.array([0.6, 1.6, -4.5], np.float32)
    cam = make_camera(width, height, tuple(eye), tuple(eye - sun * 5.0))
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    disc = (yy - height / 2) ** 2 + (xx - width / 2) ** 2 < (height / 3) ** 2
    depth = np.where(disc, 0.93 + 0.02 * rng.uniform(size=disc.shape),
                     1.0).astype(np.float32)
    planes = {
        "depth": depth,
        "tid": np.where(disc, 7, -1).astype(np.int32),
        "hdr": rng.uniform(0, 1.6, (height, width, 3)).astype(np.float32),
        "velocity": rng.normal(0, 5, (height, width, 2)).astype(np.float32),
        "history_color": rng.uniform(0, 1.6, (height, width, 3)).astype(
            np.float32)}
    jstate = {"camera": cam, "shade_ctx": js["shade_ctx"],
              **{k: jnp.asarray(v) for k, v in planes.items()}}
    tstate = {"camera": convert.camera_state(cam, "cpu"),
              "shade_ctx": convert.shade_context(
                  js["shade_ctx"], convert.materials_soa(
                      js["shade_ctx"].materials, "cpu"), "cpu"),
              **{k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.int32
                                    else v) for k, v in planes.items()}}
    return jstate, tstate


_WRITES = {"sky": "sky", "ssao": "ssao_mask"}
_FLAGS = {"motion_blur": "enable_motion_blur",
          "light_shafts": "enable_light_shafts",
          "depth_of_field": "enable_dof", "bloom": "enable_bloom",
          "taa": "enable_taa"}


@pytest.mark.parametrize("pid,item", [
    ("sky", "A15"), ("ssao", "A14"), ("motion_blur", "A14"),
    ("light_shafts", "A14"), ("depth_of_field", "A14"), ("bloom", "A14"),
    ("taa", "A14")])
def test_unported_passes_raise(pid, item):
    """Each pass that the port lacked until ROADMAP `item` was done (the
    case ids keep their names) runs and gives lsr_tpu's pass's product on
    the same state: the sky (1e-5 off the sun disk, >= 98% of values here,
    and 1e-3 on it: the disk's edge, on screen here, multiplies the rays'
    rounding by ~5,000, and each side inverts the view-projection in
    float32), the SSAO mask (1e-6; lsr_tpu's jitted
    mask is a few ULP off its op-by-op form), the post passes' HDR (1e-5;
    light shafts on >= 99.9% of values, a tap whose position rounds to the
    neighbouring pixel under XLA:CPU's fused multiply-adds moves more) and
    TAA's history.  A post pass is a pass-through while its enable flag is
    off, as in lsr_tpu."""
    import numpy as np
    import torch
    from lsr_tpu.passes.standard_passes import make_standard_registry as jreg

    from lsr_tpu_torch.passes.standard_passes import make_standard_registry

    jstate, tstate = _post_state()
    tfp = fp()
    tfp.width, tfp.height = 64, 48
    if pid in _FLAGS:
        off = make_standard_registry().create(pid).execute_resolved(
            RenderContext(), tstate, tfp, PassExecutionRequest(pid))
        assert off["hdr"] is tstate["hdr"]
        setattr(tfp, _FLAGS[pid], True)
    from lsr_tpu_torch import convert
    import lsr_tpu.core.frame as jframe

    jfp = convert._dataclass_like(jframe.FrameParams, tfp)
    got = make_standard_registry().create(pid).execute_resolved(
        RenderContext(), tstate, tfp, PassExecutionRequest(pid))
    want = jreg().create(pid).execute_resolved(None, jstate, jfp, None)
    key = _WRITES.get(pid, "hdr")
    g, w = got[key].numpy(), np.asarray(want[key])
    err = np.abs(g - w)
    share = {"light_shafts": 0.999, "sky": 0.98}.get(pid, 1.0)
    tol = 1e-6 if pid == "ssao" else 1e-5
    assert g.shape == w.shape and (err <= tol).mean() >= share, (
        float(err.max()), float((err <= tol).mean()))
    assert err.max() <= 1e-3
    if pid != "ssao" and pid != "sky":
        assert not torch.equal(got["hdr"], tstate["hdr"])   # it did work
    if pid == "taa":
        assert torch.equal(got["history_color"], got["hdr"])


@pytest.mark.parametrize("change", ["shading_model", "debug_view", "ssao"])
def test_non_fused_lighting_raises(change):
    """The lighting passes' general branch, taken for another sun model, a
    debug view or an SSAO mask (the case ids keep their names from when it
    raised): deferred lighting on lsr_tpu's G-buffer of the render-path
    scene at 64x48 (sun shadow 64^2, local lights binned inside the pass)
    gives lsr_tpu's HDR within 1e-4 on >= 99.9% of pixels."""
    import numpy as np
    import torch
    import lsr_tpu.core.frame as jframe
    from lsr_tpu.passes.standard_passes import (
        DeferredLightingPass as JDeferred)

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.core.frame import DebugViewMode
    from lsr_tpu_torch.passes.standard_passes import DeferredLightingPass
    from torch_scenes import (
        jax_gbuffer, jax_render_path_scene, jax_sun_shadow, state_to_torch,
        torch_gbuffer)

    w, h = 64, 48
    js = jax_render_path_scene(w, h, 16)
    _, depth, tid, gb = jax_gbuffer(js, w, h)
    _, _, sc = jax_sun_shadow(js["geom"], js["objects"], js["shade_ctx"], 64,
                              "pcf")
    ts = state_to_torch(js)
    params = fp()
    params.width, params.height = w, h
    jstate = dict(js, gbuffer=gb, depth=depth, tid=tid, shadow_ctx=sc)
    tstate = dict(ts, gbuffer=torch_gbuffer(gb),
                  depth=torch.as_tensor(np.array(depth)),
                  tid=torch.as_tensor(np.asarray(tid).astype(np.int64)),
                  shadow_ctx=convert.shadow_context(sc, "cpu"))
    if change == "shading_model":
        params.shading_model = "toon"
    elif change == "debug_view":
        params.debug_view = DebugViewMode.ALBEDO
    else:
        ao = np.random.default_rng(3).uniform(0.3, 1.0, (h, w)).astype(
            np.float32)
        jstate["ssao_mask"] = ao
        tstate["ssao_mask"] = torch.as_tensor(ao)
    jfp = convert._dataclass_like(jframe.FrameParams, params)
    got = DeferredLightingPass().execute_resolved(
        RenderContext(), tstate, params, PassExecutionRequest("x"))
    want = JDeferred().execute_resolved(None, jstate, jfp, None)
    err = np.abs(got["hdr"].numpy() - np.asarray(want["hdr"])).max(-1)
    assert np.isfinite(got["hdr"].numpy()).all()
    assert (err <= 1e-4).mean() >= 0.999, float(err.max())
    assert got["light_grid"] is not None      # binned inside the pass


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


def test_frame_params_carry_post_blocks():
    """The post passes' parameter blocks (motion blur, light shafts, depth
    of field, TAA, bloom) have lsr_tpu's fields and defaults, and
    convert.frame_params carries them field for field with the feature
    flags."""
    import lsr_tpu.core.frame as jframe

    from lsr_tpu_torch import convert

    blocks = ("motion_blur", "light_shafts", "dof", "taa", "bloom")
    jdef, tdef = jframe.FrameParams(), FrameParams()
    for block in blocks:
        assert (dataclasses.asdict(getattr(tdef.pass_params, block))
                == dataclasses.asdict(getattr(jdef.pass_params, block)))
    jfp = jframe.FrameParams()
    jfp.enable_taa = jfp.enable_dof = jfp.enable_motion_vectors = True
    jfp.pass_params.dof.focus_range = 0.05
    jfp.pass_params.motion_blur.strength = 1.5
    jfp.pass_params.taa = dataclasses.replace(jfp.pass_params.taa,
                                              blend=0.2)
    jfp.pass_params.bloom.blur_passes = 2
    jfp.pass_params.light_shafts.steps = 32
    tfp = convert.frame_params(jfp)
    for block in blocks:
        assert (dataclasses.asdict(getattr(tfp.pass_params, block))
                == dataclasses.asdict(getattr(jfp.pass_params, block)))
    assert tfp.enable_taa and tfp.enable_dof and tfp.enable_motion_vectors


def test_pipeline_modules_import_no_jax():
    """The pipeline, the standard passes (with the sky, IBL, SSAO and post
    modules they import), render_paths and full_pipeline import torch and
    numpy only: never jax or lsr_tpu."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import lsr_tpu_torch.render_paths\n"
        "import lsr_tpu_torch.pipeline.pipeline\n"
        "import lsr_tpu_torch.passes.standard_passes\n"
        "import lsr_tpu_torch.full_pipeline\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lsr_tpu' or m.startswith('lsr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
