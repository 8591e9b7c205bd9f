"""The app, input, logic and world layers through lsr_tpu_torch against
lsr_tpu (CPU): app/runtime_state, input/value_actions, logic/state_machine
and scene/world are pure Python value types and reducers, copied.  Each
scenario of lsr_tpu's tests/test_app_logic.py runs through both packages
and the resulting states must be equal field for field; chip_smoke.py's
orbit-bot camera path (ORBIT_PATH) must be lsr_tpu's.  Last, every module
of lsr_tpu has its counterpart in the port.
"""

from __future__ import annotations

import dataclasses
import math
import os
import types

import pytest

import chip_smoke
import lsr_tpu
import lsr_tpu_torch
from lsr_tpu.app import runtime_state as j_rs
from lsr_tpu.input import value_actions as j_va
from lsr_tpu.logic import state_machine as j_sm
from lsr_tpu.scene import world as j_w
from lsr_tpu_torch.app import runtime_state as t_rs
from lsr_tpu_torch.input import value_actions as t_va
from lsr_tpu_torch.logic import state_machine as t_sm
from lsr_tpu_torch.scene import world as t_w

PKGS = {"lsr_tpu": types.SimpleNamespace(rs=j_rs, va=j_va, sm=j_sm, w=j_w),
        "lsr_tpu_torch": types.SimpleNamespace(rs=t_rs, va=t_va, sm=t_sm,
                                               w=t_w)}


def _plain(x):
    """A value as nested builtins: a dataclass as (class name, its fields),
    a CameraRig with its derived vectors, sequences element by element."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {f.name: _plain(getattr(x, f.name))
               for f in dataclasses.fields(x)}
        if type(x).__name__ == "CameraRig":
            out.update(forward=x.forward(), right=x.right(),
                       target=x.target())
        return type(x).__name__, out
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def move_and_basis(p):
    s = p.rs.RuntimeState(camera=p.rs.CameraRig(pos=(0, 0, 0), yaw=0.0))
    s2 = p.va.reduce_runtime_state(
        s, [p.va.make_move_local_action((0, 0, 1), 2.0)], 0.5)
    assert s2.camera.pos == (0.0, 0.0, 1.0) and s.camera.pos == (0, 0, 0)
    s3 = p.rs.RuntimeState(camera=p.rs.CameraRig(pos=(0, 0, 0),
                                                  yaw=math.pi / 2))
    s4 = p.va.reduce_runtime_state(
        s3, [p.va.make_move_local_action((0, 0, 1), 1.0),
             p.va.make_move_local_action((1, 1, -1), 3.0)], 1.0)
    return [s, s2, s3, s4]


def look_clamps_pitch(p):
    s = p.rs.RuntimeState()
    out = [p.va.reduce_runtime_state(s, [p.va.make_look_action(dx, dy, 1.0)],
                                     1.0)
           for dx, dy in ((0.0, -10000.0), (0.0, 10000.0), (0.3, 0.2))]
    assert abs(out[0].camera.pitch - math.radians(85.0)) < 1e-6
    return out


def toggles_and_quit(p):
    s = p.va.reduce_runtime_state(
        p.rs.RuntimeState(), [p.va.RuntimeAction("toggle_light_shafts"),
                              p.va.RuntimeAction("toggle_bot"),
                              p.va.RuntimeAction(p.va.QUIT)], 1.0)
    s2 = p.va.reduce_runtime_state(
        s, [p.va.RuntimeAction("toggle_light_shafts")], 1.0)
    assert s2.enable_light_shafts and s2.quit_requested
    return [s, s2]


def latch_and_human_actions(p):
    latch = p.va.reduce_input_latch(p.va.InputLatch(), [
        ("set_forward", True), ("set_boost", True), ("set_left", True),
        ("set_descend", True), ("add_mouse_delta", (2.0, 1.0)),
        ("add_mouse_delta", (3.0, -0.5)), ("set_left_mouse_down", True),
        ("request_quit", None)])
    acts = p.va.emit_human_actions(latch, base_speed=2.0,
                                   boost_multiplier=3.0,
                                   look_sensitivity=0.01)
    assert acts[0].meters_per_sec == 6.0
    cleared = p.va.clear_frame_deltas(latch)
    return [latch, acts, cleared,
            p.va.emit_human_actions(cleared, 1.0, 2.0, 0.5)]


def bot_emitter(p):
    s = p.rs.RuntimeState(bot_enabled=True)
    states = []
    for t in range(20):
        s = p.va.reduce_runtime_state(s, p.va.emit_orbit_bot_actions(t * 0.1),
                                      0.1)
        states.append(s)
    assert s.camera.pos != (0.0, 0.0, -5.0) and s.camera.yaw != 0.0
    return [states, [p.va.emit_orbit_bot_actions(t * 0.37)
                     for t in range(5)]]


def state_machine_priority_and_hooks(p):
    trace = []
    fsm = p.sm.StateMachine()
    fsm.add_state("idle", p.sm.StateCallbacks(
        on_enter=lambda c: trace.append("enter:idle"),
        on_exit=lambda c: trace.append("exit:idle"),
        on_update=lambda c, dt, e: trace.append(("update", dt, e))))
    fsm.add_state("walk", p.sm.StateCallbacks(
        on_enter=lambda c: trace.append("enter:walk")))
    fsm.add_state("run", p.sm.StateCallbacks(
        on_enter=lambda c: trace.append("enter:run")))
    added = [fsm.add_state("idle"), fsm.has_state("run"),
             fsm.add_transition("idle", "walk", lambda c, e: e >= 1.0, 0),
             fsm.add_transition("idle", "run", lambda c, e: e >= 1.0, 5),
             fsm.add_transition("idle", "nowhere", lambda c, e: True),
             fsm.add_transition("idle", "walk", None),
             fsm.start("nowhere")]
    fsm.update(None, 0.3)            # not started: no effect
    fsm.start("idle")
    seen = []
    for dt in (0.5, 0.6, 0.25):
        fsm.update(None, dt)
        seen.append((fsm.current, fsm.elapsed))
    assert seen[1][0] == "run" and trace[-1] == "enter:run"
    return [added, seen, trace]


def commands_reduce_all(p):
    class Add(p.sm.Command):
        def __init__(self, n):
            self.n = n

        def apply(self, state):
            return state + self.n

    with pytest.raises(NotImplementedError):
        p.sm.Command().apply(0)
    return [p.sm.reduce_all(10, [Add(1), Add(2), Add(3)]),
            p.sm.reduce_all(1.5, [])]


def world_ecs(p):
    w = p.w.World()
    a, b, c = w.create_entity(), w.create_entity(), w.create_entity()
    w.add_component(a, "pos", (1, 2, 3))
    w.add_component(a, "vel", (1, 0, 0))
    w.add_component(b, "pos", (0, 0, 0))
    w.add_component(c, "vel", (0, 1, 0))
    w.add_component(c, "pos", (5, 5, 5))
    both = list(w.entities_with("pos", "vel"))

    def integrate(world, dt):
        for eid, pos, vel in list(world.entities_with("pos", "vel")):
            world.add_component(eid, "pos", tuple(
                q + v * dt for q, v in zip(pos, vel)))

    p.w.SystemProcessor().register(integrate).register(integrate).process(
        w, 2.0)
    w.remove_component(c, "vel")
    w.destroy_entity(a)
    with pytest.raises(KeyError):
        w.add_component(a, "pos", (0, 0, 0))
    return [both, w.get_component(c, "pos"), w.get_component(a, "pos", "x"),
            w.is_alive(a), w.count("pos"), w.count("vel"),
            list(w.entities_with("pos")), list(w.entities_with())]


SCENARIOS = (move_and_basis, look_clamps_pitch, toggles_and_quit,
             latch_and_human_actions, bot_emitter,
             state_machine_priority_and_hooks, commands_reduce_all,
             world_ecs)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    """The scenario's states through both packages, field for field."""
    got, want = (_plain(scenario(PKGS[k]))
                 for k in ("lsr_tpu_torch", "lsr_tpu"))
    assert got == want


def test_orbit_bot_path_is_jax():
    """chip_smoke.py's camera path for the card's renders: lsr_tpu's
    reducers, the port's and the pinned ORBIT_PATH agree exactly."""
    paths = [chip_smoke.orbit_bot_rigs(
        p.va.reduce_runtime_state, p.va.emit_orbit_bot_actions,
        p.rs.RuntimeState(bot_enabled=True)) for p in PKGS.values()]
    assert paths[0] == paths[1] == list(chip_smoke.ORBIT_PATH)
    assert len(paths[0]) == chip_smoke.BOT_FRAMES // chip_smoke.BOT_EVERY


def test_every_lsr_tpu_module_has_a_counterpart():
    """Every .py under lsr_tpu/ has a file at the same path under
    lsr_tpu_torch/."""
    def files(pkg):
        root = os.path.dirname(pkg.__file__)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs
                if f.endswith(".py")}

    assert files(lsr_tpu) - files(lsr_tpu_torch) == set()
