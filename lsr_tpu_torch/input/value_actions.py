"""Value-oriented input actions + pure reducers; copied from
lsr_tpu/input/value_actions.py.

Port of the reference's VOP input pipeline (input/value_actions.hpp:26-188,
input/value_input_latch.hpp:80-140): OS events -> latch state -> actions ->
runtime-state reduction, all as pure functions over immutable values.  This
layer is what the reference's unit tests pin (vop_core_tests.cpp:150-199).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

from lsr_tpu_torch.app.runtime_state import CameraRig, RuntimeState

# --- actions (value_actions.hpp:26-100) ------------------------------------

MOVE_LOCAL = "move_local"
LOOK = "look"
TOGGLE_LIGHT_SHAFTS = "toggle_light_shafts"
TOGGLE_BOT = "toggle_bot"
QUIT = "quit"


@dataclasses.dataclass(frozen=True)
class RuntimeAction:
    type: str
    local_dir: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    meters_per_sec: float = 0.0
    dx: float = 0.0
    dy: float = 0.0
    sensitivity: float = 0.0


def make_move_local_action(local_dir, meters_per_sec):
    return RuntimeAction(MOVE_LOCAL, local_dir=tuple(local_dir),
                         meters_per_sec=meters_per_sec)


def make_look_action(dx, dy, sensitivity):
    return RuntimeAction(LOOK, dx=dx, dy=dy, sensitivity=sensitivity)


_PITCH_LIMIT = math.radians(85.0)


def reduce_runtime_state(state: RuntimeState,
                         actions: Sequence[RuntimeAction],
                         dt: float) -> RuntimeState:
    """Pure reducer (value_actions.hpp:101-153): same action semantics —
    local-space movement in camera basis, yaw+=dx, pitch-=dy clamped ±85°,
    toggles, quit latch."""
    cam = state.camera
    enable_shafts = state.enable_light_shafts
    bot = state.bot_enabled
    quit_req = state.quit_requested

    for a in actions:
        if a.type == MOVE_LOCAL:
            fwd = cam.forward()
            right = cam.right()
            up = (0.0, 1.0, 0.0)
            scale = a.meters_per_sec * dt
            d = tuple(
                (right[i] * a.local_dir[0] + up[i] * a.local_dir[1]
                 + fwd[i] * a.local_dir[2]) * scale
                for i in range(3)
            )
            cam = dataclasses.replace(
                cam, pos=(cam.pos[0] + d[0], cam.pos[1] + d[1], cam.pos[2] + d[2])
            )
        elif a.type == LOOK:
            yaw = cam.yaw + a.dx * a.sensitivity
            pitch = max(-_PITCH_LIMIT,
                        min(_PITCH_LIMIT, cam.pitch - a.dy * a.sensitivity))
            cam = dataclasses.replace(cam, yaw=yaw, pitch=pitch)
        elif a.type == TOGGLE_LIGHT_SHAFTS:
            enable_shafts = not enable_shafts
        elif a.type == TOGGLE_BOT:
            bot = not bot
        elif a.type == QUIT:
            quit_req = True

    return RuntimeState(camera=cam, enable_light_shafts=enable_shafts,
                        quit_requested=quit_req, bot_enabled=bot)


# --- input latch (value_input_latch.hpp) ------------------------------------

@dataclasses.dataclass(frozen=True)
class InputLatch:
    forward: bool = False
    backward: bool = False
    left: bool = False
    right: bool = False
    ascend: bool = False
    descend: bool = False
    boost: bool = False
    left_mouse_down: bool = False
    right_mouse_down: bool = False
    mouse_dx_accum: float = 0.0
    mouse_dy_accum: float = 0.0
    quit_requested: bool = False


_BOOL_EVENTS = {
    "set_forward": "forward",
    "set_backward": "backward",
    "set_left": "left",
    "set_right": "right",
    "set_ascend": "ascend",
    "set_descend": "descend",
    "set_boost": "boost",
    "set_left_mouse_down": "left_mouse_down",
    "set_right_mouse_down": "right_mouse_down",
}


def reduce_input_latch(state: InputLatch, events) -> InputLatch:
    """reduce_runtime_input_latch (value_input_latch.hpp:80-126): events are
    (type, payload) tuples; mouse deltas ACCUMULATE, quit latches."""
    changes = {}
    dx = state.mouse_dx_accum
    dy = state.mouse_dy_accum
    quit_req = state.quit_requested
    for etype, payload in events:
        if etype in _BOOL_EVENTS:
            changes[_BOOL_EVENTS[etype]] = bool(payload)
        elif etype == "add_mouse_delta":
            dx += payload[0]
            dy += payload[1]
        elif etype == "request_quit":
            quit_req = True
    return dataclasses.replace(state, mouse_dx_accum=dx, mouse_dy_accum=dy,
                               quit_requested=quit_req, **changes)


def clear_frame_deltas(state: InputLatch) -> InputLatch:
    return dataclasses.replace(state, mouse_dx_accum=0.0, mouse_dy_accum=0.0)


def emit_human_actions(latch: InputLatch, base_speed: float,
                       boost_multiplier: float, look_sensitivity: float):
    """value_actions.hpp:156-178: latch state -> action list, same order."""
    speed = base_speed * (boost_multiplier if latch.boost else 1.0)
    out = []
    if latch.forward:
        out.append(make_move_local_action((0, 0, 1), speed))
    if latch.backward:
        out.append(make_move_local_action((0, 0, -1), speed))
    if latch.left:
        out.append(make_move_local_action((-1, 0, 0), speed))
    if latch.right:
        out.append(make_move_local_action((1, 0, 0), speed))
    if latch.ascend:
        out.append(make_move_local_action((0, 1, 0), speed))
    if latch.descend:
        out.append(make_move_local_action((0, -1, 0), speed))
    if latch.left_mouse_down and (latch.mouse_dx_accum or latch.mouse_dy_accum):
        out.append(make_look_action(latch.mouse_dx_accum, latch.mouse_dy_accum,
                                    look_sensitivity))
    if latch.quit_requested:
        out.append(RuntimeAction(QUIT))
    return out


def emit_orbit_bot_actions(time_s: float):
    """Autopilot emitter (value_actions.hpp:180-188)."""
    sway = math.sin(time_s * 0.5)
    return [
        make_look_action(0.35 + 0.25 * sway, 0.0, 0.01),
        make_move_local_action((0, 0, 0.4 + 0.2 * math.sin(time_s * 0.8)), 2.0),
    ]
