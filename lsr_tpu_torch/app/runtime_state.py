"""Application runtime state + free camera rig (value types); copied from
lsr_tpu/app/runtime_state.py.

Analog of app/runtime_state.hpp:17 and camera/camera_rig.hpp: a plain
immutable value struct reduced by pure action reducers (VOP Constitution II:
pure value transforms in the center, effects at the edges).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CameraRig:
    """Yaw/pitch free camera (LH, +Y up, +Z forward)."""

    pos: tuple = (0.0, 0.0, -5.0)
    yaw: float = 0.0     # radians around +Y; 0 looks toward +Z
    pitch: float = 0.0   # radians; positive looks up

    def forward(self) -> tuple:
        cp = math.cos(self.pitch)
        return (
            math.sin(self.yaw) * cp,
            math.sin(self.pitch),
            math.cos(self.yaw) * cp,
        )

    def right(self) -> tuple:
        # LH: right = up x forward (normalized for yaw-only rotation).
        return (math.cos(self.yaw), 0.0, -math.sin(self.yaw))

    def target(self) -> tuple:
        f = self.forward()
        return (self.pos[0] + f[0], self.pos[1] + f[1], self.pos[2] + f[2])


@dataclasses.dataclass(frozen=True)
class RuntimeState:
    """runtime_state.hpp:17."""

    camera: CameraRig = dataclasses.field(default_factory=CameraRig)
    enable_light_shafts: bool = True
    quit_requested: bool = False
    bot_enabled: bool = False
