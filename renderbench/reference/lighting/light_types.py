"""Light types as SoA tensors + culling bounds (port of
lsr_tpu/lighting/light_types.py).

Besides the per-light columns, LightsSoA carries two host-side constants
computed once when the set is built (never per frame, so shading issues no
host sync): `kinds`, the sorted tuple of light types present, and `apow1`,
whether every attenuation power is exactly 1.0.  They take the place of the
JAX package's trace-time concreteness checks (passes/forward_plus.py:132-149).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from renderbench.reference.core.util import resolve_device

LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2
LIGHT_RECT_AREA = 3
LIGHT_TUBE_AREA = 4
LIGHT_ENV_PROBE = 5

ATTEN_LINEAR = 0
ATTEN_SMOOTH = 1
ATTEN_INVERSE_SQUARE = 2

COLUMNS = (
    "type", "position", "direction", "up", "axis", "color", "intensity",
    "range", "inner_angle", "outer_angle", "rect_half_extents",
    "tube_half_length", "tube_radius", "atten_model", "atten_power",
    "atten_bias", "atten_cutoff", "enabled",
)


@dataclasses.dataclass(frozen=True)
class LightsSoA:
    type: torch.Tensor              # (L,) i64
    position: torch.Tensor          # (L, 3)
    direction: torch.Tensor         # (L, 3) forward (toward scene)
    up: torch.Tensor                # (L, 3) up hint
    axis: torch.Tensor              # (L, 3) tube axis
    color: torch.Tensor             # (L, 3)
    intensity: torch.Tensor         # (L,)
    range: torch.Tensor             # (L,)
    inner_angle: torch.Tensor       # (L,) rad (spot)
    outer_angle: torch.Tensor       # (L,) rad (spot)
    rect_half_extents: torch.Tensor # (L, 2)
    tube_half_length: torch.Tensor  # (L,)
    tube_radius: torch.Tensor       # (L,)
    atten_model: torch.Tensor       # (L,) i64
    atten_power: torch.Tensor       # (L,)
    atten_bias: torch.Tensor        # (L,)
    atten_cutoff: torch.Tensor      # (L,)
    enabled: torch.Tensor           # (L,) bool
    kinds: tuple = ()               # host: sorted light types present
    apow1: bool = False             # host: every atten_power == 1.0

    @property
    def count(self) -> int:
        return int(self.type.shape[0])


def lights_from_numpy(cols: dict, device) -> LightsSoA:
    """LightsSoA on `device` from numpy columns; computes the host constants
    (`kinds`, `apow1`) from the same numpy data."""
    out = {}
    for k in COLUMNS:
        a = np.asarray(cols[k])
        if k in ("type", "atten_model"):
            out[k] = torch.as_tensor(a.astype(np.int64), device=device)
        elif k == "enabled":
            out[k] = torch.as_tensor(a.astype(bool), device=device)
        else:
            out[k] = torch.as_tensor(a.astype(np.float32), device=device)
    types = np.asarray(cols["type"])
    ap = np.asarray(cols["atten_power"], np.float32)
    return LightsSoA(
        **out,
        kinds=tuple(sorted(int(t) for t in np.unique(types))),
        apow1=bool(ap.size) and bool((ap == 1.0).all()),
    )


class LightSetBuilder:
    """Host-side light assembly (LightSet analog)."""

    def __init__(self):
        self._rows = []

    def _add(self, **kw):
        row = dict(
            type=LIGHT_POINT, position=(0, 0, 0), direction=(0, -1, 0),
            up=(0, 1, 0), axis=(1, 0, 0), color=(1, 1, 1), intensity=1.0,
            range=5.0, inner_angle=0.3, outer_angle=0.5,
            rect_half_extents=(0.5, 0.5), tube_half_length=0.5,
            tube_radius=0.1, atten_model=ATTEN_SMOOTH, atten_power=1.0,
            atten_bias=1e-4, atten_cutoff=0.0, enabled=True,
        )
        row.update(kw)
        self._rows.append(row)
        return len(self._rows) - 1

    def point(self, position, color=(1, 1, 1), intensity=1.0, range=5.0, **kw):
        return self._add(type=LIGHT_POINT, position=position, color=color,
                         intensity=intensity, range=range, **kw)

    def spot(self, position, direction, color=(1, 1, 1), intensity=1.0,
             range=8.0, inner_angle=0.3, outer_angle=0.5, **kw):
        return self._add(type=LIGHT_SPOT, position=position,
                         direction=direction, color=color,
                         intensity=intensity, range=range,
                         inner_angle=inner_angle, outer_angle=outer_angle, **kw)

    def rect_area(self, position, direction, half_extents=(0.5, 0.5),
                  color=(1, 1, 1), intensity=1.0, range=6.0, **kw):
        return self._add(type=LIGHT_RECT_AREA, position=position,
                         direction=direction, rect_half_extents=half_extents,
                         color=color, intensity=intensity, range=range, **kw)

    def tube_area(self, position, axis=(1, 0, 0), half_length=0.5, radius=0.1,
                  color=(1, 1, 1), intensity=1.0, range=6.0, **kw):
        return self._add(type=LIGHT_TUBE_AREA, position=position, axis=axis,
                         tube_half_length=half_length, tube_radius=radius,
                         color=color, intensity=intensity, range=range, **kw)

    def env_probe(self, position, color=(1, 1, 1), intensity=1.0, range=5.0,
                  **kw):
        """Localized-IBL probe, evaluated by light_runtime.eval_env_probes."""
        return self._add(type=LIGHT_ENV_PROBE, position=position, color=color,
                         intensity=intensity, range=range, **kw)

    def build(self, device=None) -> LightsSoA:
        device = resolve_device(device)
        if not self._rows:
            raise ValueError("LightSetBuilder.build: no lights added")
        cols = {k: np.asarray([r[k] for r in self._rows]) for k in COLUMNS}
        return lights_from_numpy(cols, device)


def light_bounding_spheres(lights: LightsSoA):
    """Conservative world bounding sphere per light.
    Returns (centers (L,3), radii (L,))."""
    r = torch.clamp(lights.range, min=1e-3)
    he = lights.rect_half_extents
    rect_pad = torch.sqrt((he * he).sum(-1))
    tube_pad = lights.tube_half_length + lights.tube_radius
    radii = torch.where(
        lights.type == LIGHT_RECT_AREA, r + rect_pad,
        torch.where(lights.type == LIGHT_TUBE_AREA, r + tube_pad, r))
    radii = torch.where(lights.type == LIGHT_DIRECTIONAL,
                        torch.full_like(radii, 1e8), radii)
    radii = torch.where(lights.enabled, radii, torch.zeros_like(radii))
    return lights.position, radii
