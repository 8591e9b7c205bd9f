"""Named transient render-target registry (port of
lsr_tpu/gfx/rt_registry.py).

Analog of RTRegistry (gfx/rt_registry.hpp:44-183): a host-side pool of
named device tensors with ensure_transient helpers that (re)allocate on
size or kind change and count rebuilds (the reference's Phase-G soak
asserts bounded rebuild counts; same counter here).
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import resolve_device

# kind -> (dtype, channels (0: a plane), clear value)
_KINDS = {
    "color_ldr": (torch.uint8, 3, 0),
    "color_hdr": (torch.float32, 3, 0.0),
    "color_hdr4": (torch.float32, 4, 0.0),
    "depth": (torch.float32, 0, 1.0),
    "motion": (torch.float32, 2, 0.0),
    "shadow": (torch.float32, 0, 1.0),
    "tid": (torch.int32, 0, -1),
}


class RTRegistry:
    """Targets live on `device` (default: the card)."""

    def __init__(self, width: int = 0, height: int = 0, device=None):
        self._extent = (height, width)
        self._targets: dict = {}
        self._meta: dict = {}
        self.rebuild_count = 0
        self.device = resolve_device(device)

    def extent(self):
        return self._extent

    def resize(self, height: int, width: int) -> None:
        if (height, width) != self._extent:
            self._extent = (height, width)
            self._targets.clear()
            self._meta.clear()
            self.rebuild_count += 1

    def ensure_transient(self, name: str, kind: str,
                         height: int | None = None,
                         width: int | None = None):
        """Get-or-create a named target; reallocates (and counts a rebuild)
        when the size or kind changed (rt_registry.hpp:98-180)."""
        if kind not in _KINDS:
            raise KeyError(f"unknown RT kind '{kind}'")
        h = self._extent[0] if height is None else height
        w = self._extent[1] if width is None else width
        dtype, channels, clear = _KINDS[kind]
        shape = (h, w) if channels == 0 else (h, w, channels)
        meta = (kind, shape)
        if self._meta.get(name) != meta:
            if name in self._meta:
                self.rebuild_count += 1
            self._targets[name] = torch.full(shape, clear, dtype=dtype,
                                             device=self.device)
            self._meta[name] = meta
        return self._targets[name]

    def set(self, name: str, value) -> None:
        """Store a produced frame value under a name."""
        self._targets[name] = value
        self._meta.setdefault(name, ("external", tuple(value.shape)))

    def get(self, name: str):
        return self._targets.get(name)

    def valid(self, name: str) -> bool:
        return name in self._targets

    def names(self):
        return tuple(self._targets)
