"""Pass factory registry with pre-instantiation descriptor hints
(port of lsr_tpu/pipeline/registry.py, carried over as it is).

Mirrors PassFactoryRegistry (pass_registry.hpp:35): factories are registered
with descriptors (supported backends / technique modes) that the planner can
query BEFORE instantiating a pass — one of the behaviors the reference's unit
tests pin down (vop_core_tests.cpp:284).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from renderbench.reference.core.frame import TechniqueMode


@dataclasses.dataclass(frozen=True)
class PassDescriptor:
    backends: tuple = ("any",)
    modes: TechniqueMode = TechniqueMode.ALL

    def supports_backend(self, backend: str) -> bool:
        return "any" in self.backends or backend in self.backends

    def supports_mode(self, mode: TechniqueMode) -> bool:
        return bool(self.modes & mode)


class PassFactoryRegistry:
    def __init__(self):
        self._factories: Dict[str, Callable] = {}
        self._descriptors: Dict[str, PassDescriptor] = {}

    def register(self, pass_id: str, factory: Callable,
                 descriptor: Optional[PassDescriptor] = None):
        self._factories[pass_id] = factory
        self._descriptors[pass_id] = descriptor or PassDescriptor()
        return self

    def known(self, pass_id: str) -> bool:
        return pass_id in self._factories

    def descriptor(self, pass_id: str) -> Optional[PassDescriptor]:
        return self._descriptors.get(pass_id)

    def create(self, pass_id: str, **kwargs):
        if pass_id not in self._factories:
            raise KeyError(f"unknown pass id '{pass_id}'")
        return self._factories[pass_id](**kwargs)

    def pass_ids(self):
        return tuple(self._factories)
