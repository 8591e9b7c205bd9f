"""ECS-lite world + system processors; copied from lsr_tpu/scene/world.py.

Analog of scene/world.hpp:20 and scene/system_processors (the reference's
DOD/ECS Constitution III): entities are integer ids, components live in
per-type stores, systems are callables processed in registration order
(the SystemProcessor::process loop of the classic demos,
hello_multi_pass.cpp:1120).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class World:
    def __init__(self):
        self._next_id = 0
        self._alive: set = set()
        self._stores: Dict[str, Dict[int, Any]] = {}

    def create_entity(self) -> int:
        eid = self._next_id
        self._next_id += 1
        self._alive.add(eid)
        return eid

    def destroy_entity(self, eid: int) -> None:
        self._alive.discard(eid)
        for store in self._stores.values():
            store.pop(eid, None)

    def is_alive(self, eid: int) -> bool:
        return eid in self._alive

    def add_component(self, eid: int, name: str, value) -> None:
        if eid not in self._alive:
            raise KeyError(f"entity {eid} not alive")
        self._stores.setdefault(name, {})[eid] = value

    def get_component(self, eid: int, name: str, default=None):
        return self._stores.get(name, {}).get(eid, default)

    def remove_component(self, eid: int, name: str) -> None:
        self._stores.get(name, {}).pop(eid, None)

    def entities_with(self, *names: str):
        """Iterate (eid, comp1, comp2, ...) for entities owning all names."""
        if not names:
            return
        stores = [self._stores.get(n, {}) for n in names]
        base = min(stores, key=len)
        for eid in sorted(base):
            if all(eid in s for s in stores):
                yield (eid, *(s[eid] for s in stores))

    def count(self, name: str) -> int:
        return len(self._stores.get(name, {}))


class SystemProcessor:
    """Ordered system runner (scene/system_processors analog)."""

    def __init__(self):
        self._systems: List[Callable] = []

    def register(self, system: Callable):
        self._systems.append(system)
        return self

    def process(self, world: World, dt: float):
        for system in self._systems:
            system(world, dt)
