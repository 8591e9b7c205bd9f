"""Finite state machine + value command pattern; copied from
lsr_tpu/logic/state_machine.py.

Analog of logic/state_machine.hpp:24 (callback FSM with prioritized,
predicate-driven transitions and enter/update/exit hooks) and the input
command pattern (input/command*.hpp — `reduce_all` value variant).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class StateCallbacks:
    on_enter: Optional[Callable] = None
    on_update: Optional[Callable] = None   # (ctx, dt, elapsed)
    on_exit: Optional[Callable] = None


@dataclasses.dataclass
class TransitionRule:
    from_state: Any
    to_state: Any
    predicate: Callable  # (ctx, elapsed) -> bool
    priority: int = 0


class StateMachine:
    """Priority-ordered predicate transitions; higher priority wins ties
    (state_machine.hpp transition evaluation)."""

    def __init__(self):
        self._states: Dict[Any, StateCallbacks] = {}
        self._transitions: List[TransitionRule] = []
        self._current: Any = None
        self._elapsed = 0.0

    def add_state(self, state_id, callbacks: StateCallbacks | None = None) -> bool:
        if state_id in self._states:
            return False
        self._states[state_id] = callbacks or StateCallbacks()
        return True

    def has_state(self, state_id) -> bool:
        return state_id in self._states

    def add_transition(self, from_state, to_state, predicate, priority=0) -> bool:
        if predicate is None or from_state not in self._states \
                or to_state not in self._states:
            return False
        self._transitions.append(
            TransitionRule(from_state, to_state, predicate, priority)
        )
        return True

    @property
    def current(self):
        return self._current

    @property
    def elapsed(self):
        return self._elapsed

    def start(self, state_id, ctx=None) -> bool:
        if state_id not in self._states:
            return False
        self._current = state_id
        self._elapsed = 0.0
        cb = self._states[state_id]
        if cb.on_enter:
            cb.on_enter(ctx)
        return True

    def update(self, ctx, dt: float):
        if self._current is None:
            return
        self._elapsed += dt
        cb = self._states[self._current]
        if cb.on_update:
            cb.on_update(ctx, dt, self._elapsed)

        candidates = [
            t for t in self._transitions
            if t.from_state == self._current and t.predicate(ctx, self._elapsed)
        ]
        if candidates:
            best = max(candidates, key=lambda t: t.priority)
            if cb.on_exit:
                cb.on_exit(ctx)
            self._current = best.to_state
            self._elapsed = 0.0
            nxt = self._states[self._current]
            if nxt.on_enter:
                nxt.on_enter(ctx)


# --- value command pattern ---------------------------------------------------

class Command:
    """A command is a pure value transform: apply(state) -> new state."""

    def apply(self, state):
        raise NotImplementedError


def reduce_all(state, commands):
    """Fold commands over state (the camera_commands.hpp reduce_all variant)."""
    for c in commands:
        state = c.apply(state)
    return state
