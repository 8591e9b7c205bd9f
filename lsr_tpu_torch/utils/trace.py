"""Spans and stages inside the port's frames, off by default.

enable() switches tracing on for the process and disable() off again;
nothing else does (no environment variable, no setting).

- span(name): a host span.  It records its name, start and end
  (time.perf_counter_ns), its parent (the innermost span open when it
  opened) and the frame ordinal (the jit calls begun while tracing).  While
  tracing is on each span is also a torch.profiler.record_function range,
  so a running profiler puts the program's spans on its device trace's
  clock.  Spans are kept in memory until the caller drains them (drain()).
- stage(name): a stage of a frame, a host span plus device marks.  Inside a
  capture that utils.jit makes with tracing on (capturing()), a pair of
  timing events created external=True and recorded into the graph, so that
  every replay times the stage anew, and the kernel, memcpy and memset
  nodes the stage added to the graph being captured (counted by
  csrc/capture_nodes.cu).  In an eager frame, a pair of ordinary CUDA
  events on the current stream once CUDA is in use; on the CPU, the host
  span's own times.
- kept_span(name): a set-up span (the kernel library's load, jit's
  warm-ups and captures), recorded whether tracing is on or not, into
  kept(): a few a key, on no replay's path.
- count(name, value): a frame's counter, a 0-d tensor the frame computes
  only while tracing is on (the frame asks enabled() first), kept by name.
  One computed inside a capture is an output of the captured graph, so
  every replay of that graph writes it anew; counters() reads them on the
  host once the caller has synchronised after the replay it reads.  No
  counter is read inside a frame; enable() forgets those kept.

With tracing off span() and stage() return one shared no-op, so a frame
captured with tracing off is the same graph, node for node, as one
captured without stages.  recording() turns tracing on for a block and
hands its spans to the caller: the pipeline's per-pass timings
(pipeline/executor.execute_plan, PluggablePipeline.execute_segmented) are
spans and stages read that way.

FAMILIES maps every stage name (the flagship frame's stages, the pipeline's
pass ids) to one of six families; the benchmark sums stage times by family.

One tracer serves the process, driven from one thread.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import time

import torch

# The stage families and the stage names of each: frame.py's flagship stages
# and the pass ids of passes/standard_passes.py.
FAMILIES = {
    "cull": ("cull", "scene_cull"),
    "shadows": ("local_atlas", "sun_shadow", "shadow_map", "local_shadows"),
    "raster": ("camera_raster", "depth_prepass", "gbuffer"),
    "lighting": ("lighting", "light_culling", "cluster_build",
                 "cluster_light_assign", "pbr_forward", "pbr_forward_plus",
                 "pbr_forward_clustered", "deferred_lighting",
                 "deferred_lighting_tiled", "sky"),
    "ssao": ("ssao",),
    "post": ("post", "light_shafts", "motion_blur", "bloom",
             "depth_of_field", "taa", "tonemap", "fxaa"),
}
_FAMILY_OF = {name: fam for fam, names in FAMILIES.items() for name in names}

# cudaGraphNodeType values (driver_types.h) and the slots counted.
NODE_TYPES = 16
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 7: "event_record"}
KEPT_MAX = 4096           # set-up spans kept, the oldest dropped first


def family(name: str):
    """The family of a stage name, or None for a name outside FAMILIES."""
    return _FAMILY_OF.get(name)


def node_kinds(counts) -> dict:
    """{"kernel", "memcpy", "memset", "event_record", "other": nodes} of a
    list of counts by cudaGraphNodeType."""
    out = {k: 0 for k in (*NODE_KINDS.values(), "other")}
    for t, n in enumerate(counts):
        out[NODE_KINDS.get(t, "other")] += n
    return out


class _Tracer:
    def __init__(self):
        self.on = False
        self.frames = 0
        self.spans: list = []
        self.kept = collections.deque(maxlen=KEPT_MAX)
        self.open: list = []          # spans open, innermost last
        self.stages: list = []        # stages open, innermost last
        self.capture = None           # the Capture being recorded
        self.counters: dict = {}      # name: the last 0-d tensor counted


_T = _Tracer()
_NOOP = contextlib.nullcontext()


class Span:
    """A host span: name, parent (Span or None), frame (ordinal), start_ns,
    end_ns (perf_counter_ns; None while open)."""

    __slots__ = ("name", "parent", "frame", "start_ns", "end_ns", "_into",
                 "_rf")

    def __init__(self, name: str, into):
        self.name, self._into = name, into
        self.parent = self.end_ns = self._rf = None
        self.frame = self.start_ns = 0

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        self.parent = _T.open[-1] if _T.open else None
        self.frame = _T.frames
        self._into.append(self)
        _T.open.append(self)
        if _T.on:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _T.open.pop()
        return False

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r}, frame {self.frame})"


class Stage(Span):
    """A stage: a Span with device marks.  stage_parent: the enclosing
    Stage or None; nodes: node_kinds of the nodes it added to a captured
    graph (None outside a capture)."""

    __slots__ = ("stage_parent", "nodes", "_events", "_n0")

    def __init__(self, name: str, into):
        super().__init__(name, into)
        self.stage_parent = self.nodes = self._events = self._n0 = None

    def __enter__(self):
        super().__enter__()
        self.stage_parent = _T.stages[-1] if _T.stages else None
        _T.stages.append(self)
        cap = _T.capture
        if cap is not None:
            cap.stages.append(self)
            self._events = (cap.event(), None)
            self._n0 = cap.count()
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            self._events = (e0, None)
        return self

    def __exit__(self, *exc):
        cap = _T.capture
        if self._events is not None:
            if cap is not None:
                n1 = cap.count()
                self.nodes = node_kinds([b - a for a, b in zip(self._n0, n1)])
                e1 = cap.event()
            else:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
            self._events = (self._events[0], e1)
        _T.stages.pop()
        return super().__exit__(*exc)

    def device_ms(self) -> float:
        """The stage's device ms (its last replay, for a captured stage;
        the caller synchronises first); its host ms where it has no
        events."""
        if self._events is None:
            return self.host_ms
        return self._events[0].elapsed_time(self._events[1])


class Capture:
    """The stages of one graph captured with tracing on, in the order they
    opened, and the graph's own device span: an external event pair
    recorded as its first and last nodes.  nodes: node_kinds of the whole
    graph at its last stage's end, before the closing event."""

    def __init__(self, count_nodes):
        self._count_nodes = count_nodes
        self.stages: list = []
        self.nodes = None
        self._events = None

    @staticmethod
    def event():
        e = torch.cuda.Event(enable_timing=True, external=True)
        e.record()
        return e

    def count(self) -> list:
        return self._count_nodes()

    def top(self) -> list:
        """The stages outside any other stage."""
        return [s for s in self.stages if s.stage_parent is None]

    def unstaged(self) -> dict:
        """node_kinds of the graph's nodes outside every top-level stage,
        the graph's and the stages' own events excluded."""
        top = self.top()
        out = dict(self.nodes)
        for s in top:
            for k, n in s.nodes.items():
                out[k] -= n
        # The opening frame event and each top-level stage's own pair.
        out["event_record"] -= 1 + 2 * len(top)
        return out

    def device_ms(self) -> float:
        """The graph's device ms at its last replay (the caller
        synchronises first)."""
        return self._events[0].elapsed_time(self._events[1])


def enable() -> None:
    """Switch tracing on, with no counter kept."""
    _T.on = True
    _T.counters = {}


def disable() -> None:
    """Switch tracing off."""
    _T.on = False


def enabled() -> bool:
    """Whether tracing is on."""
    return _T.on


def span(name: str, new_frame: bool = False):
    """A host span (see the module docstring); the shared no-op while
    tracing is off.  new_frame: the span begins a frame (a jit call), so
    it and the spans after it take the next frame ordinal."""
    if not _T.on:
        return _NOOP
    if new_frame:
        _T.frames += 1
    return Span(name, _T.spans)


def stage(name: str):
    """A stage of a frame (see the module docstring); the shared no-op
    while tracing is off."""
    if not _T.on:
        return _NOOP
    return Stage(name, _T.spans)


def kept_span(name: str) -> Span:
    """A set-up span, recorded into kept() whether tracing is on or not."""
    return Span(name, _T.kept)


def count(name: str, value: torch.Tensor) -> None:
    """Keeps a frame's counter under name, in place of the last one (see
    the module docstring); nothing while tracing is off."""
    if _T.on:
        _T.counters[name] = value


def counters() -> dict:
    """{name: int} of the counters kept, each read on the host: the values
    of the last frame that counted them (a captured one's last replay)."""
    return {k: int(v) for k, v in _T.counters.items()}


def drain() -> list:
    """The spans recorded since the last drain (in the order they opened);
    the tracer forgets them."""
    out, _T.spans = _T.spans, []
    return out


def kept() -> list:
    """The set-up spans kept so far (the last KEPT_MAX), oldest first."""
    return list(_T.kept)


@contextlib.contextmanager
def recording():
    """Tracing on inside the block; yields the list that the spans and
    stages opened inside it are appended to.  The previous state comes back
    after the block; where tracing was on before, the block's spans join
    those drain() returns."""
    was_on, outer = _T.on, _T.spans
    inner: list = []
    _T.on, _T.spans = True, inner
    try:
        yield inner
    finally:
        _T.on, _T.spans = was_on, outer
        if was_on:
            outer.extend(inner)


def _card_nodes(stream) -> list:
    """The capturing graph's nodes by cudaGraphNodeType (kernel library's
    lsr_capture_nodes)."""
    from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

    counts = (ctypes.c_int * NODE_TYPES)()
    check_launch("lsr_capture_nodes", load_kernels().lsr_capture_nodes(
        stream.cuda_stream, counts, NODE_TYPES))
    return list(counts)


@contextlib.contextmanager
def capturing():
    """Around a frame run under torch.cuda.graph with tracing on: yields a
    Capture that collects the frame's stages, each with its event pair and
    its nodes (counted on the current stream, the capturing one), and
    records the graph's opening and closing events.  Yields None with
    tracing off: the graph gets no node of this module."""
    if not _T.on:
        yield None
        return
    stream = torch.cuda.current_stream()
    cap = Capture(lambda: _card_nodes(stream))
    outer, _T.capture = _T.capture, cap
    try:
        e0 = cap.event()
        yield cap
        cap.nodes = node_kinds(cap.count())
        cap._events = (e0, cap.event())
    finally:
        _T.capture = outer
