"""jit: a whole frame as one captured CUDA graph, the port's counterpart of
jax.jit for frames.

lsr_tpu runs a frame as one compiled program: bench.py:344 calls
jax.jit(frame) and reads its outputs at the end, and
PluggablePipeline.execute_jitted (lsr_tpu/pipeline/pipeline.py:104-134)
traces the whole plan into one program.  jit(fn) gives the port the same
execution model on the card: the frame's kernels and torch ops are captured
once into a torch.cuda.CUDAGraph and replayed, with no host round-trip in
mid-frame.

Calls are keyed as jax.jit keys its traces: the tree structure of the
arguments (dicts, lists, tuples and dataclasses, the port's frozen ones
among them), each tensor leaf's shape, stride, dtype and device, and the
value of every other leaf.  CameraState.zn / zf are 0-d f32 tensors (data,
as lsr_tpu's data fields are), keyed by shape and dtype only: one graph
serves every near / far plane.  LightsSoA.kinds / apow1 and
ShadeContext.surface_maps stay host leaves on purpose: lsr_tpu makes them
static too (light_kinds is a static argname of its shade and resolve
kernels, shade_kernel.py:363, resolve_kernel.py:69-75), so another light
set or material layout is another program there as here.  A value that
changes every frame must reach the frame as a tensor, or every frame
captures.

For CUDA inputs, the calls of one key are:
- the first: fn runs eagerly on a side stream (the warm-up that
  torch.cuda.graphs asks for: kernels get built and the frame's constants
  made, device_const memoised) and its outputs are returned;
- the second: fn is captured into a graph under CaptureCheck and the graph
  is replayed; a temporal frame whose first call lacks its history (TAA,
  visibility hysteresis) has another key there, so each path captures once;
- every later one: each tensor leaf of the arguments is copied into the
  graph's static inputs and the graph is replayed.
Outputs are fresh tensors on every call, copies out of the static outputs
(a caller that keeps frame i still holds frame i after frame i + 1); an
output that is an argument returns the caller's own tensor.  Tensors the
function closes over are read where they lie at every replay, as a jitted
JAX function holds its constants.

Each Jitted holds at most MAX_GRAPHS (8) captured graphs, and remembers at
most as many keys warmed up and not yet captured: a ninth key evicts the
least recently used graph, whose memory is released (its static tensors
dropped, then CUDAGraph.reset()), and evictions counts it.  A caller that
cycles through more than MAX_GRAPHS keys (nine target widths, the nine
models of hello_shading_models) warms up more than it replays, but never
holds more than MAX_GRAPHS graphs, each as large as the frame's
intermediates.

The kernel wrappers count launches where they launch (launch_counters()).
The capture moves those counters without launching anything, so jit takes
that move back and adds it on every replay: the counts stay exact per frame.

Spans (utils.trace): with tracing on, a call is the span jit.call, with the
children jit.key, jit.copy_in, jit.replay and jit.clone_out, and a key
captured while tracing is on keeps the frame's stages with their graph
events and node counts: stage_ms() reads each stage's device ms at the last
replay.  The set-up spans jit.warm_up and jit.capture (children
jit.capture.record, the frame run under torch.cuda.graph and CaptureCheck;
jit.capture.instantiate, the capture's end and the graph's instantiation;
jit.capture.first_replay) are kept whether tracing is on or not.

CPU inputs call fn eagerly: the caller asked for the CPU (the tests' route).
On the card there is no fallback: a capture that fails raises and names the
operation at fault, and never runs the eager frame instead.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from lsr_tpu_torch.utils import trace


def launch_counters():
    """[(owner, attribute)] of every kernel wrapper's launch counter.

    chip_smoke.py's launch checks read every counter listed here and hold
    each to 0 where a check does not name it; a counter that its phases
    check apart from whole frames (as B1b's bands, V1, V2 and S1) is also
    named in chip_smoke.APART."""
    from lsr_tpu_torch.audio import engine_synth
    from lsr_tpu_torch.lighting import fplus_kernel, light_runtime
    from lsr_tpu_torch.lighting import resolve_kernel, shade_kernel, vis_kernel
    from lsr_tpu_torch.raster import slot_setup, tiled

    return [(tiled.rasterize_direct, "launches"),
            (tiled.rasterize_direct, "band_launches"),
            (tiled.rasterize_tiled, "launches"),
            (tiled.rasterize_chunklist, "launches"),
            (shade_kernel.shade_fused, "launches"),
            (resolve_kernel.resolve_fused, "launches"),
            (fplus_kernel.accumulate_lights, "launches"),
            (vis_kernel.vis_windows, "launches"),
            (vis_kernel.vis_planes, "launches"),
            (light_runtime.accumulate_local_lights, "launches"),
            (slot_setup.slot_inputs, "launches"),
            (engine_synth.synthesize, "launches")]


# ---------------------------------------------------------------------------
# The key: tree structure, tensor metadata, host values
# ---------------------------------------------------------------------------

def _host_key(x):
    """A hashable key for a host leaf, equal for equal values (a float by
    its bits, so -0.0 and NaN key as themselves)."""
    if isinstance(x, float):
        return (float, x.hex())
    if isinstance(x, np.ndarray):
        return (np.ndarray, x.shape, x.dtype.str, x.tobytes())
    if isinstance(x, np.generic):
        return (type(x), x.tobytes())
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"jit: cannot key a leaf of type {type(x).__name__}"
                        ) from None
    return (type(x), x)


def flatten(tree, leaves: list, hosts: list):
    """The structure of tree as a hashable spec; its tensor leaves are
    appended to leaves and its other leaves to hosts."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("T", tuple(tree.shape), tree.stride(), tree.dtype,
                tree.device)
    if isinstance(tree, dict):
        keys = tuple(tree)
        return ("dict", type(tree), keys,
                tuple(flatten(tree[k], leaves, hosts) for k in keys))
    if isinstance(tree, (list, tuple)):
        return ("seq", type(tree),
                tuple(flatten(v, leaves, hosts) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        extra = set(getattr(tree, "__dict__", {})) - set(names)
        if extra:
            raise TypeError(f"jit: {type(tree).__name__} carries attributes "
                            f"outside its fields: {sorted(extra)}")
        return ("dc", type(tree), names,
                tuple(flatten(getattr(tree, n), leaves, hosts)
                      for n in names))
    hosts.append(tree)
    return ("H", _host_key(tree))


def unflatten(spec, leaves, hosts):
    """The tree of spec with its tensors from the iterator leaves and its
    host values from the iterator hosts."""
    kind = spec[0]
    if kind == "T":
        return next(leaves)
    if kind == "H":
        return next(hosts)
    if kind == "dict":
        _, cls, keys, kids = spec
        return cls((k, unflatten(s, leaves, hosts))
                   for k, s in zip(keys, kids))
    if kind == "seq":
        _, cls, kids = spec
        vals = [unflatten(s, leaves, hosts) for s in kids]
        if cls in (list, tuple):
            return cls(vals)
        return cls(*vals) if hasattr(cls, "_fields") else cls(vals)
    _, cls, names, kids = spec
    obj = cls.__new__(cls)
    for n, s in zip(names, kids):
        object.__setattr__(obj, n, unflatten(s, leaves, hosts))
    return obj


def trace_key(args, kwargs=None):
    """jit's key of a call: (spec, tensor leaves, host values)."""
    leaves, hosts = [], []
    spec = flatten((tuple(args), dict(kwargs or {})), leaves, hosts)
    return spec, leaves, hosts


# ---------------------------------------------------------------------------
# What a capture cannot hold
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# Ops whose output shape depends on the data: each reads a count on the host.
_DATA_SHAPED = {
    _aten.nonzero.default, _aten.nonzero_numpy.default,
    _aten.argwhere.default, _aten.masked_select.default,
    _aten._unique.default, _aten._unique2.default, _aten.unique_dim.default,
    _aten.unique_consecutive.default, _aten.unique_dim_consecutive.default,
    _aten.bincount.default,
}
# Ops that return a host value.
_HOST_READS = {
    _aten._local_scalar_dense.default, _aten.is_nonzero.default,
    _aten.equal.default, _aten.allclose.default,
}
_INDEXING = {
    _aten.index.Tensor, _aten.index_put.default, _aten.index_put_.default,
    _aten._index_put_impl_.default,
}
_COPIES = {_aten._to_copy.default, _aten.copy_.default}
# Tensor methods that read values on the host; constructors that make a
# tensor from host data (a constant upload).
_HOST_METHODS = {
    torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
    torch.Tensor.cpu, torch.Tensor.__bool__, torch.Tensor.__int__,
    torch.Tensor.__float__, torch.Tensor.__index__, torch.Tensor.__array__,
}
_FROM_HOST = {torch.tensor, torch.as_tensor, torch.asarray,
              torch.from_numpy, torch.Tensor.new_tensor}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class CaptureError(RuntimeError):
    """An operation a captured frame cannot hold."""


class CaptureCheck:
    """While active, refuses what a CUDA graph cannot capture, naming the
    operation: a host read of a tensor's value (item, bool, int, tolist,
    numpy, cpu; aten._local_scalar_dense), an op whose output shape
    depends on the data (nonzero, masked_select, unique, boolean indexing,
    repeat_interleave without output_size), a tensor made from host data
    (torch.tensor, as_tensor, from_numpy: a constant uploaded inside the
    frame) and a copy between the host and the card.  jit captures under
    it; the tests run warm frames under it on the CPU, with the kernels'
    plain versions exempt (pause()).  last_op names the last operation
    seen."""

    def __init__(self):
        self.last_op = None
        self._active = self._paused = 0
        check = self

        class _Functions(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                check._function(func, args, kwargs)
                return func(*args, **kwargs)

        class _Dispatch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                check._dispatch(func, args, kwargs)
                return func(*args, **kwargs)

        self._modes = (_Functions(), _Dispatch())

    def _fail(self, what):
        raise CaptureError(f"{what} (under capture; the frame must keep its "
                           f"values on the device)")

    def _function(self, func, args, kwargs):
        self.last_op = getattr(func, "__qualname__", repr(func))
        if func in _HOST_METHODS:
            self._fail(f"host read: Tensor.{func.__name__}")
        if func in _FROM_HOST:
            data = args[1 if func is torch.Tensor.new_tensor else 0]
            # A 0-d tensor on the host is a scalar operand, read by value.
            if not isinstance(data, torch.Tensor) and (
                    np.ndim(data) or kwargs.get("device") is not None):
                self._fail(f"constant upload: {self.last_op} of host data")

    def _dispatch(self, func, args, kwargs):
        self.last_op = str(func)
        if func in _HOST_READS:
            self._fail(f"host read: {func}")
        if func in _DATA_SHAPED:
            self._fail(f"data-dependent output shape: {func}")
        if (func is _aten.repeat_interleave.Tensor
                and kwargs.get("output_size") is None):
            self._fail(f"data-dependent output shape: {func} without "
                       f"output_size")
        if func in _INDEXING:
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(t.dtype in (torch.bool, torch.uint8)
                   for t in _tensors(list(idx))):
                self._fail(f"data-dependent output shape: {func} with a "
                           f"boolean index")
        if (func in (_aten.lift_fresh.default, _aten.lift_fresh_copy.default)
                and args[0].dim()):
            self._fail(f"constant upload: {func} (a list index?)")
        if func in _COPIES:
            if func is _aten.copy_.default:
                dst, src = args[0].device, args[1].device
            else:
                src = args[0].device
                dst = torch.device(kwargs.get("device") or src)
            if dst.type != src.type:
                self._fail(f"host copy: {func} from {src.type} to "
                           f"{dst.type}")

    @contextlib.contextmanager
    def pause(self):
        """A context in which nothing is checked (a plain version): the
        modes step aside, so the code inside runs at full speed."""
        if self._paused or not self._active:
            yield
            return
        self._paused = 1
        for m in reversed(self._modes):
            m.__exit__(None, None, None)
        try:
            yield
        finally:
            for m in self._modes:
                m.__enter__()
            self._paused = 0

    def __enter__(self):
        for m in self._modes:
            m.__enter__()
        self._active = 1
        return self

    def __exit__(self, *exc):
        self._active = 0
        for m in reversed(self._modes):
            m.__exit__(*exc)


# ---------------------------------------------------------------------------
# jit
# ---------------------------------------------------------------------------

def _card_device(leaves):
    """The device of the first CUDA tensor leaf; None when every leaf lies
    on the CPU (the eager route)."""
    return next((t.device for t in leaves if t.device.type == "cuda"), None)


def _counts(counters):
    return [getattr(o, a) for o, a in counters]


def _set_counts(counters, values):
    for (o, a), v in zip(counters, values):
        setattr(o, a, v)


# Graphs (and keys warmed up, not yet captured) a Jitted holds at most.
MAX_GRAPHS = 8


class _Graph:
    """One captured key: static inputs, the graph, its static outputs, and
    what each launch counter moved during the capture; capture_ms (host
    time of the capture and the graph's instantiation) and pool_bytes (the
    device memory the static inputs and the graph's private pool took).
    trace: the trace.Capture of its stages where it was captured with
    tracing on, else None; outside_ops: the device copies a call makes
    outside the graph (into the static inputs, out of the static
    outputs)."""

    def __init__(self, fn, name, spec, leaves, hosts, dev):
        t0 = time.perf_counter()
        # torch.cuda.graph releases the cached blocks first; so does this,
        # so that the reserved memory's growth is what the capture took.
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.static_in = [torch.empty_like(t).copy_(t) for t in leaves]
        args, kwargs = unflatten(spec, iter(self.static_in), iter(hosts))
        counters = launch_counters()
        before = _counts(counters)
        self.graph = torch.cuda.CUDAGraph()
        check = CaptureCheck()
        try:
            capture = torch.cuda.graph(self.graph)
            with trace.kept_span("jit.capture.record"):
                capture.__enter__()
                try:
                    with trace.capturing() as self.trace, check:
                        out = fn(*args, **kwargs)
                except BaseException:
                    capture.__exit__(*sys.exc_info())
                    raise
            with trace.kept_span("jit.capture.instantiate"):
                capture.__exit__(None, None, None)
        except Exception as e:
            _set_counts(counters, before)
            raise CaptureError(f"jit: capturing {name} failed at "
                               f"{check.last_op}: {e}") from e
        self.deltas = [(c, a - b) for c, a, b in
                       zip(counters, _counts(counters), before) if a != b]
        _set_counts(counters, before)
        out_leaves, self.out_hosts = [], []
        self.out_spec = flatten(out, out_leaves, self.out_hosts)
        pos = {id(t): i for i, t in enumerate(self.static_in)}
        # For each output leaf: the index of the argument it is, or -1.
        self.out_arg = [pos.get(id(t), -1) for t in out_leaves]
        self.static_out = out_leaves
        self.outside_ops = (
            sum(1 for t in self.static_in if t.is_cuda and t.numel())
            + len({id(t) for t, j in zip(out_leaves, self.out_arg)
                   if j < 0 and t.is_cuda and t.numel()}))
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def release(self):
        """Frees the graph: the static tensors first, so that its private
        pool holds no live block, then the graph itself."""
        self.static_in = self.static_out = None
        self.graph.reset()

    def __call__(self, leaves):
        with trace.span("jit.copy_in"):
            for dst, src in zip(self.static_in, leaves):
                dst.copy_(src)
        with trace.span("jit.replay"):
            self.graph.replay()
        for (owner, attr), d in self.deltas:
            setattr(owner, attr, getattr(owner, attr) + d)
        with trace.span("jit.clone_out"):
            fresh, outs = {}, []
            for t, j in zip(self.static_out, self.out_arg):
                if j >= 0:
                    outs.append(leaves[j])
                else:
                    if id(t) not in fresh:
                        fresh[id(t)] = t.clone()
                    outs.append(fresh[id(t)])
        return unflatten(self.out_spec, iter(outs), iter(self.out_hosts))


class Jitted:
    """jit(fn): see the module docstring.  graphs maps each captured key to
    its _Graph, least recently used first (at most MAX_GRAPHS; pool_bytes:
    the memory each took); captures counts the graphs made and evictions
    those released; last is the _Graph replayed last."""

    def __init__(self, fn, name=None):
        self.fn = fn
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self._warm: collections.OrderedDict = collections.OrderedDict()
        self._side = None
        self.last = None              # the _Graph replayed last
        self.captures = self.evictions = 0

    def __call__(self, *args, **kwargs):
        with trace.span("jit.call", new_frame=True):
            with trace.span("jit.key"):
                spec, leaves, hosts = trace_key(args, kwargs)
            if not leaves:
                raise ValueError(f"jit: {self.name} got no tensor argument, "
                                 f"so its device is unknown")
            dev = _card_device(leaves)
            if dev is None:
                return self.fn(*args, **kwargs)
            g = self.graphs.get(spec)
            if g is None and spec in self._warm:
                return self._capture(spec, leaves, hosts, dev)
            if g is not None:
                self.graphs.move_to_end(spec)
                return self._replay(g, leaves)
            return self._warm_up(spec, dev, args, kwargs)

    def _capture(self, spec, leaves, hosts, dev):
        del self._warm[spec]
        # Make room first: the evicted graph's memory is free for this
        # capture.
        while len(self.graphs) >= MAX_GRAPHS:
            self._evict(self.graphs.popitem(last=False)[1])
        with trace.kept_span("jit.capture"):
            g = _Graph(self.fn, self.name, spec, leaves, hosts, dev)
            self.graphs[spec] = g
            self.captures += 1
            with trace.kept_span("jit.capture.first_replay"):
                return self._replay(g, leaves)

    def _replay(self, g, leaves):
        self.last = g
        return g(leaves)

    def stage_ms(self) -> dict:
        """{stage name: device ms} of the last replay of the graph replayed
        last, where that graph was captured with tracing on; {} otherwise.
        The caller synchronises first."""
        cap = self.last.trace if self.last is not None else None
        return {s.name: s.device_ms() for s in cap.stages} if cap else {}

    def warm_up(self, *args, **kwargs):
        """fn eagerly as the warm-up of this call's key: its next call
        captures (a CPU call just runs fn)."""
        spec, leaves, _ = trace_key(args, kwargs)
        dev = _card_device(leaves)
        if dev is None:
            return self.fn(*args, **kwargs)
        return self._warm_up(spec, dev, args, kwargs)

    def forget(self, *args, **kwargs):
        """Releases the graph of this call's key and forgets its warm-up: a
        key that cannot come again (its checked capacities have grown)."""
        spec = trace_key(args, kwargs)[0]
        g = self.graphs.pop(spec, None)
        if g is not None:
            self._evict(g)
        self._warm.pop(spec, None)

    def _evict(self, g):
        g.release()
        self.evictions += 1

    def _warm_up(self, spec, dev, args, kwargs):
        self._warm[spec] = None
        self._warm.move_to_end(spec)
        while len(self._warm) > MAX_GRAPHS:
            self._warm.popitem(last=False)
        cur = torch.cuda.current_stream(dev)
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        self._side.wait_stream(cur)
        with trace.kept_span("jit.warm_up"), torch.cuda.stream(self._side):
            out = self.fn(*args, **kwargs)
        cur.wait_stream(self._side)
        return out


def jit(fn, name=None) -> Jitted:
    """fn as one captured program on the card (see the module docstring)."""
    return Jitted(fn, name)
