"""lsr_tpu_torch.utils.trace, the spans and stages inside the port's frames
(CPU): nothing is recorded with tracing off; a flagship frame and an
execute_jitted frame are bit for bit the same with tracing on and off;
their stages come out in the frame's order, nested under jit.call; every
pass id of the six compositions has a family; execute_segmented and
execute still fill pass_ms through stages and spans; and on the recording
fake card (torch_scenes.RecordingCard) a graph captured with tracing on
keeps its stages, their event pairs re-run by every replay and their nodes
counted, while a graph captured with tracing off holds the frame's
operations alone, in the same order.  The clustered grids' occupancy
counters equal what their lists hold, and add no operation to a graph
captured with tracing off.

On the CPU a stage's times are its host span's: CUDA events and the
capture's node counts exist on the card only (renderbench/stages.py reads
them there).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import pytest
import torch

from lsr_tpu_torch import frame as fr
from lsr_tpu_torch.pipeline.executor import RenderContext
from lsr_tpu_torch.utils import jit as jm
from lsr_tpu_torch.utils import trace
from torch_scenes import RecordingCard, preset_pipeline

W, H = 96, 54
FLAGSHIP_STAGES = ["cull", "local_atlas", "sun_shadow", "camera_raster",
                   "lighting", "post"]
SSAO_PASSES = ["scene_cull", "shadow_map", "depth_prepass", "local_shadows",
               "ssao", "pbr_forward", "tonemap", "fxaa"]


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no spans held."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def flagship():
    """make_flagship_frame at 96x54 (ESM, the crop cascade, maps cut to
    128 / 64 / 32) on a 2x2 grid with 16 lights, and one orbit camera."""
    geom, objects, lights, ctx = fr.build_flagship_scene(16, grid=2,
                                                         device="cpu")
    cfg = fr.bench_config("esm", W, H)
    cfg.update(shadow_size=128, local_map=64, local_point=32)
    frame = fr.make_flagship_frame(geom, objects, lights, ctx, W, H, **cfg)
    return frame, fr.flagship_camera(3, ctx, W, H, device="cpu")


def _ssao_frames(n, on):
    """n frames of forward_classic+ssao at 96x54 through execute_jitted,
    tracing on (from the last frame, the first through jit: the first two
    size their capacities) or off; returns the last frame's state and the
    spans of the last frame."""
    pipe, fp, state_fn = preset_pipeline("forward_classic+ssao", W, H)
    ctx = RenderContext()
    for i in range(n):
        if on and i == n - 1:
            trace.drain()
            trace.enable()
        out = pipe.execute_jitted(ctx, state_fn(i), fp)
    trace.disable()
    return out, trace.drain()


def test_off_records_nothing(flagship):
    """With tracing off span and stage are the one shared no-op, and a
    jitted flagship frame and execute_jitted frames record no span."""
    frame, cam = flagship
    assert trace.span("a") is trace.stage("b") is trace.span("c")
    jm.jit(frame)(*cam)
    _ssao_frames(3, on=False)
    assert trace.drain() == []


def test_frames_equal_with_tracing_on_and_off(flagship):
    """The flagship frame at 96x54 through jit and a forward_classic+ssao
    frame through execute_jitted: bit for bit the same outputs with tracing
    on and off."""
    frame, cam = flagship
    jf = jm.jit(frame)
    off = jf(*cam)
    trace.enable()
    on = jf(*cam)
    trace.disable()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    a, _ = _ssao_frames(3, on=False)
    b, spans = _ssao_frames(3, on=True)
    assert spans
    assert torch.equal(a["ldr"], b["ldr"]) and torch.equal(a["hdr"], b["hdr"])


def _stages_under_call(spans):
    call = [s for s in spans if s.name == "jit.call"]
    assert len(call) == 1 and call[0].parent is None
    stages = [s for s in spans if isinstance(s, trace.Stage)]
    for s in stages:
        assert s.parent is call[0] and s.stage_parent is None
        assert s.frame == call[0].frame
        assert call[0].start_ns <= s.start_ns <= s.end_ns <= call[0].end_ns
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns
    return [s.name for s in stages]


def test_stages_in_order_under_jit_call(flagship):
    """One flagship frame's stages and one forward_classic+ssao frame's
    (a stage a pass) come out in the frame's order, one after the other,
    each a child of the frame's jit.call span; the pipeline's flag read
    (checked.flag) follows the call, outside it."""
    frame, cam = flagship
    jf = jm.jit(frame)
    trace.enable()
    jf(*cam)
    assert _stages_under_call(trace.drain()) == FLAGSHIP_STAGES
    _, spans = _ssao_frames(3, on=True)
    assert _stages_under_call(spans) == SSAO_PASSES
    flag = [s for s in spans if s.name == "checked.flag"]
    call = next(s for s in spans if s.name == "jit.call")
    assert len(flag) == 1 and flag[0].parent is None
    assert flag[0].start_ns >= call.end_ns
    assert all(s.host_ms >= 0 for s in spans)


def test_every_pass_id_has_a_family():
    """Every pass id of the five presets and the SSAO composition (under
    FXAA and under the full post stack), every pass the standard registry
    makes, and the flagship's stages map to one of the six families."""
    from lsr_tpu_torch.passes.standard_passes import make_standard_registry
    from lsr_tpu_torch.pipeline.recipe import (
        POST_STACK_PRESETS,
        builtin_render_path_presets,
        compile_recipe,
        ssao_composition_recipe,
    )

    reg = make_standard_registry()
    ids = set(FLAGSHIP_STAGES)
    for post in (("fxaa",), POST_STACK_PRESETS["full"]):
        for r in builtin_render_path_presets() + [ssao_composition_recipe()]:
            rep = compile_recipe(dataclasses.replace(r, post_stack=post), reg)
            assert rep.ok
            ids.update(rep.passes)
    ids.update(reg.create(pid).pass_id for pid in reg._factories)
    assert {trace.family(i) for i in ids} == set(trace.FAMILIES)
    assert all(trace.family(i) in trace.FAMILIES for i in ids)
    assert trace.family("no_such_stage") is None


def test_segmented_and_execute_fill_pass_ms():
    """execute_segmented fills ctx.debug.pass_ms for every executed pass of
    forward_classic+ssao (its stages, on the CPU their host times), and so
    does execute (its host spans), with tracing off and none recorded."""
    pipe, fp, state_fn = preset_pipeline("forward_classic+ssao", W, H)
    for how in ("execute_segmented", "execute"):
        ctx = RenderContext()
        getattr(pipe, how)(ctx, state_fn(0), fp)
        assert list(ctx.debug.pass_ms) == SSAO_PASSES
        assert not ctx.debug.skipped_passes
        assert all(v > 0 for v in ctx.debug.pass_ms.values())
    assert trace.drain() == []


def test_recording_keeps_the_outer_spans():
    """recording() hands the block's spans to its caller and, where tracing
    was on before, to drain() too; the state outside comes back."""
    with trace.recording() as inner:
        with trace.span("a"):
            pass
    assert [s.name for s in inner] == ["a"] and trace.drain() == []
    assert not trace.enabled()
    trace.enable()
    with trace.span("outer") as outer:
        with trace.recording() as inner:
            with trace.stage("b") as st:
                pass
    assert trace.enabled()
    assert [s.name for s in inner] == ["b"] and st.parent is outer
    assert [s.name for s in trace.drain()] == ["outer", "b"]


# ---------------------------------------------------------------------------
# The graph route on the recording fake card
# ---------------------------------------------------------------------------

class _Stamp:
    """A timing event's record on the fake card: a tape entry of its own,
    so a replay records it again."""

    def __init__(self, ev):
        self.ev = ev

    def __call__(self):
        self.ev.t = time.perf_counter_ns()


def _operation(entry) -> bool:
    """A tape entry that stands for a node of a real graph: an aten
    operation or a fake kernel's launch, not a timing event's record nor a
    profiler range's host op (record_function, which adds no node on the
    card)."""
    if isinstance(entry, _Stamp):
        return False
    return not (isinstance(entry, tuple)
                and getattr(entry[0], "namespace", None) == "profiler")


def _fake_card(monkeypatch, traced_events):
    """RecordingCard with the kernels' plain versions as fake kernels (as
    test_torch_jit.py's crop-window test), timing events whose records go
    on the tape, and the capture's node count read off the tape: kernel
    nodes the operations and launches, event-record nodes the stamps."""
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.lighting import resolve_kernel, shade_kernel
    from lsr_tpu_torch.raster import tiled

    card = RecordingCard().install(monkeypatch)
    for owner, name in ((tiled, "rasterize_brute"), (tiled, "_banded_brute"),
                        (shade_kernel, "_shade_plain"),
                        (resolve_kernel, "_resolve_plain"),
                        (ls, "vis_windows_plain"),
                        (ls, "vis_planes_full_plain")):
        card.kernel(monkeypatch, owner, name)

    class Event:
        def __init__(self, enable_timing=False, external=False):
            assert enable_timing and external
            self.t = None

        def record(self):
            stamp = _Stamp(self)
            stamp()
            card.graph.tape.append(stamp)
            traced_events.append(self)

        def elapsed_time(self, other):
            return (other.t - self.t) / 1e6

    def nodes(stream):
        counts = [0] * trace.NODE_TYPES
        for entry in card.graph.tape:
            if isinstance(entry, _Stamp):
                counts[7] += 1
            elif _operation(entry):
                counts[0] += 1
        return counts

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(trace, "_card_nodes", nodes)
    return card


def test_graph_keeps_its_stages(monkeypatch, flagship):
    """The flagship frame through jit on the fake card, tracing on: warm-up,
    capture, replays.  The graph keeps its six stages in order with their
    node counts (each stage's operations; with the graph's unstaged ones
    they make up the whole graph), a replay re-times them (stage_ms: each
    within the graph's own span), and the frames equal the eager frame.
    The set-up spans jit.warm_up and jit.capture (children record,
    instantiate, first_replay) are kept; the frame's spans are drained."""
    frame, cam = flagship
    eager = frame(*cam)
    events = []
    _fake_card(monkeypatch, events)
    kept0 = len(trace.kept())
    trace.enable()
    jf = jm.jit(frame)
    outs = [jf(*cam) for _ in range(3)]
    assert jf.captures == 1
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
    cap = jf.last.trace
    assert [s.name for s in cap.stages] == FLAGSHIP_STAGES
    assert cap.top() == cap.stages
    assert all(s.nodes["kernel"] > 0 for s in cap.stages)
    assert all(s.nodes["event_record"] == 0 for s in cap.stages)
    un = cap.unstaged()
    assert un["event_record"] == 0 and un["kernel"] > 0
    assert cap.nodes["kernel"] == sum(s.nodes["kernel"] for s in cap.stages
                                      ) + un["kernel"]
    tape = jf.last.graph.tape
    assert cap.nodes["kernel"] == sum(map(_operation, tape))
    before = {id(e): e.t for e in events}
    jf(*cam)
    assert all(e.t != before[id(e)] for e in events)     # re-timed
    ms = jf.stage_ms()
    assert list(ms) == FLAGSHIP_STAGES
    assert 0 <= sum(ms.values()) <= cap.device_ms()
    kept = trace.kept()[kept0:]
    names = [s.name for s in kept]
    assert names.count("jit.warm_up") == 1
    capture = next(s for s in kept if s.name == "jit.capture")
    kids = [s.name for s in kept if s.parent is capture]
    assert kids == ["jit.capture.record", "jit.capture.instantiate",
                    "jit.capture.first_replay"]
    assert all(s.end_ns is not None for s in kept)
    spans = trace.drain()
    assert [s.name for s in spans].count("jit.call") == 4
    assert {"jit.key", "jit.copy_in", "jit.replay",
            "jit.clone_out"} <= {s.name for s in spans}


def test_untraced_graph_holds_the_frame_alone(monkeypatch, flagship):
    """Captured with tracing off, the fake card's graph holds no event
    record and no stage; with tracing on it holds the same operations, in
    the same order, and the stages' event pairs besides (the fake card also
    tapes the spans' record_function host ops, which add no node on the
    card: left out of the comparison)."""
    frame, cam = flagship
    tapes = []
    for on in (False, True):
        _fake_card(monkeypatch, [])
        if on:
            trace.enable()
        jf = jm.jit(frame)
        for _ in range(2):
            jf(*cam)
        trace.disable()
        g = jf.last
        tape = g.graph.tape
        tapes.append([e[0] if isinstance(e, tuple) else type(e).__name__
                      for e in tape if _operation(e)])
        stamps = sum(isinstance(e, _Stamp) for e in tape)
        assert (g.trace is not None) == on
        assert stamps == (2 + 2 * len(FLAGSHIP_STAGES) if on else 0)
        assert bool(jf.stage_ms()) == on
    assert tapes[0] == tapes[1]


# ---------------------------------------------------------------------------
# The clustered grids' occupancy counters
# ---------------------------------------------------------------------------

CLUSTER_CAP = 4     # 48 lights at 96x54: some 16-px clusters overflow it


def _clustered():
    """clustered_forward at 96x54 (maps cut) with CLUSTER_CAP lights a
    cluster (B2b's lists: twice that)."""
    pipe, fp, state_fn = preset_pipeline("clustered_forward", W, H)
    fp.technique.max_lights_per_tile = CLUSTER_CAP
    return pipe, fp, state_fn


def _occupancy(lights, cam, tile_w, tile_h, cap, slices):
    """(entries, lists at cap, largest count before the cap) of a clustered
    binning, worked out from its lists, and the largest count from the
    same binning with room for every light."""
    from lsr_tpu_torch.lighting.light_culling import cull_lights_clustered

    def binned(c):
        return cull_lights_clustered(lights, cam.view, cam.proj, cam.zn,
                                     cam.zf, W, H, tile_size=tile_w,
                                     tile_h=tile_h, cap=c, slices=slices)

    n = (binned(cap)[0] >= 0).sum(1)
    raw = (binned(lights.count)[0] >= 0).sum(1)
    return int(n.sum()), int((n == cap).sum()), int(raw.max())


def test_occupancy_counters_equal_the_lists():
    """A clustered_forward frame on the CPU with tracing on: cluster_grid's
    counters (list entries, clusters at their cap, the largest count before
    the cap) are those of the frame's light grid, worked out from its
    lists, and b2b_lists' those of B2b's lists (64x128 tiles, twice the
    cap) binned again from the frame's lights and camera; some clusters of
    each overflow.  With tracing off a frame keeps no counter."""
    pipe, fp, state_fn = _clustered()
    trace.enable()
    st = pipe.execute_jitted(RenderContext(), state_fn(0), fp)
    trace.disable()
    got = trace.counters()
    slices, cam = fp.technique.cluster_slices, st["camera"]
    lists = st["light_grid"]["lists"]
    n = (lists >= 0).sum(1)
    assert lists.shape[1] == CLUSTER_CAP
    assert int(n.sum()) == int(st["light_grid"]["counts"].sum())
    want = {"cluster_grid": _occupancy(st["lights"], cam, 16, 16,
                                       CLUSTER_CAP, slices),
            "b2b_lists": _occupancy(st["lights"], cam, 128, 64,
                                    2 * CLUSTER_CAP, slices)}
    assert want["cluster_grid"][:2] == (int(n.sum()),
                                        int((n == CLUSTER_CAP).sum()))
    assert got == {f"{grid}.{k}": v for grid, vals in want.items()
                   for k, v in zip(("entries", "full", "max_count"), vals)}
    assert want["cluster_grid"][2] > CLUSTER_CAP
    assert want["b2b_lists"][2] > 2 * CLUSTER_CAP
    trace.enable()
    trace.disable()
    pipe.execute_jitted(RenderContext(), state_fn(1), fp)
    assert trace.counters() == {}


def test_counters_add_no_node_with_tracing_off(monkeypatch):
    """clustered_forward through execute_jitted on the fake card (two
    sizing frames, the warm-up, the capture).  Captured with tracing off,
    its graph holds the same operations, in the same order, with the
    occupancy counters wired in as with them stubbed out; captured with
    tracing on, it holds those operations and, besides the stages' event
    pairs, the counters' own alone: for each of the two grids a sum of the
    counts, a compare with the cap and its sum."""
    from lsr_tpu_torch.lighting import shade_kernel
    from lsr_tpu_torch.passes import standard_passes

    def ops(on, counting):
        with monkeypatch.context() as m:
            _fake_card(m, [])
            if not counting:
                for mod in (standard_passes, shade_kernel):
                    m.setattr(mod, "count_occupancy", lambda *a: None)
            pipe, fp, state_fn = _clustered()
            ctx = RenderContext()
            if on:
                trace.enable()
            for i in range(4):
                pipe.execute_jitted(ctx, state_fn(i), fp)
            trace.disable()
            j = pipe._jitted.jitted
            assert j.captures == 1 and (j.last.trace is not None) == on
            return [e[0] if isinstance(e, tuple) else type(e).__name__
                    for e in j.last.graph.tape if _operation(e)]

    off = ops(False, True)
    assert off == ops(False, False)
    on = ops(True, True)
    it = iter(on)             # off is a subsequence of on
    assert all(any(op == x for x in it) for op in off)
    assert len(on) - len(off) == 6
    added = collections.Counter(map(str, on)) - collections.Counter(
        map(str, off))
    assert added == {"aten.sum.default": 4, "aten.eq.Scalar": 2}
