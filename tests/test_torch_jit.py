"""lsr_tpu_torch.utils.jit, the one-program frame (CPU): jit's key, its
graph route (capture, replay, launch accounting, fresh outputs, the cache
bounded at MAX_GRAPHS) on a fake card, utils.capacity's checked wrapper
there (the sizing call, the redo of an exceeded frame on a replay and on
the capture call), CaptureCheck and device_const, and the flagship frame
and execute_jitted through jit against the eager frame and lsr_tpu's.

On the CPU jit runs the function eagerly (the caller asked for the CPU), so
the graph route is driven here by a fake card (fake_card): torch.cuda's
graph, stream and memory calls replaced by stand-ins whose graph records
the launches of fake kernels while "capturing" and runs them again on
replay, as a CUDA graph replays its kernels without running Python.

CaptureCheck, the class jit captures under on the card, refuses each kind
of operation a graph cannot hold; test_torch_jit_guard.py runs it over
warm frames.

Tolerances: jit's CPU route and the eager frame, bit for bit; the jitted
frame against lsr_tpu's op-by-op frame, C1's contract as in
test_torch_frame.py (LDR within 1 LSB on >= 99.9% of pixels, the frame's
counts equal).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from lsr_tpu_torch.core import util
from lsr_tpu_torch.utils import jit as jm
from torch_scenes import (
    jax_camera,
    jax_flagship_scene,
    jax_reference_stages,
    preset_pipeline,
    to_torch,
)


def _cam(w=32, h=24, zn=0.1, zf=100.0, eye=(1.0, 2.0, -3.0)):
    from lsr_tpu_torch.scene.scene import make_camera

    return make_camera(w, h, eye, (0, 0, 0), zn=zn, zf=zf, device="cpu")


# ---------------------------------------------------------------------------
# The key
# ---------------------------------------------------------------------------

def test_key_keeps_tensor_values():
    """Another camera position (tensor values) keeps the key."""
    a, b = _cam(), _cam(eye=(2.0, 1.0, -4.0))
    assert not torch.equal(a.viewproj, b.viewproj)
    assert jm.trace_key((a,))[0] == jm.trace_key((b,))[0]


@pytest.mark.parametrize("change", ["shape", "dtype", "zn", "zf", "stride",
                                    "structure"])
def test_key_changes(change):
    """A tensor's shape, dtype or strides or the tree's structure make a new
    key; another CameraState.zn / zf keeps it: they are 0-d f32 tensors,
    data as lsr_tpu traces them, keyed by shape and dtype only."""
    from lsr_tpu_torch.scene.scene import f32_scalar

    cam = _cam()
    x = torch.zeros(4, 6)
    other = {"shape": (cam, torch.zeros(4, 5)),
             "dtype": (cam, torch.zeros(4, 6, dtype=torch.float64)),
             "zn": (dataclasses.replace(cam, zn=f32_scalar(0.2, "cpu")), x),
             "zf": (dataclasses.replace(cam, zf=f32_scalar(50.0, "cpu")), x),
             "stride": (cam, torch.zeros(6, 4).t()),
             "structure": (cam, [x])}[change]
    same = jm.trace_key((cam, x))[0] == jm.trace_key(other)[0]
    assert same == (change in ("zn", "zf"))
    assert cam.zn.shape == () and cam.zn.dtype == torch.float32


def test_flatten_round_trip():
    """unflatten(flatten(tree)) rebuilds dicts, tuples, lists and frozen
    dataclasses with the same leaves."""
    cam = _cam()
    tree = {"camera": cam, "pair": (torch.ones(2), 3.5), "names": ["a", None]}
    spec, leaves, hosts = jm.trace_key((tree,))
    (back,), kw = jm.unflatten(spec, iter(leaves), iter(hosts))
    assert kw == {} and back["pair"][1] == 3.5 and back["names"] == ["a", None]
    assert isinstance(back["camera"], type(cam))
    assert back["camera"].zn == cam.zn and back["camera"].view is cam.view


# ---------------------------------------------------------------------------
# The graph route on a fake card
# ---------------------------------------------------------------------------

class _FakeGraph:
    """Records the fake kernels launched while capturing; replay runs them
    again (no Python of the traced function runs); reset() frees it."""

    recording = None

    def __init__(self):
        self.launches = []
        self.was_reset = False

    def replay(self):
        assert not self.was_reset, "replay of a released graph"
        for launch in self.launches:
            launch()

    def reset(self):
        self.launches, self.was_reset = [], True


@contextlib.contextmanager
def _fake_capture(graph):
    _FakeGraph.recording = graph
    try:
        yield
    finally:
        _FakeGraph.recording = None


def fake_scale(x, k):
    """A fake kernel wrapper: out = x * k, launched (or recorded while
    capturing) and counted in fake_scale.launches."""
    out = torch.empty_like(x)

    def launch():
        torch.mul(x, k, out=out)

    if _FakeGraph.recording is not None:
        _FakeGraph.recording.launches.append(launch)
    else:
        launch()
    fake_scale.launches += 1
    return out


fake_scale.launches = 0


def fake_over(x, k: float):
    """A fake kernel without a counter: out = x > k (a frame's flag)."""
    out = torch.empty(x.shape, dtype=torch.bool)

    def launch():
        torch.gt(x, k, out=out)

    if _FakeGraph.recording is not None:
        _FakeGraph.recording.launches.append(launch)
    else:
        launch()
    return out


class _FakeStream:
    def __init__(self, *a):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """jit's graph route on CPU tensors: CPU leaves count as the card's,
    torch.cuda's graph, streams and memory are stand-ins, and fake_scale's
    counter is the one launch counter."""
    monkeypatch.setattr(jm, "_card_device", lambda leaves: leaves[0].device)
    monkeypatch.setattr(jm, "launch_counters",
                        lambda: [(fake_scale, "launches")])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(fake_scale, "launches", 0)


def _frame(x, params):
    """A two-launch 'frame' with a passthrough and a host leaf."""
    y = fake_scale(fake_scale(x, params["k"]), 2.0)
    return {"y": y, "x": x, "k": params["k"]}


def test_replay_counts_launches_per_frame(fake_card):
    """The warm-up call counts its two real launches, the capture's moves
    are taken back and every replay adds the capture's two: the counter
    moves by exactly two a call over warm-up, capture and replays."""
    f = jm.jit(_frame)
    for i in range(5):
        f(torch.full((3,), float(i)), {"k": 3.0})
        assert fake_scale.launches == 2 * (i + 1)
    assert f.captures == 1


def test_replay_outputs_are_fresh(fake_card):
    """Frame i's outputs still hold frame i after frame i + 1 (the static
    outputs are copied out); a passthrough is the caller's own tensor; the
    values are the replayed kernels' on the new inputs."""
    f = jm.jit(_frame)
    f(torch.ones(3), {"k": 3.0})                      # warm-up
    outs = []
    for i in range(1, 4):                             # capture, replays
        x = torch.full((3,), float(i))
        outs.append((x, f(x, {"k": 3.0})))
    for x, out in outs:
        assert torch.equal(out["y"], x * 6.0) and out["x"] is x
        assert out["k"] == 3.0
    assert outs[0][1]["y"].data_ptr() != outs[1][1]["y"].data_ptr()


def test_host_leaf_change_captures_anew(fake_card):
    """Another value of a host leaf is another key: warmed up, captured
    and replayed on its own, with its own value baked in."""
    f = jm.jit(_frame)
    for k in (3.0, 3.0, 5.0, 5.0, 5.0):
        out = f(torch.ones(3), {"k": k})
        assert torch.equal(out["y"], torch.full((3,), 2.0 * k))
    assert f.captures == 2
    assert fake_scale.launches == 10


def test_failed_capture_raises(fake_card):
    """A function that reads a tensor on the host warms up, then fails to
    capture loudly, naming the operation; it never runs eagerly in place of
    the capture, and the counters stay as the warm-up left them."""
    def reads_host(x):
        y = fake_scale(x, 2.0)
        return y * float(y.sum())

    f = jm.jit(reads_host)
    f(torch.ones(3))
    with pytest.raises(jm.CaptureError, match="host read"):
        f(torch.ones(3))
    assert f.captures == 0 and fake_scale.launches == 1


def test_graph_cache_is_bounded(fake_card):
    """Over MAX_GRAPHS + 4 distinct values of a host leaf that is still a
    key (as a target width or a light set's kinds is; zn / zf no longer
    are), each warmed up and captured, at most MAX_GRAPHS graphs and as
    many warm keys are alive; the least recently used go first, each
    evicted graph's reset() has been called and evictions counts them; a
    graph used again is kept; every frame's values and launches stay
    exact."""
    n = jm.MAX_GRAPHS + 4
    f = jm.jit(_frame)
    made = []
    for i in range(n):
        for _ in range(2):                        # warm-up, then capture
            out = f(torch.ones(3), {"k": float(i)})
            assert torch.equal(out["y"], torch.full((3,), 2.0 * i))
        made.append(f.graphs[next(reversed(f.graphs))].graph)
        f(torch.ones(3), {"k": 0.0 if i < jm.MAX_GRAPHS else float(i)})
        assert len(f.graphs) <= jm.MAX_GRAPHS
        assert len(f._warm) <= jm.MAX_GRAPHS
    assert f.captures == n and f.evictions == n - jm.MAX_GRAPHS
    assert sum(g.was_reset for g in made) == f.evictions
    assert not made[0].was_reset                 # k = 0.0, used throughout
    assert all(made[i].was_reset for i in range(1, f.evictions + 1))
    assert fake_scale.launches == 2 * 3 * n
    for i in range(n):                        # forget every key there was
        f.forget(torch.ones(3), {"k": float(i)})
    assert not f.graphs and not f._warm and all(g.was_reset for g in made)
    assert f.evictions == n


def _capped(x, need, caps):
    """A fake frame with a checked capacity: its output shows the list
    width it ran at (x * width); the flag is set where need exceeds it.
    caps=None sizes the width on the host (the eager route)."""
    from lsr_tpu_torch.raster.tiled import fitted_cap

    if caps is None:
        width = fitted_cap(256, int(need))
        return fake_scale(x, float(width)), {"raster_cap_used": width}
    y = fake_scale(x, float(caps.list_width))
    return y, {"raster_max_bin": need,
               "capacity_exceeded": fake_over(need, caps.list_width)}


@pytest.mark.parametrize("where", ["replay", "capture"])
def test_checked_retry(fake_card, where):
    """An overflow on a replay, and one on the capture call itself, each
    return the eager frame at the grown capacities (x * 512, the frame the
    caller would get from fn at those capacities), never the graph's; the
    stale graph is released, and the new key captures on its next call.
    The launch counter counts what ran: one a frame, two for a redone
    frame (the replay's and the eager frame's)."""
    from lsr_tpu_torch.utils.capacity import Capacities, checked

    c = checked(_capped)
    x, small, big = torch.arange(3.0), torch.tensor(100), torch.tensor(300)
    key = c.key(x, small)
    c.caps[key] = Capacities(list_width=256)
    needs = [small, small, big] if where == "replay" else [small, big]
    for need in needs[:-1]:
        assert torch.equal(c(x, need), x * 256.0)
    assert c.captures == (1 if where == "replay" else 0)
    assert fake_scale.launches == len(needs) - 1
    out = c(x, needs[-1])
    assert fake_scale.launches == len(needs) + 1
    assert torch.equal(out, x * 512.0)
    assert c.caps[key] == Capacities(list_width=512)
    assert (c.retries, c.growths) == (1, 1)
    assert c.captures == 1 and not c.jitted.graphs
    assert c.jitted.evictions == 1
    # The grown key: the redo was its warm-up, so this call captures.
    assert torch.equal(c(x, big), x * 512.0)
    assert c.captures == 2 and fake_scale.launches == len(needs) + 2
    assert torch.equal(out, c.fn(x, big, c.caps[key])[0])


def test_checked_first_call_sizes(fake_card):
    """With no capacities, the first call runs fn(..., None) eagerly and
    keeps the width it read; the next calls warm up and capture that key."""
    from lsr_tpu_torch.utils.capacity import Capacities, checked

    c = checked(_capped)
    x = torch.arange(3.0)
    assert torch.equal(c(x, torch.tensor(300)), x * 512.0)
    assert c.caps[c.key(x, torch.tensor(0))] == Capacities(list_width=512)
    assert c.captures == 0
    for _ in range(3):
        assert torch.equal(c(x, torch.tensor(400)), x * 512.0)
    assert c.captures == 1 and c.retries == 0 and fake_scale.launches == 4


def test_checked_capacities_per_key(fake_card):
    """Each key of a call (here the tensor's shape, as a target size would
    be) sizes and grows capacities of its own: a wide key never widens a
    narrow one, nor a narrow one's growth the wide one; at most MAX_GRAPHS
    keys are remembered, the least recently used forgotten first."""
    from lsr_tpu_torch.utils.capacity import Capacities, checked

    c = checked(_capped)
    wide, narrow = torch.arange(3.0), torch.arange(5.0)
    assert torch.equal(c(wide, torch.tensor(700)), wide * 768.0)
    assert torch.equal(c(narrow, torch.tensor(100)), narrow * 256.0)
    for _ in range(2):                    # warm-up and capture at 256
        assert torch.equal(c(narrow, torch.tensor(100)), narrow * 256.0)
    assert c.caps[c.key(narrow, torch.tensor(0))] == Capacities(256)
    assert torch.equal(c(narrow, torch.tensor(300)), narrow * 512.0)
    assert c.caps[c.key(narrow, torch.tensor(0))] == Capacities(512)
    assert c.caps[c.key(wide, torch.tensor(0))] == Capacities(768)
    assert (c.retries, c.growths, c.captures) == (1, 1, 1)
    for n in range(6, 6 + jm.MAX_GRAPHS - 1):
        c(torch.arange(float(n)), torch.tensor(100))
    assert len(c.caps) == jm.MAX_GRAPHS
    assert c.key(wide, torch.tensor(0)) not in c.caps


def test_cpu_route_is_eager():
    """CPU tensors call the function itself: no capture, real launches."""
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    f = jm.jit(fn)
    for _ in range(3):
        assert torch.equal(f(torch.zeros(2)), torch.ones(2))
    assert len(calls) == 3 and f.captures == 0
    with pytest.raises(ValueError, match="no tensor"):
        f(3.0)


# ---------------------------------------------------------------------------
# CaptureCheck and device_const
# ---------------------------------------------------------------------------

_X = torch.arange(6.0)


@pytest.mark.parametrize("name, op, what", [
    ("item", lambda: _X.sum().item(), "host read"),
    ("bool", lambda: bool(_X.sum() > 0), "host read"),
    ("tolist", lambda: _X.tolist(), "host read"),
    ("nonzero", lambda: torch.nonzero(_X), "data-dependent"),
    ("bool_index", lambda: _X[_X > 2], "data-dependent"),
    ("masked_select", lambda: torch.masked_select(_X, _X > 2),
     "data-dependent"),
    ("unique", lambda: torch.unique(_X), "data-dependent"),
    ("repeat_interleave", lambda: torch.repeat_interleave(
        _X.long(), torch.ones(6, dtype=torch.long)), "data-dependent"),
    ("tensor", lambda: torch.tensor([1.0, 2.0]), "constant upload"),
    ("as_tensor_device", lambda: torch.as_tensor(1.0, device="cpu"),
     "constant upload"),
    ("list_index", lambda: _X[[0, 2]], "constant upload"),
])
def test_capture_check_refuses(name, op, what):
    with pytest.raises(jm.CaptureError, match=what):
        with jm.CaptureCheck():
            op()


def test_capture_check_allows_device_work():
    """Device-side ops, scalar operands, a 0-d host scalar and slicing pass;
    pause() lets a plain version read the host."""
    check = jm.CaptureCheck()
    with check:
        y = torch.where(_X > 2, _X * 0.5, torch.zeros_like(_X))
        y = y * torch.tensor(0.25) + _X[1:4].sum()
        y = torch.repeat_interleave(_X, torch.ones(6, dtype=torch.long),
                                    output_size=6)
        with check.pause():
            assert float(y.sum()) == 15.0


def test_device_const_is_memoised():
    """device_const makes a constant once per (values, dtype, device); a
    write to the shared tensor raises at its next use."""
    a = util.device_const([0.5, 1.5], "cpu")
    assert util.device_const((0.5, 1.5), "cpu") is a
    assert util.device_const([0.5, 1.5], "cpu", torch.float64) is not a
    b = util.device_const([7, 8, 9], "cpu", torch.int64)
    b += 1
    with pytest.raises(RuntimeError, match="in place"):
        util.device_const([7, 8, 9], "cpu", torch.int64)
    util._CONSTS.clear()


def test_cluster_slice_bounds_defaults_to_the_card():
    """cluster_slice_bounds takes the caller's device, and the card when
    none is named (the port's rule), as the other entry points."""
    from lsr_tpu_torch.lighting.light_culling import cluster_slice_bounds

    b = cluster_slice_bounds(0.1, 100.0, 8, device="cpu")
    assert b.shape == (9,) and b.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cluster_slice_bounds(0.1, 100.0, 8)


# ---------------------------------------------------------------------------
# The flagship frame and execute_jitted through jit (CPU route)
# ---------------------------------------------------------------------------

FW, FH, FS = 128, 96, 128
CUT = dict(with_cull=False, with_local=False)


@pytest.fixture(scope="module")
def flagship():
    """lsr_tpu's reference stages and LDR at orbit frame 5, and the port's
    scene and camera for it (test_torch_frame.py's scene and cut frame)."""
    from lsr_tpu.passes.post import fxaa_pass as jfx
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(5, ctx, FW, FH)
    ref = jax_reference_stages(geom, objects, lights, ctx, cam, ctx_t, FW,
                               FH, shadow_size=FS)
    ref["ldr"] = np.asarray(jfx(jtm(ref["hdr"])))
    return ref, to_torch(geom, objects, lights, ctx, cam, ctx_t)


def test_jit_frame_equals_eager_and_jax(flagship):
    """jit(make_flagship_frame(...)) on the CPU: bit for bit the eager
    frame's five outputs, and lsr_tpu's op-by-op frame within C1."""
    from lsr_tpu_torch.frame import make_flagship_frame

    ref, (tg, to, tl, tc, tcam, tct) = flagship
    frame = make_flagship_frame(tg, to, tl, tc, FW, FH, shadow_size=FS, **CUT)
    eager = frame(tcam, tct)
    jitted = jm.jit(frame)
    for _ in range(2):
        out = jitted(tcam, tct)
        for a, b in zip(out, eager):
            assert torch.equal(a, b)
    d_ldr = np.abs(ref["ldr"].astype(int) - out[0].numpy().astype(int))
    assert (d_ldr.max(-1) <= 1).mean() >= 0.999
    _, n_valid, max_sup, max_lights, overflow = out
    assert int(n_valid) == int(np.asarray(ref["setup"].valid).sum())
    assert int(max_sup) == int(ref["max_sup"])
    assert int(max_lights) == int(ref["stats"]["max_lights_per_bin"])
    assert int(overflow) == int(ref["stats"]["overflow_bins"])


PW, PH = 128, 96


def test_execute_jitted_equals_execute():
    """forward_plus at 128x96, three frames of the orbit (the visibility
    history carried): execute_jitted's states equal execute's bit for bit
    on ldr and hdr."""
    from lsr_tpu_torch.pipeline.executor import RenderContext

    pipe_a, fp_a, state_fn = preset_pipeline("forward_plus", PW, PH)
    pipe_b, fp_b, _ = preset_pipeline("forward_plus", PW, PH)
    for i in range(3):
        a = pipe_a.execute_jitted(RenderContext(), state_fn(i), fp_a)
        b = pipe_b.execute(RenderContext(), state_fn(i), fp_b)
        assert torch.equal(a["ldr"], b["ldr"])
        assert torch.equal(a["hdr"], b["hdr"])
    assert pipe_a._jitted.captures == 0      # the CPU route: eager


# ---------------------------------------------------------------------------
# The crop windows as data: one capture for cameras that pick other levels
# ---------------------------------------------------------------------------

# Cameras of the bench orbit whose PCF planes (192x108, default cascade)
# pick other levels: at 2 every plane takes level 0, at 20 plane 6 and at
# 80 plane 8 take level 1; the windows move between all three.
CROP_CAMS = (2, 20, 80)


@pytest.mark.parametrize("config", ["esm", "pcf"])
def test_crop_windows_replay_on_one_capture(monkeypatch, config):
    """bench.py's whole frame with its crop cascade (flagship (a) ESM at
    half resolution, (d) PCF at full; 192x108, maps cut) through jit on the
    recording fake card (torch_scenes.RecordingCard), kernels V1 and V2's
    plain versions recorded as fake kernels: camera 2 warms up, camera 20
    captures, camera 80 replays; one capture, the captured and replayed
    frames bit for bit their eager frames, and V1 and V2 launched once a
    frame, replays included.  V2 writes the full-resolution planes: no
    resize_bilinear of a plane stack runs outside it, eager, captured or
    replayed.  The eager frames' windows differ from camera to camera
    (under PCF their levels too), with one key."""
    from lsr_tpu_torch import frame as fr
    from lsr_tpu_torch.core import image
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.lighting import resolve_kernel, shade_kernel
    from lsr_tpu_torch.raster import tiled
    from torch_scenes import RecordingCard

    w, h = 192, 108
    geom, objects, lights, ctx = fr.build_flagship_scene(16, grid=2,
                                                         device="cpu")
    cams = [fr.flagship_camera(i, ctx, w, h, device="cpu")
            for i in CROP_CAMS]
    cfg = fr.bench_config(config, w, h)
    cfg.update(shadow_size=128, local_map=64, local_point=32)
    assert cfg["vis_crop"]
    frame = fr.make_flagship_frame(geom, objects, lights, ctx, w, h, **cfg)

    windows = []
    plain = ls.vis_windows_plain

    def spy(*a, **k):
        win, run = plain(*a, **k)
        windows.append(win.clone())
        return win, run

    monkeypatch.setattr(ls, "vis_windows_plain", spy)
    eager = [frame(*c) for c in cams]
    assert len(windows) == 3
    assert not torch.equal(windows[0], windows[1])
    assert not torch.equal(windows[1], windows[2])
    if config == "pcf":
        sizes = [w_[:, 2:].tolist() for w_ in windows]
        assert sizes[0] != sizes[1] and sizes[1] != sizes[2]

    card = RecordingCard().install(monkeypatch)
    for owner, name in ((tiled, "rasterize_brute"),
                        (tiled, "_banded_brute"),
                        (shade_kernel, "_shade_plain"),
                        (resolve_kernel, "_resolve_plain")):
        card.kernel(monkeypatch, owner, name)
    inside, stray = [0], []
    full_plain = ls.vis_planes_full_plain

    def v2_plain(*a, **k):
        inside[0] += 1
        try:
            return full_plain(*a, **k)
        finally:
            inside[0] -= 1

    def resize(x, shape, orig=image.resize_bilinear):
        if x.dim() == 3 and not inside[0]:
            stray.append(tuple(x.shape))
        return orig(x, shape)

    monkeypatch.setattr(ls, "vis_planes_full_plain", v2_plain)
    monkeypatch.setattr(ls, "resize_bilinear", resize)
    monkeypatch.setattr(image, "resize_bilinear", resize)
    v1 = card.kernel(monkeypatch, ls, "vis_windows_plain")
    v2 = card.kernel(monkeypatch, ls, "vis_planes_full_plain")
    jf = jm.jit(frame)
    for n, i in enumerate(range(3), 1):
        out = jf(*cams[i])
        assert v1.launches == v2.launches == n
        if n > 1:
            assert all(torch.equal(a, b) for a, b in zip(out, eager[i]))
    assert jf.captures == 1 and len(jf.graphs) == 1
    assert not stray
