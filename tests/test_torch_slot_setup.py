"""Kernel F1 (raster/slot_setup.slot_inputs, csrc/slot_setup.cu): the "map"
local-shadow atlas's front end, every slot's B1 inputs of a stack at once.

On the CPU (tier 1): the plain version, slot_inputs_plain, equals the
per-slot chain it replaces (scene_setup_depth -> pack_direct_records ->
_chunk_bboxes -> _super_lists) bit for bit, records, chunk boxes, super
lists and counts, on the flagship's procedural scene (grid 2): a spot stack
on 2x2 list tiles of which the last row and column are partial, a cube-face
stack, spot slots and a point light's six faces disabled by slot_enabled
(as render_local_shadow_maps repeats a light's cull flag over its faces),
objects culled per slot, a point light inside a caster (rows crossing the
near plane) and zero view-projections (the sharded atlas's padding); B1's
walk on those inputs gives the chain's maps; the CPU's "map" route stays
the per-slot chain and the card's wrappers raise off the card; the launch
counter is listed and named by the benchmark's kernel file.

On the card (marked `card`, skipped without one): F1 against the plain
version on the card, bit for bit, on both benchmark deployments' scenes at
their atlas sizes (the flagship's 512^2 / 256^2 stacks, the render paths'
1024^2 / 512^2), slots enabled and disabled, and on the near-plane and
padding cases; the atlas of render_local_shadow_maps by "map" (F1) against
"packed" and against the per-slot chain; captured flagship and
forward_classic+ssao frames with F1 against the same frames on the per-slot
chain, and F1's launches a replay.
Run them on the card with
    python -m pytest tests/test_torch_slot_setup.py -q -m card
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lsr_tpu_torch.core.util import cdiv
from lsr_tpu_torch.geometry.volumes import frustum_cull_objects
from lsr_tpu_torch.lighting import local_shadows as ls
from lsr_tpu_torch.raster import slot_setup, tiled
from lsr_tpu_torch.raster.setup import CULL_NONE, scene_setup_depth
from lsr_tpu_torch.scene.scene import object_world_aabbs

HERE = os.path.dirname(os.path.abspath(__file__))
INSIDE = (0.45, 0.0, 0.0)   # a point light inside the sphere at the origin


def require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def flagship(device, n_lights=16, grid=2):
    from lsr_tpu_torch.frame import build_flagship_scene

    return build_flagship_scene(n_lights=n_lights, grid=grid, device=device)


def stack_case(case, geom, objects, lights, spot=200, face=64):
    """(viewprojs, size, obj_visible_slots, slot_enabled) of a case."""
    plan = ls.plan_slot_stacks(lights, *ls.plan_shadow_casters(lights))
    dev = geom.positions.device
    cm = objects.casts_shadow & objects.visible
    wmin, wmax = object_world_aabbs(objects)
    vps, size, en = plan[5], spot, None
    if case in ("faces", "near", "faces_disabled"):
        vps, size = plan[6], face
    if case == "near":
        pos = torch.tensor([INSIDE], dtype=torch.float32, device=dev)
        vps = ls._point_face_viewprojs(pos, torch.tensor([3.5], device=dev))
    if case == "zero_vp":
        vps = torch.cat([vps[:5], torch.zeros_like(vps[:3])])
        en = torch.arange(8, device=dev) < 5
    if case == "disabled":
        en = torch.tensor([True, False, True, True, False, True, False, True],
                          device=dev)
    if case == "faces_disabled":   # every other point light's six faces
        lit = torch.arange(vps.shape[0] // 6, device=dev) % 2 == 0
        en = lit.repeat_interleave(6)
    sm = cm[None] & frustum_cull_objects(vps, wmin, wmax)
    if case == "culled":
        rng = np.random.default_rng(3)
        sm = sm & torch.as_tensor(rng.random(tuple(sm.shape)) < 0.6,
                                  device=dev)
    return vps, size, sm, en


def chain(geom, objects, vps, size, sm, en):
    """The per-slot chain's B1 inputs: SlotInputs stacked over slots."""
    out = []
    for s in range(vps.shape[0]):
        st = scene_setup_depth(geom.positions, geom.indices, geom.vtx_obj,
                               geom.tri_obj, objects.model, vps[s], size,
                               size, cull_mode=CULL_NONE, obj_visible=sm[s])
        if en is not None:
            st = dataclasses.replace(st, valid=st.valid & en[s])
        rec, srt, n_pad = tiled.pack_direct_records(st, False)
        cb = tiled._chunk_bboxes(srt, n_pad, tiled._CHUNK)
        t = cdiv(size, 128)
        lists, counts, _ = tiled._super_lists(cb, tiled._CHUNK, t, t, 128,
                                              128)
        out.append((rec, cb, lists, counts))
    return slot_setup.SlotInputs(*(torch.stack(x) for x in zip(*out)))


def assert_same(got, want):
    for f in dataclasses.fields(slot_setup.SlotInputs):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if a.dtype == torch.float32:    # bits, NaNs and signed zeros too
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f.name


def plain(geom, objects, vps, size, sm, en):
    return slot_setup.slot_inputs_plain(
        geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
        objects.model, vps, size, sm, en)


def near_plane_crossings(geom, objects, vps):
    """Triangles of the stack whose corners lie on both sides of the near
    plane (z + w = 0)."""
    from lsr_tpu_torch.raster.setup import vertex_stage_world

    wc = vertex_stage_world(geom.positions, geom.vtx_obj, objects.model)
    clip = torch.einsum("sij,tcj->stci", vps, wc[geom.indices])
    inside = (clip[..., 2] + clip[..., 3] >= 0).sum(-1)
    return int(((inside > 0) & (inside < 3)).sum())


@pytest.fixture(scope="module")
def cpu_scene():
    return flagship("cpu")


CASES = ["spots", "faces", "disabled", "faces_disabled", "culled", "near",
         "zero_vp"]


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_the_per_slot_chain(cpu_scene, case):
    geom, objects, lights, _ = cpu_scene
    vps, size, sm, en = stack_case(case, geom, objects, lights)
    got = plain(geom, objects, vps, size, sm, en)
    assert_same(got, chain(geom, objects, vps, size, sm, en))
    n_sup = cdiv(2 * geom.indices.shape[0], 256)
    assert got.lists.shape == (vps.shape[0], cdiv(size, 128) ** 2, n_sup)
    live = got.counts.sum(1) > 0
    if case == "near":
        assert near_plane_crossings(geom, objects, vps) > 0
    if en is not None:   # a disabled slot lists nothing, its ids all -1
        assert not live[~en].any()
        assert bool((got.rec[~en][..., 15] == -1).all())
    assert bool(live.any()) or case == "zero_vp"


@pytest.mark.parametrize("case", ["spots", "near"])
def test_walk_on_plain_inputs_equals_the_chain_maps(cpu_scene, case):
    """B1's plain walk on the plain front end's inputs gives the maps of
    the CPU route (the per-slot chain through rasterize_direct)."""
    geom, objects, lights, _ = cpu_scene
    vps, size, sm, en = stack_case(case, geom, objects, lights, spot=96,
                                   face=48)
    inp = plain(geom, objects, vps, size, sm, en)
    want = ls._slot_depths_chain(geom, objects, vps, size, sm, en)
    for s in range(vps.shape[0]):
        got, _ = tiled.rasterize_direct_plain(
            inp.rec[s], inp.chunk_bb[s], inp.lists[s], inp.counts[s],
            *tiled._targets(None, None, size, size, "cpu"), size, size, 0.0,
            1.0, ls.DEPTH_NDC01, track_ids=False)
        assert torch.equal(got, want[s]), s


def test_the_cpu_route_is_the_per_slot_chain(cpu_scene, monkeypatch):
    geom, objects, lights, _ = cpu_scene
    vps, size, sm, en = stack_case("disabled", geom, objects, lights)
    monkeypatch.setattr(ls, "slot_inputs", None)
    monkeypatch.setattr(ls, "rasterize_direct_records", None)
    cm = objects.casts_shadow & objects.visible
    a = ls.render_slot_depths(geom, objects, vps[:2], 32, cm, en[:2])
    assert torch.equal(a, ls._slot_depths_chain(geom, objects, vps[:2], 32,
                                                sm[:2], en[:2]))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_the_card_wrappers_raise_off_the_card(cpu_scene, device):
    geom, objects, lights, _ = cpu_scene
    vps = torch.zeros((2, 4, 4), device=device)
    with pytest.raises(ValueError, match="unsupported device"):
        slot_setup.slot_inputs(geom.positions, geom.indices, geom.vtx_obj,
                               geom.tri_obj, objects.model, vps, 64, None)
    rec = torch.zeros((256, tiled._REC), device=device)
    with pytest.raises(ValueError, match="unsupported device"):
        tiled.rasterize_direct_records(
            rec, torch.zeros((16, 4), device=device),
            torch.zeros((1, 1), dtype=torch.int32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device),
            torch.zeros((64, 64), device=device))


def test_launch_counter_is_listed_and_named():
    from lsr_tpu_torch.utils.jit import launch_counters

    assert (slot_setup.slot_inputs, "launches") in launch_counters()
    path = os.path.join(HERE, "..", "renderbench", "kernels",
                        "slot_setup.json")
    with open(path) as f:
        spec = json.load(f)
    assert spec["counters"] == ["slot_inputs.launches"]
    src = os.path.join(HERE, "..", "lsr_tpu_torch", "csrc", "slot_setup.cu")
    with open(src) as f:
        assert all(sym in f.read() for sym in spec["symbols"])


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def deployment(name, dev):
    """(geom, objects, lights, spot size, face size) of a benchmark
    deployment: the flagship (256 lights, 25 spheres; bench.py's ESM atlas)
    or the render paths' scene (384 lights; the source's 1024 / 512)."""
    if name == "flagship":
        geom, objects, lights, _ = flagship(dev, n_lights=256, grid=5)
        return geom, objects, lights, 512, 256
    from lsr_tpu_torch.render_paths import scene_state

    st = scene_state(1280, 720, n_lights=384, device=dev)
    return st["geom"], st["objects"], st["lights"], 1024, 512


@pytest.mark.card
@pytest.mark.parametrize("name", ["flagship", "paths"])
@pytest.mark.parametrize("case", CASES)
def test_f1_equals_plain_on_the_card(name, case):
    require_card()
    dev = torch.device("cuda", 0)
    geom, objects, lights, spot, face = deployment(name, dev)
    vps, size, sm, en = stack_case(case, geom, objects, lights, spot, face)
    n0 = slot_setup.slot_inputs.launches
    got = slot_setup.slot_inputs(geom.positions, geom.indices, geom.vtx_obj,
                                 geom.tri_obj, objects.model, vps, size, sm,
                                 en)
    torch.cuda.synchronize()
    assert slot_setup.slot_inputs.launches == n0 + 1
    assert_same(got, plain(geom, objects, vps, size, sm, en))
    if case in ("spots", "faces"):
        assert_same(got, chain(geom, objects, vps, size, sm, en))


@pytest.mark.card
@pytest.mark.parametrize("filt", ["esm", "pcf"])
def test_map_atlas_equals_packed_and_the_chain_on_the_card(monkeypatch,
                                                           filt):
    require_card()
    dev = torch.device("cuda", 0)
    geom, objects, lights, spot, face = deployment("flagship", dev)
    casters = ls.plan_shadow_casters(lights)
    en = torch.tensor([True, True, False, True, True, True, True, True,
                       False, True], device=dev)
    kw = dict(map_size=spot, point_size=face, pcf_radius=2, filter_mode=filt,
              caster_enabled=en)

    def atlas(**more):
        n0 = slot_setup.slot_inputs.launches
        sh = ls.render_local_shadow_maps(geom, objects, lights, *casters,
                                         **kw, **more)
        torch.cuda.synchronize()
        return sh, slot_setup.slot_inputs.launches - n0

    m, n_map = atlas()
    p, n_packed = atlas(atlas_packed=True)
    monkeypatch.setattr(ls, "_slot_depths_card", ls._slot_depths_chain)
    c, n_chain = atlas()
    assert (n_map, n_packed, n_chain) == (2, 0, 0)
    for other in (p, c):
        assert torch.equal(m.spot_taps, other.spot_taps)
        assert torch.equal(m.point_taps, other.point_taps)


def _flagship_step(dev):
    from lsr_tpu_torch.frame import (
        bench_config,
        build_flagship_scene,
        flagship_camera,
        make_flagship_frame,
    )
    from lsr_tpu_torch.utils.jit import jit

    geom, objects, lights, ctx = build_flagship_scene(256, device=dev)
    frame = jit(make_flagship_frame(geom, objects, lights, ctx, 1920, 1080,
                                    **bench_config("esm", 1920, 1080)))
    return lambda i: frame(*flagship_camera(i, ctx, 1920, 1080, dev))[0]


def _ssao_step(dev):
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.render_paths import build_preset_pipelines

    _, pipes = build_preset_pipelines(
        1280, 720, {"forward_classic+ssao"}, local_map=1024, local_point=512,
        device=dev, with_pipes=True)
    pipe, fp, state_fn = pipes["forward_classic+ssao"]
    ctx = RenderContext()
    return lambda i: pipe.execute_jitted(ctx, state_fn(i), fp)["ldr"]


@pytest.mark.card
@pytest.mark.parametrize("make_step", [_flagship_step, _ssao_step],
                         ids=["flagship", "ssao"])
def test_captured_frames_equal_the_chain_on_the_card(monkeypatch, make_step):
    """Captured frames (warm-up, capture, replays) with F1, 2 launches a
    replay (a spot and a cube-face stack) beside 23 of B1, equal the same
    frames with the per-slot chain (the route before F1) bit for bit."""
    require_card()
    from lsr_tpu_torch.raster.tiled import rasterize_direct

    dev = torch.device("cuda", 0)

    def run():
        step = make_step(dev)
        out = [step(i).clone() for i in range(6)]
        f0 = slot_setup.slot_inputs.launches
        b0 = rasterize_direct.launches
        out.append(step(6).clone())
        torch.cuda.synchronize()
        return out, (slot_setup.slot_inputs.launches - f0,
                     rasterize_direct.launches - b0)

    got, launches = run()
    monkeypatch.setattr(ls, "_slot_depths_card", ls._slot_depths_chain)
    want, launches_chain = run()
    assert launches == (2, 23) and launches_chain == (0, 23)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
