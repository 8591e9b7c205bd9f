"""Checked capacities (lsr_tpu_torch/utils/capacity.py) on the high-poly
route (CPU): the capacity route of B3's lists, B4's worklists (which need
no capacity), the flag a frame sets when it exceeds its capacities, and
the checked wrapper that redoes such a frame at grown capacities.

Scene: the grid-2 flagship stand-in at 160x96 (tests/torch_scenes.py), the
scene of tests/test_torch_highpoly.py's routing repairs, whose largest
32x128 bin holds 1,846 triangles.  The port runs its plain versions on CPU
tensors, over the very lists the CUDA kernels get.

Tolerances: lists, counts and walk lengths are integers and must be equal;
inside the port, the capacity route and the eager route render bit for
bit; against lsr_tpu, test_torch_highpoly.py's frame contract (depth01
within 2e-3, tids on >= 99.5% of covered pixels).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_scenes import jax_camera, jax_flagship_scene, to_torch

W, H = 160, 96
MAX_BIN = 1846                      # the largest 32x128 bin of this scene


@pytest.fixture(scope="module")
def flag():
    """The grid-2 flagship scene on both sides and the port's full setup."""
    from lsr_tpu_torch.raster.setup import scene_setup

    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    t = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    tg, to, _, _, tcam, _ = t
    setup = scene_setup(tg.positions, tg.normals, tg.uvs, tg.indices,
                        tg.vtx_obj, tg.tri_obj, to.model, to.normal_mat,
                        tcam.viewproj, W, H)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t), t=t, setup=setup)


def _state(flag, caps=None):
    tg, to, tl, _, tcam, tct = flag["t"]
    return {"geom": tg, "objects": to, "lights": tl, "shade_ctx": tct,
            "camera": tcam, "capacities": caps}


def _batch(flag):
    tg = flag["t"][0]
    return {k: getattr(tg, k) for k in ("positions", "normals", "uvs",
                                        "indices", "vtx_obj", "tri_obj")}


# ---------------------------------------------------------------------------
# The capacity route of the lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_h,chunk", [(32, 8), (64, 16)])
def test_b3_capacity_lists_equal_eager(flag, tile_h, chunk):
    """With capacities that suffice (the exact pair count and its next power
    of two, the fitted width and a wider one), B3's lists, walk lengths and
    largest bin equal the eager fit_cap route's element for element, the
    flag is clear, and the plain version renders bit for bit."""
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.utils.capacity import next_pow2

    s = flag["setup"]
    rec, lists, n_walk, max_bin, n, fit_over = tiled.tiled_inputs(
        s, W, H, tile_h, 128, 1024, chunk, fit_cap=True)
    n = int(n)
    assert int(max_bin) == MAX_BIN and lists.shape[1] == 2048
    assert not bool(fit_over) and int(n_walk.sum()) == n
    d_e, t_e, *_ = tiled.rasterize_tiled(s, W, H, 0.1, 100.0, tile_h=tile_h,
                                        cap=1024, chunk=chunk, fit_cap=True)
    for pairs, width in ((n, 2048), (next_pow2(n), 2048), (n, 4096)):
        _, l2, w2, m2, n2, over = tiled.tiled_inputs(
            s, W, H, tile_h, 128, width, chunk, pairs=pairs)
        assert not bool(over) and int(n2) == n and int(m2) == MAX_BIN
        assert torch.equal(l2[:, :2048], lists)
        assert bool((l2[:, 2048:] == -1).all())
        assert torch.equal(w2, n_walk)
        assert torch.equal(tiled.tile_order(w2), tiled.tile_order(n_walk))
        d, t, *_ = tiled.rasterize_tiled(s, W, H, 0.1, 100.0, tile_h=tile_h,
                                         cap=width, chunk=chunk, pairs=pairs)
        assert torch.equal(d, d_e) and torch.equal(t, t_e)


@pytest.mark.parametrize("tile_h,sub_h,ccap,y_offset", [
    (128, 32, None, 0), (32, 8, None, 0), (128, 32, 8, 0), (32, 16, None, 40)])
def test_b4_lists_need_no_capacity(flag, tile_h, sub_h, ccap, y_offset):
    """B4's worklists come from lsr_tpu's dense (tiles, chunks) mask: built
    under CaptureCheck (no host read, no data-dependent shape), they equal
    lsr_tpu's _chunk_lists element for element, counts and largest count
    too, also with a ccap that truncates and on a y_offset band."""
    import jax.numpy as jnp
    from lsr_tpu.raster.setup import scene_setup as jss
    from lsr_tpu.raster.tiled import _chunk_lists as jcl

    from lsr_tpu_torch.raster.tiled import _chunk_lists
    from lsr_tpu_torch.utils.jit import CaptureCheck

    geom, objects, _, _, cam, _ = flag["j"]
    js = jss(geom.positions, geom.normals, geom.uvs, geom.indices,
             geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
             cam.viewproj, W, H)
    n_pad = -(-flag["setup"].coef.shape[0] // 256) * 256
    args = (n_pad, 16, 2, -(-(H - y_offset) // tile_h), 128, tile_h,
            n_pad // 16 if ccap is None else ccap)
    with CaptureCheck():
        tl, tc, tm = _chunk_lists(flag["setup"], *args, y_offset, sub_h)
    jl, jc, jm = jcl(js, *args, jnp.float32(y_offset), sub_h)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tm) == int(jm) > 0


@pytest.mark.parametrize("short", ["pairs", "width"])
def test_one_short_sets_the_flag(flag, short):
    """A pair capacity or a list width one short of what the scene needs
    sets the flag; every list still holds at least what its walk length
    says (no walk reads past a list)."""
    from lsr_tpu_torch.raster import tiled

    s = flag["setup"]
    n = int(tiled.bin_triangles(s, W, H, 32, 128, 1)[3])
    pairs, width = (n - 1, 2048) if short == "pairs" else (n, MAX_BIN - 1)
    lists, counts, max_bin, n_pairs, over = tiled.bin_triangles(
        s, W, H, 32, 128, width, pairs=pairs)
    assert bool(over) and int(n_pairs) == n and int(max_bin) == MAX_BIN
    live = torch.arange(lists.shape[1])[None] < counts[:, None]
    assert bool((lists[live] >= 0).all())
    if short == "pairs":
        assert int(counts.sum()) == n - 1
    else:
        assert int(counts.max()) == MAX_BIN - 1


def test_capacities_size_and_grow():
    """Capacities.sized reads an eager frame's stats; grown takes the list
    width by fitted_cap and the pairs to the next power of two, drops the
    compact setup after its overflow, and never shrinks."""
    from lsr_tpu_torch.utils.capacity import Capacities, exceeded

    c = Capacities.sized({"raster_cap_used": 2048,
                          "raster_pairs": torch.tensor(1854),
                          "compact_fallback": False})
    assert c == Capacities(2048, 2048, True)
    assert Capacities.sized({}) == Capacities(0, 0, True)
    g = c.grown({"raster_max_bin": torch.tensor(2049),
                 "raster_pairs": torch.tensor(100),
                 "compact_overflow": torch.tensor(True)})
    assert g == Capacities(2304, 2048, False)
    assert g.grown({"raster_max_bin": torch.tensor(5),
                    "compact_overflow": torch.tensor(False)}) == g
    assert not exceeded({}) and not exceeded(None)
    assert exceeded({"capacity_exceeded": torch.tensor(True)})


# ---------------------------------------------------------------------------
# The checked wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["render_forward", "pipeline_raster"])
def test_checked_redoes_an_exceeded_b3_frame(flag, monkeypatch, entry):
    """Routed to kernel B3 (row limit 0) with lsr_tpu's list cap of 1024 as
    the captured width, where the largest bin holds 1,846: the frame sets
    the flag, and the checked wrapper redoes it at 2048 and returns the
    image of the eager fitted frame bit for bit, which is the image
    test_b3_route_drops_no_triangle expects (lsr_tpu's rasterize_tiled at
    cap 2048 under the frame contract), not the truncated one."""
    from lsr_tpu.raster.setup import scene_setup as jss
    from lsr_tpu.raster.tiled import rasterize_tiled as jrt

    from lsr_tpu_torch import render
    from lsr_tpu_torch.core.frame import FrameParams
    from lsr_tpu_torch.passes.standard_passes import _raster
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.utils.capacity import Capacities, checked

    monkeypatch.setattr(tiled, "DIRECT_ROW_LIMIT", 0)
    geom, objects, _, _, cam, _ = flag["j"]
    _, to, _, _, tcam, tct = flag["t"]
    start = Capacities(list_width=1024, pairs=1 << 20)
    if entry == "render_forward":
        args = (_batch(flag), to.model, to.normal_mat, tcam.viewproj,
                tcam.zn, tcam.zf, tct, W, H, "blinn_phong",
                (0.05, 0.07, 0.12), True, 1024, 1.0, 2.2, 0)
        prog = checked(render._forward_frame)
        prog.caps[prog.key(*args)] = start
        (_, cut_gb), cut_stats = prog.fn(*args, start)
        _, gb = prog(*args)
        depth, tid, tile_h = gb.depth01, gb.tri_id, 32
        (_, fit_gb), _ = prog.fn(*args, None)
        fit_depth, fit_tid = fit_gb.depth01, fit_gb.tri_id
        cut_tid = cut_gb.tri_id
    else:
        fp = FrameParams(width=W, height=H, raster_cap=1024)

        def body(state, caps):
            out = _raster(dict(state, capacities=caps), fp)
            return out, out["raster_stats"]

        prog = checked(body)
        args = (_state(flag),)
        prog.caps[prog.key(*args)] = start
        cut, cut_stats = body(_state(flag), start)
        out = prog(_state(flag))
        depth, tid, tile_h = out["depth"], out["tid"], fp.raster_tile_h
        fit = _raster(_state(flag), fp)
        fit_depth, fit_tid = fit["depth"], fit["tid"]
        cut_tid = cut["tid"]
        assert out["raster_stats"]["raster_cap_used"] == 2048
    assert bool(cut_stats["capacity_exceeded"])
    assert int(cut_stats["raster_max_bin"]) == MAX_BIN
    assert int((cut_tid != fit_tid).sum()) > 1000
    caps = prog.caps[prog.key(*args)]
    assert caps.list_width == 2048 and caps.pairs == 1 << 20
    assert (prog.retries, prog.growths) == (1, 1)
    assert torch.equal(depth, fit_depth) and torch.equal(tid, fit_tid)
    js = jss(geom.positions, geom.normals, geom.uvs, geom.indices,
             geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
             cam.viewproj, W, H)
    td, tt, _ = jrt(js, W, H, cam.zn, cam.zf, tile_h=tile_h, cap=2048)
    tt, t_np = np.asarray(tt), tid.numpy()
    same = tt == t_np
    assert (~same).sum() <= 0.005 * max(int((tt >= 0).sum()), 1)
    assert np.abs(np.asarray(td) - depth.numpy())[same].max() <= 2e-3


def test_checked_compact_overflow_falls_back(flag):
    """compact_cap_fraction 0.05 overflows the compact setup on this scene:
    with capacities that still say "compact", the frame sets the flag, and
    the checked wrapper ends on the full setup's image, exactly as
    test_compact_overflow_falls_back expects of the eager route; the next
    frame skips the compact setup, and on kernel B1 sets no flag."""
    from lsr_tpu_torch.core.frame import FrameParams
    from lsr_tpu_torch.passes.standard_passes import _raster
    from lsr_tpu_torch.utils.capacity import Capacities, checked

    fp = FrameParams(width=W, height=H, compact_setup_threshold=0,
                     compact_cap_fraction=0.05)

    def body(state, caps):
        out = _raster(dict(state, capacities=caps), fp)
        return out, out["raster_stats"]

    start = Capacities(list_width=2048, pairs=1 << 20, compact=True)
    _, stats = body(_state(flag), start)
    assert bool(stats["capacity_exceeded"]) and bool(stats["compact_overflow"])
    prog = checked(body)
    prog.caps[prog.key(_state(flag))] = start
    out = prog(_state(flag))
    full = _raster(_state(flag), FrameParams(width=W, height=H))
    assert torch.equal(out["depth"], full["depth"])
    assert torch.equal(out["tid"], full["tid"])
    assert not prog.caps[prog.key(_state(flag))].compact
    assert out["raster_stats"]["compact_fallback"]
    again = prog(_state(flag))
    # The full setup on kernel B1: no capacity left to exceed, no flag.
    assert "compact_overflow" not in again["raster_stats"]
    assert "capacity_exceeded" not in again["raster_stats"]
    assert torch.equal(again["tid"], full["tid"])
    assert prog.retries == 1


def test_first_call_sizes_the_capacities(flag, monkeypatch):
    """A checked entry point's first call runs the eager route and keeps
    the sizes it read: the fitted width and the pairs' next power of two;
    its later frames (the capacity route) equal it bit for bit with the
    flag clear."""
    from lsr_tpu_torch.core.frame import FrameParams
    from lsr_tpu_torch.passes.standard_passes import _raster
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.utils.capacity import checked, next_pow2

    monkeypatch.setattr(tiled, "DIRECT_ROW_LIMIT", 0)
    fp = FrameParams(width=W, height=H, raster_cap=1024)

    def body(state, caps):
        out = _raster(dict(state, capacities=caps), fp)
        return out, out["raster_stats"]

    prog = checked(body)
    first = prog(_state(flag))
    n = int(first["raster_stats"]["raster_pairs"])
    assert n == int(tiled.bin_triangles(flag["setup"], W, H,
                                        fp.raster_tile_h, 128, 1)[3])
    caps = prog.caps[prog.key(_state(flag))]
    assert caps.list_width == 2048 and caps.pairs == next_pow2(n)
    assert "capacity_exceeded" not in first["raster_stats"]
    second = prog(_state(flag))
    assert not bool(second["raster_stats"]["capacity_exceeded"])
    assert torch.equal(first["tid"], second["tid"])
    assert torch.equal(first["depth"], second["depth"])
    assert prog.retries == 0
