"""lsr_tpu_torch's local shadow atlas vs lsr_tpu (CPU): caster planning, the
slot view-projections, the batched depth-only setup, the rendered slot
tables under both filters and all three strategies, the stacked raster
(kernel B1a's band_h, plain versions), and the visibility planes.

Both packages get the grid-2 procedural scene with 16 lights (8 shadowed
spots and 2 shadowed points, tests/torch_scenes.py) and small slots (64^2
spots, 32^2 cube faces).  lsr_tpu's atlas is rendered slot by slot op by op
(torch_scenes.jax_local_atlas): its lax.map over slots compiles the slot
program, which moves a triangle on a knife edge.  Tolerances:
- the slot view-projections are the same f32 operations (within 1 ULP;
  they come out equal), planning and plane indices equal;
- the batched setup equals per-slot scene_setup_depth bit for bit, and
  lsr_tpu's scene_setup_slots_depth on the same inputs;
- the slot tables within one q16 quantum: the two packages' slot rasters
  agree within 1.2e-7 in depth, which can move a q16 rounding (and, through
  ESM's exp / log prefilter, a soft texel) by one;
- "packed" and "hybrid" equal "map" bit for bit, also for 64-row bands,
  which are not a multiple of the card's 128-row list tiles;
- on the same (converted) atlas and the same positions and normals, the
  planes agree within 1.3e-3 under ESM (one q16 quantum of the soft map
  moves exp(c (soft - z)) by at most exp(80 / 65535) - 1) and within 1e-6
  under PCF on >= 99.9% of pixels (the counts are of the same q16 texels;
  a projection that XLA rounds with a fused multiply-add may pick the
  neighbouring texel on a texel boundary, one tap of 25).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import (
    jax_camera,
    jax_flagship_scene,
    jax_local_atlas,
    to_torch,
)

W, H = 128, 96
SPOT, POINT = 64, 32
ENABLED = np.array([1, 1, 0, 1, 1, 1, 1, 1, 0, 1], bool)


@pytest.fixture(scope="module")
def scene():
    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t),
                t=to_torch(geom, objects, lights, ctx, cam, ctx_t))


@pytest.fixture(scope="module")
def casters(scene):
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters

    return plan_shadow_casters(scene["j"][2])


def test_plan_and_shadow_index_match_jax(scene, casters):
    from lsr_tpu.lighting import local_shadows as jls

    from lsr_tpu_torch.lighting import local_shadows as tls

    lights, tl = scene["j"][2], scene["t"][2]
    assert tls.plan_shadow_casters(tl) == casters
    assert casters == ((0, 1, 2, 3, 4, 5, 6, 7), (8, 9))
    np.testing.assert_array_equal(
        tls.shadow_index_for_lights(tl, *casters).numpy(),
        np.asarray(jls.shadow_index_for_lights(lights, *casters)))
    want = jls.plan_slot_stacks(lights, *casters)
    got = tls.plan_slot_stacks(tl, *casters)
    assert got[0] == tuple(want[0]) and got[1] == tuple(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.stack(want[2]))
    np.testing.assert_array_equal(got[4].numpy(), np.float32(want[4]))
    assert tls.default_vis_crop(1080, 1920) == jls.default_vis_crop(1080,
                                                                     1920)


@pytest.mark.parametrize("seed", [42, 7, 1234])
def test_slot_viewprojs_match_jax(seed):
    """Spot and cube-face view-projections of a full 256-light set: within
    1 ULP of lsr_tpu's op-by-op plan_slot_stacks."""
    from lsr_tpu.lighting import local_shadows as jls

    from lsr_tpu_torch.convert import lights_soa
    from lsr_tpu_torch.lighting import local_shadows as tls

    lights = jax_flagship_scene(n_lights=256, seed=seed, grid=1)[2]
    ids = jls.plan_shadow_casters(lights)
    want = jls.plan_slot_stacks(lights, *ids)
    got = tls.plan_slot_stacks(lights_soa(lights, "cpu"), *ids)
    for a, b in ((want[5], got[5]), (want[6], got[6])):
        a = np.asarray(a).view(np.int32).astype(np.int64)
        b = b.numpy().view(np.int32).astype(np.int64)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_slots_depth_setup_matches_single_and_jax(scene, casters):
    from lsr_tpu.lighting.local_shadows import plan_slot_stacks as jplan
    from lsr_tpu.raster.setup import scene_setup_slots_depth as jslots

    from lsr_tpu_torch.raster.setup import (
        CULL_NONE,
        scene_setup_depth,
        scene_setup_slots_depth,
    )

    geom, objects, lights = scene["j"][:3]
    tg, to = scene["t"][:2]
    vps = jplan(lights, *casters)[6][:4]
    vis = np.random.default_rng(5).random((4, 5)) < 0.8
    tv = torch.as_tensor(np.array(vps))
    got = scene_setup_slots_depth(tg.positions, tg.indices, tg.vtx_obj,
                                  tg.tri_obj, to.model, tv, 48,
                                  cull_mode=CULL_NONE,
                                  obj_visible_slots=torch.as_tensor(vis))
    want = jslots(geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
                  objects.model, vps, 48, obj_visible_slots=jnp.asarray(vis))
    for s in range(4):
        one = scene_setup_depth(tg.positions, tg.indices, tg.vtx_obj,
                                tg.tri_obj, to.model, tv[s], 48, 48,
                                obj_visible=torch.as_tensor(vis[s]))
        for f in ("coef", "iw", "ziw", "bbox", "valid"):
            assert torch.equal(getattr(got, f)[s], getattr(one, f)), f
    for f in ("coef", "iw", "ziw", "bbox", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.fixture(scope="module", params=["esm", "pcf"])
def atlases(request, scene, casters):
    """(filter, lsr_tpu's atlas op by op, the port's "map" atlas), with two
    lights culled (ENABLED)."""
    from lsr_tpu_torch.lighting import local_shadows as tls

    geom, objects, lights = scene["j"][:3]
    tg, to, tl = scene["t"][:3]
    ref = jax_local_atlas(geom, objects, lights, *casters, SPOT, POINT,
                          request.param, caster_enabled=ENABLED)
    got = tls.render_local_shadow_maps(
        tg, to, tl, *casters, map_size=SPOT, point_size=POINT, pcf_radius=2,
        filter_mode=request.param, caster_enabled=torch.as_tensor(ENABLED))
    return request.param, ref, got


def test_slot_tables_match_jax(atlases):
    from lsr_tpu_torch.convert import local_shadow_maps

    _, ref, got = atlases
    want = local_shadow_maps(ref, "cpu")
    for k, n, s in (("spot_taps", 8, SPOT), ("point_taps", 12, POINT)):
        a = getattr(want, k).numpy().astype(np.int64)
        b = getattr(got, k).numpy()
        assert b.shape == (n, s, s) and b.dtype == np.int32
        assert (a < 65535).sum() > 0.02 * a.size
        assert np.abs(a - b).max() <= 1, (k, np.abs(a - b).max())
    # The culled lights' slots are all far.
    assert (got.spot_taps[2] == 65535).all()
    assert (got.point_taps[:6] == 65535).all()
    np.testing.assert_array_equal(got.spot_viewproj.numpy(),
                                  np.asarray(ref.spot_viewproj))


@pytest.mark.parametrize("packed", [True, "hybrid"])
def test_packed_and_hybrid_equal_map(atlases, scene, casters, packed):
    """The batched setup + one banded raster a stack (and + a raster a slot)
    give the "map" tables bit for bit; the bands are 64 and 32 rows."""
    from lsr_tpu_torch.lighting import local_shadows as tls

    mode, _, ref = atlases
    tg, to, tl = scene["t"][:3]
    got = tls.render_local_shadow_maps(
        tg, to, tl, *casters, map_size=SPOT, point_size=POINT, pcf_radius=2,
        filter_mode=mode, caster_enabled=torch.as_tensor(ENABLED),
        atlas_packed=packed)
    assert torch.equal(got.spot_taps, ref.spot_taps)
    assert torch.equal(got.point_taps, ref.point_taps)


def test_stacked_walk_equals_separate_walks(scene, casters):
    """Kernel B1a's plain model (rasterize_direct_plain with band_h): one
    walk over a stack of four 64-row slots, whose 128-row list tiles each
    span two slots, equals four walks of the slots alone bit for bit, and
    equals rasterize_direct's plain version with band_h.  The stack only
    meets its own slot's triangles through the chunk-bbox test at 16x16
    blocks."""
    from lsr_tpu_torch.lighting import local_shadows as tls
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.setup import (
        CULL_NONE,
        DEPTH_NDC01,
        TriSetup,
        scene_setup_slots_depth,
    )

    tg, to, tl = scene["t"][:3]
    vp = tls.plan_slot_stacks(tl, *casters)[6][2:6]
    ts = scene_setup_slots_depth(tg.positions, tg.indices, tg.vtx_obj,
                                 tg.tri_obj, to.model, vp, 64,
                                 cull_mode=CULL_NONE)

    def walk(st, height, band_h=0):
        rec, ss, n_pad = tiled.pack_direct_records(st, False)
        cbb = tiled._chunk_bboxes(ss, n_pad, 16)
        sl, cnt, _ = tiled._super_lists(cbb, 16, 1, -(-height // 128), 128,
                                        128)
        d0, t0 = tiled._targets(None, None, height, 64, "cpu")
        return tiled.rasterize_direct_plain(
            rec, cbb, sl, cnt, d0, t0, 64, height, 0.0, 1.0,
            depth_mode=DEPTH_NDC01, track_ids=False, band_h=band_h)[0]

    stack = tls._stack_slot_setups(ts, 64)
    got = walk(stack, 256, band_h=64)
    alone = torch.cat([walk(TriSetup(**{f.name: getattr(ts, f.name)[s]
                                        for f in dataclasses.fields(ts)}), 64)
                       for s in range(4)])
    assert torch.equal(got, alone) and bool((got < 1.0).any())
    plain, _, _ = tiled.rasterize_direct(stack, 64, 256, 0.0, 1.0,
                                         depth_mode=DEPTH_NDC01,
                                         track_ids=False, band_h=64)
    assert torch.equal(plain, got)


def test_band_h_refuses_spatial_sort(scene, casters):
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.setup import scene_setup_slots_depth

    tg, to, tl = scene["t"][:3]
    from lsr_tpu_torch.lighting import local_shadows as tls

    vp = tls.plan_slot_stacks(tl, *casters)[6][:2]
    st = tls._stack_slot_setups(scene_setup_slots_depth(
        tg.positions, tg.indices, tg.vtx_obj, tg.tri_obj, to.model, vp, 32),
        32)
    with pytest.raises(ValueError, match="spatial_sort"):
        tiled.rasterize_direct(st, 32, 64, 0.0, 1.0, band_h=32,
                               spatial_sort=True)
    with pytest.raises(ValueError, match="whole"):
        tiled.rasterize_direct(st, 32, 60, 0.0, 1.0, band_h=32)


@pytest.fixture(scope="module")
def receivers(scene):
    """World positions and unit normals of the camera view (lsr_tpu's
    G-buffer, brute raster)."""
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.shading.models import _norm

    geom, objects, _, ctx, cam, _ = scene["j"]
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials,
                             want_face_normal=False)
    return gb.world_pos, _norm(gb.normal_ws), np.asarray(gb.covered)


@pytest.mark.parametrize("vis_scale", [1, 2])
@pytest.mark.parametrize("culled", [False, True])
def test_vis_planes_match_jax(atlases, receivers, vis_scale, culled):
    from lsr_tpu.lighting.local_shadows import (
        local_shadow_vis_planes as jplanes)
    from lsr_tpu.lighting.local_shadows import (
        local_shadow_vis_stack as jstack)

    from lsr_tpu_torch.convert import local_shadow_maps
    from lsr_tpu_torch.lighting.local_shadows import (
        local_shadow_vis_planes,
        local_shadow_vis_stack,
    )

    mode, ref, _ = atlases
    ref = dataclasses.replace(ref, vis_scale=vis_scale)
    if not culled:
        ref = dataclasses.replace(ref, caster_enabled=None)
    sh = local_shadow_maps(ref, "cpu")
    wp, nm, covered = receivers
    want = np.asarray(jplanes(ref, wp, nm))
    twp, tnm = torch.as_tensor(np.array(wp)), torch.as_tensor(np.array(nm))
    got = local_shadow_vis_planes(sh, twp, tnm).numpy()
    assert got.shape == (11, H, W) == want.shape
    assert (got[-1] == 1.0).all()
    if culled:
        assert (got[2] == 1.0).all() and (got[8] == 1.0).all()
    shadowed = (want[:-1] < 0.999) & covered
    assert shadowed.sum() > 100
    d = np.abs(got - want)
    if mode == "esm":
        assert d.max() <= 1.3e-3, d.max()
    else:
        assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 0.03, d.max()
    stack = local_shadow_vis_stack(sh, twp, tnm)
    assert torch.equal(stack, torch.as_tensor(got).permute(1, 2, 0))
    np.testing.assert_allclose(np.asarray(jstack(ref, wp, nm)),
                               want.transpose(1, 2, 0), atol=1e-6)
