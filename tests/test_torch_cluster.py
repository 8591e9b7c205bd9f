"""lsr_tpu_torch's clustered light binning and the visibility hysteresis vs
lsr_tpu (CPU): cluster_slice_bounds, view_depth_to_cluster_slice (the
slice plane of a rendered G-buffer), cull_lights_clustered's lists, counts
and stats, and update_visibility_history over a few frames.

The same inputs go to both packages (tests/torch_scenes.py's grid-2 scene,
its G-buffer depth from lsr_tpu's brute raster, the lights as numpy).
lsr_tpu's log and pow (XLA:CPU) and torch's may differ by an ulp, which
would move a pixel or a light on a slice boundary: every comparison below
counts the entries that differ and holds the count to 0 on these scenes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_scenes import jax_camera, jax_flagship_scene, to_torch

W, H = 128, 96


@pytest.fixture(scope="module")
def scene():
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, _ = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t),
                t=to_torch(geom, objects, lights, ctx, cam, ctx_t),
                depth=np.asarray(depth))


def _mixed_lights():
    """Point, spot, rect and tube lights (seeded), lsr_tpu LightsSoA."""
    from lsr_tpu.lighting.light_types import LightSetBuilder

    rng = np.random.default_rng(21)
    b = LightSetBuilder()
    for i in range(24):
        p = tuple(rng.uniform([-4, 0.0, -4], [4, 3.0, 4]).tolist())
        c = tuple(rng.uniform(0.3, 1.0, 3).tolist())
        r = float(rng.uniform(1.0, 6.0))
        k = i % 4
        if k == 0:
            b.point(p, color=c, range=r)
        elif k == 1:
            b.spot(p, (0, -1, 0), color=c, range=r)
        elif k == 2:
            b.rect_area(p, (0, -1, 0), color=c, range=r)
        else:
            b.tube_area(p, axis=(1, 0, 0), color=c, range=r)
    return b.build()


@pytest.mark.parametrize("slices", [8, 16])
def test_cluster_slice_bounds_and_plane_match_jax(scene, slices):
    """cluster_slice_bounds: the same f32 values (0 entries differ); the
    slice plane of the scene's depth buffer: 0 pixels differ, with several
    slices in use."""
    from lsr_tpu.lighting.light_culling import (
        cluster_slice_bounds as jb, view_depth_to_cluster_slice as jv)

    from lsr_tpu_torch.lighting.light_culling import (
        cluster_slice_bounds as tb, view_depth_to_cluster_slice as tv)

    cam, tcam = scene["j"][4], scene["t"][4]
    want = np.asarray(jb(cam.zn, cam.zf, slices))
    got = tb(tcam.zn, tcam.zf, slices, device="cpu").numpy()
    assert int((got != want).sum()) == 0, (got, want)
    jz = cam.zn + scene["depth"] * (cam.zf - cam.zn)
    tz = tcam.zn + torch.as_tensor(np.array(scene["depth"])) * (
        tcam.zf - tcam.zn)
    want = np.asarray(jv(jz, cam.zn, cam.zf, slices))
    got = tv(tz, tcam.zn, tcam.zf, slices).numpy()
    assert int((got != want).sum()) == 0
    assert len(np.unique(got)) >= 3
    # Depths swept across the whole range, boundaries included.
    z = np.geomspace(0.05, 120.0, 4001).astype(np.float32)
    want = np.asarray(jv(z, cam.zn, cam.zf, slices))
    got = tv(torch.as_tensor(z), tcam.zn, tcam.zf, slices).numpy()
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("lights", ["scene", "mixed"])
@pytest.mark.parametrize("use_shapes", [True, False])
@pytest.mark.parametrize("tiles,slices,cap", [((16, None), 16, 128),
                                              ((128, 64), 16, 256),
                                              ((128, 64), 8, 8)])
def test_cull_lights_clustered_matches_jax(scene, lights, use_shapes, tiles,
                                           slices, cap):
    """Clustered lists, counts and bin stats are the same integers (0
    entries differ), for the scene's spot / point lights and a mixed set
    with rect and tube lights, analytic shapes or bounding spheres, the
    pipeline's 16 px tiles and the kernel's 64x128 ones; cap 8 overflows on
    the mixed set and the overflow count agrees too."""
    from lsr_tpu.lighting.light_culling import cull_lights_clustered as jc

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.light_culling import (
        cull_lights_clustered as tc)

    cam, tcam = scene["j"][4], scene["t"][4]
    jl = scene["j"][2] if lights == "scene" else _mixed_lights()
    tl = convert.lights_soa(jl, "cpu")
    tw, th = tiles
    jlists, jcounts, jst = jc(jl, cam.view, cam.proj, cam.zn, cam.zf, W, H,
                              tile_size=tw, cap=cap, slices=slices,
                              use_shapes=use_shapes, tile_h=th)
    tlists, tcounts, tst = tc(tl, tcam.view, tcam.proj, tcam.zn, tcam.zf, W,
                              H, tile_size=tw, cap=cap, slices=slices,
                              use_shapes=use_shapes, tile_h=th)
    assert int((tlists.numpy() != np.asarray(jlists)).sum()) == 0
    assert int((tcounts.numpy() != np.asarray(jcounts)).sum()) == 0
    for k in ("max_count", "overflow_bins"):
        assert int(tst[k]) == int(jst[k]), k
    assert int(tcounts.sum()) > 0
    if cap == 8 and lights == "mixed":
        assert int(tst["overflow_bins"]) > 0


def test_update_visibility_history_matches_jax():
    """Eight frames of seeded visibility masks through both packages'
    hysteresis from the pipeline's start (history = hold_frames): the same
    counters and effective masks every frame; an object that vanishes
    stays in for hold_frames frames."""
    import jax.numpy as jnp

    from lsr_tpu.geometry.volumes import update_visibility_history as ju

    from lsr_tpu_torch.geometry.volumes import update_visibility_history as tu

    rng = np.random.default_rng(8)
    seen = rng.uniform(size=(8, 12)) < 0.4
    seen[:, 0] = [True] + [False] * 7
    jh = jnp.full((12,), 2, jnp.int32)
    th = torch.full((12,), 2, dtype=torch.int64)
    for i, now in enumerate(seen):
        jh, jeff = ju(jh, jnp.asarray(now), hold_frames=2)
        th, teff = tu(th, torch.as_tensor(now), hold_frames=2)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(teff.numpy(), np.asarray(jeff))
        assert bool(teff[0]) == (i <= 2)
