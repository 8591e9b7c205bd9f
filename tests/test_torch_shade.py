"""lsr_tpu_torch light binning, fused shading (kernel B2's plain path) and
the per-pixel passes around it vs lsr_tpu (CPU).

Every comparison feeds both packages the same inputs: lsr_tpu's own G-buffer
of a small rendered scene (tests/torch_scenes.py), handed over as numpy.
The JAX side runs shade_fused_pallas in Pallas interpret mode, as its own
CPU tests do; the torch side runs the plain versions.  Each test states its
tolerance; the residual differences are f32 rounding (XLA:CPU fuses
multiply-adds into FMAs, torch does not).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import jax_camera, jax_flagship_scene, to_torch, torch_setup

W, H = 128, 96


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """Scene state on both sides plus lsr_tpu's G-buffer (brute raster)."""
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials,
                             want_face_normal=False)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t),
                t=to_torch(geom, objects, lights, ctx, cam, ctx_t),
                setup=setup, depth=depth, tid=tid, gb=gb)


def _light_set(kind, seed=11):
    """Spot+point (the flagship's types) or a mixed set with rect and tube
    lights and non-unit attenuation powers; lsr_tpu LightsSoA."""
    from lsr_tpu.lighting.light_types import LightSetBuilder

    rng = np.random.default_rng(seed)
    b = LightSetBuilder()
    for i in range(12):
        p = tuple(rng.uniform([-2.5, 0.0, -2.5], [2.5, 2.0, 2.5]).tolist())
        c = tuple(rng.uniform(0.3, 1.0, 3).tolist())
        if kind == "mixed" and i % 4 == 1:
            b.rect_area(p, (0, -1, 0), color=c, intensity=1.5, range=4.0)
        elif kind == "mixed" and i % 4 == 2:
            b.tube_area(p, axis=(1, 0, 0), color=c, intensity=1.5, range=4.0,
                        atten_power=1.5, atten_model=i % 3)
        elif i % 2 == 0:
            b.spot(p, (0, -1, 0), color=c, intensity=2.0, range=4.0)
        else:
            b.point(p, color=c, intensity=1.5, range=3.0)
    return b.build()


# ---------------------------------------------------------------------------
# Light binning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles,depth_range", [
    ((16, 16, 128), False), ((128, 64, 256), False), ((128, 64, 256), True)])
def test_cull_lights_tiled_matches_jax(scene, tiles, depth_range):
    """Tile lists, counts and bin stats are the same integers."""
    from lsr_tpu.lighting.light_culling import (
        cull_lights_tiled as jcull, tile_depth_ranges_from_buffer as jtdr)

    from lsr_tpu_torch.lighting.light_culling import (
        cull_lights_tiled as tcull, tile_depth_ranges_from_buffer as ttdr)

    tw, th, cap = tiles
    _, _, jl, _, cam, _ = scene["j"]
    _, _, tl, _, tcam, _ = scene["t"]
    jd = jtdr(scene["depth"], cam.zn, cam.zf, W, H, tw, tile_h=th) \
        if depth_range else None
    td = ttdr(_t(scene["depth"]), tcam.zn, tcam.zf, W, H, tw, tile_h=th) \
        if depth_range else None
    if depth_range:
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jlists, jcounts, jst = jcull(jl, cam.view, cam.proj, W, H, tile_size=tw,
                                 tile_h=th, cap=cap, tile_depth_range=jd)
    tlists, tcounts, tst = tcull(tl, tcam.view, tcam.proj, W, H, tile_size=tw,
                                 tile_h=th, cap=cap, tile_depth_range=td)
    np.testing.assert_array_equal(tlists.numpy(), np.asarray(jlists))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    for k in ("max_count", "overflow_bins"):
        assert int(tst[k]) == int(jst[k]), k


def test_light_records_and_local_lights_match_jax(scene):
    """pack_light_records exact; eval_local_lights (the per-light evaluator
    of the non-fused path) within 1e-6 on every type."""
    from lsr_tpu.lighting.light_runtime import (
        eval_local_lights as jeval, pack_light_records as jpack,
        unpack_light_records)

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.light_runtime import (
        eval_local_lights as teval, pack_light_records as tpack)

    jl = _light_set("mixed")
    tl = convert.lights_soa(jl, "cpu")
    jrec = np.asarray(jpack(jl))
    np.testing.assert_array_equal(tpack(tl).numpy(), jrec)
    gb = scene["gb"]
    wp = np.asarray(gb.world_pos)[::8, ::8]
    n = np.asarray(gb.normal_ws)[::8, ::8]
    v = np.asarray(scene["j"][5].camera_pos)[None, None] - wp
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    cols = unpack_light_records(jnp.asarray(jrec))
    jd, js = jeval(cols, jnp.asarray(wp), jnp.asarray(n), jnp.asarray(v))
    tcols = {k: _t(np.asarray(c)) for k, c in cols.items()}
    td, ts = teval(tcols, _t(wp), _t(n), _t(v))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Fused shading (kernel B2's plain path)
# ---------------------------------------------------------------------------

def _fused_inputs(scene):
    """lsr_tpu's G-buffer with the scene's own materials (roughness >= 0.25)
    and a seeded sun-visibility plane."""
    gb = scene["gb"]
    mat = np.asarray(gb.mat)
    vis = np.random.default_rng(3).uniform(0.0, 1.0, (H, W)).astype(np.float32)
    return (np.asarray(gb.world_pos), np.asarray(gb.normal_ws),
            np.asarray(gb.covered), mat[..., 0:3], mat[..., 3], mat[..., 4],
            vis)


@pytest.mark.parametrize("model", ["pbr_mr", "blinn_phong"])
@pytest.mark.parametrize("kind", ["spot_point", "mixed"])
@pytest.mark.parametrize("sun", [False, True])
def test_shade_fused_matches_jax(scene, model, kind, sun):
    """Same G-buffer, lights and camera into lsr_tpu's shade_fused_pallas
    (interpret mode, with its trace-time apow1 / light_kinds) and the port's
    shade_fused.

    Local lights alone (sun radiance 0): lit rgb within 1e-5.  With the sun
    term: within 1e-5 + 5e-5 * |lit|.  Near the GGX highlight peak
    dden = ndh^2 (a^4 - 1) + 1 cancels to ~a^4 (4e-3 at roughness 0.25), so
    its rounding is amplified ~250x; XLA:CPU evaluates it as one FMA, torch
    (and the CUDA kernel, built with -fmad=false) round the product first.
    Blinn-Phong's pow(ndh, up to 128) amplifies ulps the same way."""
    from lsr_tpu.lighting.shade_kernel import shade_fused_pallas

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.shade_kernel import shade_fused

    jl = _light_set(kind)
    tl = convert.lights_soa(jl, "cpu")
    cam, tcam = scene["j"][4], scene["t"][4]
    eye = np.asarray(scene["j"][5].camera_pos, np.float32)
    sun_dir = np.asarray([0.35, -0.75, 0.45], np.float32)
    rad = np.asarray([2.0, 1.92, 1.8] if sun else [0.0, 0.0, 0.0], np.float32)
    ins = _fused_inputs(scene)
    kinds = tuple(sorted(int(t) for t in np.unique(np.asarray(jl.type))))
    fast = ("apow1",) if tl.apow1 else ()
    jlit, jst = shade_fused_pallas(
        *[jnp.asarray(a) for a in ins], jnp.asarray(eye),
        jnp.asarray(sun_dir), jnp.asarray(rad), jl, cam.view, cam.proj, W, H,
        tile_h=64, tile_w=128, cap=256, chunk=8, sun_model=model,
        fastmath=fast, light_kinds=kinds)
    tlit, tst = shade_fused(
        *[_t(a) for a in ins], _t(eye), _t(sun_dir), _t(rad), tl, tcam.view,
        tcam.proj, W, H, sun_model=model)
    jlit = np.asarray(jlit)
    np.testing.assert_allclose(tlit.numpy(), jlit, rtol=5e-5 if sun else 0,
                               atol=1e-5)
    assert int(tst["max_count"]) == int(jst["max_count"])
    assert np.abs(jlit).max() > 0.2      # the lights do reach the pixels


def test_shade_plain_light_kinds_bit_exact(scene):
    """The plain version drops math for light types absent from
    lights.kinds; that must be bit-exact against evaluating every type."""
    import dataclasses

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.shade_kernel import shade_fused

    tl = convert.lights_soa(_light_set("spot_point"), "cpu")
    tcam = scene["t"][4]
    args = [_t(a) for a in _fused_inputs(scene)] + [
        _t(np.asarray([0.5, 2.5, -4.0], np.float32)),
        _t(np.asarray([0.3, -0.7, 0.5], np.float32)),
        _t(np.asarray([2.0, 2.0, 2.0], np.float32))]
    a, _ = shade_fused(*args, tl, tcam.view, tcam.proj, W, H)
    every = dataclasses.replace(tl, kinds=(0, 1, 2, 3, 4, 5))
    b, _ = shade_fused(*args, every, tcam.view, tcam.proj, W, H)
    assert torch.equal(a, b)


def test_shade_fused_rejects_unported_options(scene):
    """Options that do not fit together are refused, never fall through:
    clustered slices (kernel variant B2b) without their slice plane, a
    slice plane without slices, slices without zn / zf, a slice plane of
    the wrong size; local-shadow planes without their light -> plane
    index, or of the wrong size."""
    from lsr_tpu_torch.lighting.shade_kernel import shade_fused

    tl = scene["t"][2]
    tcam = scene["t"][4]
    args = [_t(a) for a in _fused_inputs(scene)] + [
        torch.zeros(3), torch.tensor([0.0, -1.0, 0.0]), torch.ones(3), tl,
        tcam.view, tcam.proj, W, H]
    plane = torch.zeros(H, W, dtype=torch.int64)
    with pytest.raises(ValueError, match="come together"):
        shade_fused(*args, slices=4)
    with pytest.raises(ValueError, match="come together"):
        shade_fused(*args, cluster_slice_plane=plane)
    with pytest.raises(ValueError, match="zn and zf"):
        shade_fused(*args, cluster_slice_plane=plane, slices=4)
    with pytest.raises(ValueError, match="cluster_slice_plane must be"):
        shade_fused(*args, cluster_slice_plane=plane[:, 1:], slices=4,
                    zn=tcam.zn, zf=tcam.zf)
    with pytest.raises(ValueError, match="light_shadow_index"):
        shade_fused(*args, local_vis_stack=torch.ones(H, W, 2))
    with pytest.raises(ValueError, match="planes must be"):
        shade_fused(*args, local_vis_stack=torch.ones(H, W - 1, 2),
                    light_shadow_index=torch.zeros(tl.count,
                                                   dtype=torch.int64))


def _seeded_planes(n_lights, k=3, seed=5):
    """(K + 1, H, W) local-shadow planes in [0, 1] with plane K = 1.0, and
    a plane index in [0, K] per light (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    planes = rng.uniform(0.0, 1.0, (k + 1, H, W)).astype(np.float32)
    planes[k] = 1.0
    return planes, rng.integers(0, k + 1, n_lights).astype(np.int32)


@pytest.mark.parametrize("kind", ["spot_point", "mixed"])
def test_shade_fused_local_planes_match_jax(scene, kind):
    """Kernel variant B2a's plain version: the same inputs with seeded
    local-shadow planes into shade_fused_pallas(local_vis_stack=...,
    light_shadow_index=..., interpret=True) and the port's shade_fused;
    the tolerances of test_shade_fused_matches_jax with the sun term.  The
    planes change the result."""
    from lsr_tpu.lighting.shade_kernel import shade_fused_pallas

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.shade_kernel import shade_fused

    jl = _light_set(kind)
    tl = convert.lights_soa(jl, "cpu")
    cam, tcam = scene["j"][4], scene["t"][4]
    eye = np.asarray(scene["j"][5].camera_pos, np.float32)
    sun_dir = np.asarray([0.35, -0.75, 0.45], np.float32)
    rad = np.asarray([2.0, 1.92, 1.8], np.float32)
    ins = _fused_inputs(scene)
    planes, idx = _seeded_planes(tl.count)
    kinds = tuple(sorted(int(t) for t in np.unique(np.asarray(jl.type))))
    jlit, _ = shade_fused_pallas(
        *[jnp.asarray(a) for a in ins], jnp.asarray(eye),
        jnp.asarray(sun_dir), jnp.asarray(rad), jl, cam.view, cam.proj, W, H,
        tile_h=64, tile_w=128, cap=256, chunk=8, sun_model="pbr_mr",
        fastmath=("apow1",) if tl.apow1 else (), light_kinds=kinds,
        local_vis_stack=jnp.asarray(planes.transpose(1, 2, 0)),
        light_shadow_index=jnp.asarray(idx), interpret=True)
    targs = [_t(a) for a in ins] + [_t(eye), _t(sun_dir), _t(rad), tl,
                                    tcam.view, tcam.proj, W, H]
    tlit, _ = shade_fused(*targs, local_vis_stack=_t(planes).permute(1, 2, 0),
                          light_shadow_index=_t(idx))
    jlit = np.asarray(jlit)
    np.testing.assert_allclose(tlit.numpy(), jlit, rtol=5e-5, atol=1e-5)
    plain, _ = shade_fused(*targs)
    assert float((plain - tlit).abs().max()) > 0.05


def _shade_walk(scene, monkeypatch, kind, model, planes, eager=False):
    """The port's shade_fused on the CPU (kernel B2's plain version) on the
    scene, with seeded local-shadow planes or without: (lit as it is, lit
    with the terms of every pair that B2's light walk skips set to +0
    (light_walk.walked_terms), its (listed, walked) covered pairs).  eager:
    the box test's range 20% short, a walk that skips too much."""
    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting import light_walk
    from lsr_tpu_torch.lighting import shade_kernel as sk

    tl = convert.lights_soa(_light_set(kind), "cpu")
    tcam = scene["t"][4]
    kw = {}
    if planes:
        vis, idx = _seeded_planes(tl.count)
        kw = dict(local_vis_stack=_t(vis).permute(1, 2, 0),
                  light_shadow_index=_t(idx))
    args = [_t(a) for a in _fused_inputs(scene)] + [
        _t(np.asarray([0.5, 2.5, -4.0], np.float32)),
        _t(np.asarray([0.3, -0.7, 0.5], np.float32)),
        _t(np.asarray([2.0, 1.92, 1.8], np.float32)), tl, tcam.view,
        tcam.proj, W, H]
    lit, _ = sk.shade_fused(*args, sun_model=model, **kw)
    counts = sk._prepare(*args, 64, 128, 256, 8, None, model,
                         kw.get("local_vis_stack"),
                         kw.get("light_shadow_index"), None, 0)[2]
    if eager:
        near = light_walk.lights_near_box

        def tight(blk, *a):
            blk = blk.clone()
            blk[..., 17] *= 0.8
            return near(blk, *a)

        monkeypatch.setattr(light_walk, "lights_near_box", tight)
    terms = light_walk.walked_terms(sk.light_terms, counts, 256, 8, 64, 128)
    monkeypatch.setattr(sk, "light_terms", terms)
    walked, _ = sk.shade_fused(*args, sun_model=model, **kw)
    return lit, walked, terms.pairs


@pytest.mark.parametrize("model", ["pbr_mr", "blinn_phong"])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("kind", ["spot_point", "mixed"])
def test_shade_plain_unchanged_by_what_the_walk_skips(scene, monkeypatch,
                                                      kind, model, planes):
    """Kernel B2's light walk (csrc/light_walk.cuh) leaves out list slots
    past its walk, lights its 8x4 warp's box test drops and lights its
    warp's vote finds no pixel for.  The plain version with the terms of
    every such pair set to +0 before the chunk sums equals the plain
    version bit for bit, with and without local-shadow planes, for both
    sun models; and the walk does leave out pairs the lists hold."""
    lit, walked, (listed, kept) = _shade_walk(scene, monkeypatch, kind,
                                              model, planes)
    assert torch.equal(walked.view(torch.int32), lit.view(torch.int32))
    assert 0 < kept < 0.5 * listed, (kept, listed)


def test_shade_walk_sweep_catches_an_eager_skip(scene, monkeypatch):
    """The test of the test: with the box test's range 20% short the same
    comparison finds a changed pixel."""
    lit, walked, _ = _shade_walk(scene, monkeypatch, "mixed", "pbr_mr", True,
                                 eager=True)
    assert not torch.equal(walked.view(torch.int32), lit.view(torch.int32))


# ---------------------------------------------------------------------------
# Clustered slices (kernel variant B2b's plain path)
# ---------------------------------------------------------------------------

SLICES = 16


def _slice_plane(scene):
    """lsr_tpu's cluster slice of each pixel of the scene's G-buffer (numpy
    int32), which both packages then take as the same input."""
    from lsr_tpu.lighting.light_culling import view_depth_to_cluster_slice

    cam = scene["j"][4]
    view_z = cam.zn + scene["gb"].depth01 * (cam.zf - cam.zn)
    return np.asarray(view_depth_to_cluster_slice(view_z, cam.zn, cam.zf,
                                                  SLICES))


@pytest.mark.parametrize("model,planes,kind", [
    ("pbr_mr", False, "spot_point"), ("blinn_phong", False, "mixed"),
    ("pbr_mr", True, "mixed")])
def test_shade_fused_clustered_matches_jax(scene, model, planes, kind):
    """Kernel variant B2b's plain version: the same G-buffer, slice plane
    (lsr_tpu's), lights and camera into lsr_tpu's shade_fused_pallas(...,
    cluster_slice_plane, slices=16) in interpret mode and the port's
    shade_fused; lit rgb within 1e-4 (the sun term's GGX / Blinn-Phong
    rounding, as test_shade_fused_matches_jax), with and without seeded
    local-shadow planes.  The pixels span several slices, and the lists
    differ from slice to slice."""
    from lsr_tpu.lighting.shade_kernel import shade_fused_pallas

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting.shade_kernel import shade_fused

    jl = _light_set(kind)
    tl = convert.lights_soa(jl, "cpu")
    cam, tcam = scene["j"][4], scene["t"][4]
    eye = np.asarray(scene["j"][5].camera_pos, np.float32)
    sun_dir = np.asarray([0.35, -0.75, 0.45], np.float32)
    rad = np.asarray([2.0, 1.92, 1.8], np.float32)
    ins = _fused_inputs(scene)
    sp = _slice_plane(scene)
    covered = np.asarray(scene["gb"].covered)
    assert len(np.unique(sp[covered])) >= 3
    jkw, tkw = {}, {}
    if planes:
        vis, idx = _seeded_planes(tl.count)
        jkw = dict(local_vis_stack=jnp.asarray(vis.transpose(1, 2, 0)),
                   light_shadow_index=jnp.asarray(idx))
        tkw = dict(local_vis_stack=_t(vis).permute(1, 2, 0),
                   light_shadow_index=_t(idx))
    kinds = tuple(sorted(int(t) for t in np.unique(np.asarray(jl.type))))
    jlit, jst = shade_fused_pallas(
        *[jnp.asarray(a) for a in ins], jnp.asarray(eye),
        jnp.asarray(sun_dir), jnp.asarray(rad), jl, cam.view, cam.proj, W, H,
        tile_h=64, tile_w=128, cap=256, chunk=8, sun_model=model,
        fastmath=("apow1",) if tl.apow1 else (), light_kinds=kinds,
        cluster_slice_plane=jnp.asarray(sp), slices=SLICES, zn=cam.zn,
        zf=cam.zf, interpret=True, **jkw)
    tlit, tst = shade_fused(
        *[_t(a) for a in ins], _t(eye), _t(sun_dir), _t(rad), tl, tcam.view,
        tcam.proj, W, H, sun_model=model, cluster_slice_plane=_t(sp),
        slices=SLICES, zn=tcam.zn, zf=tcam.zf, **tkw)
    jlit = np.asarray(jlit)
    np.testing.assert_allclose(tlit.numpy(), jlit, rtol=0, atol=1e-4)
    assert int(tst["max_count"]) == int(jst["max_count"])
    assert np.abs(jlit).max() > 0.2


def test_forward_plus_clustered_matches_jax(scene):
    """shade_forward_plus(mode="clustered") of both packages on the same
    G-buffer (its slice plane computed on each side): the slice planes are
    equal on every pixel, and HDR within 1e-4."""
    from lsr_tpu.passes.forward_plus import shade_forward_plus as jfp

    from lsr_tpu_torch.lighting.light_culling import (
        view_depth_to_cluster_slice)
    from lsr_tpu_torch.passes.forward_plus import shade_forward_plus as tfp
    from lsr_tpu_torch.raster.interp import interpolate_gbuffer

    _, _, jl, _, cam, jctx = scene["j"]
    _, _, tl, _, tcam, tctx = scene["t"]
    tgb = interpolate_gbuffer(torch_setup(scene["setup"]),
                              _t(scene["depth"]), _t(scene["tid"]),
                              materials=tctx.materials,
                              want_face_normal=False)
    tz = tcam.zn + tgb.depth01 * (tcam.zf - tcam.zn)
    tsp = view_depth_to_cluster_slice(tz, tcam.zn, tcam.zf, SLICES)
    np.testing.assert_array_equal(tsp.numpy(), _slice_plane(scene))
    jhdr, _ = jfp(scene["gb"], jctx, jl, cam.view, cam.proj, cam.zn, cam.zf,
                  W, H, tile_size=16, cap=128, mode="clustered",
                  slices=SLICES, sun_model="pbr_mr")
    thdr, _ = tfp(tgb, tctx, tl, tcam.view, tcam.proj, tcam.zn, tcam.zf, W,
                  H, tile_size=16, cap=128, mode="clustered", slices=SLICES,
                  sun_model="pbr_mr")
    np.testing.assert_allclose(thdr.numpy(), np.asarray(jhdr), rtol=0,
                               atol=1e-4)


def _clustered_walk(scene, monkeypatch, planes, wild=False, drop_wild=False):
    """_shade_walk for clustered lists (16 slices, lsr_tpu's slice plane):
    (lit as it is, lit with the terms of every pair B2b's sliced walk skips
    set to +0, its (listed, walked) covered pairs of the lists' slices).
    wild: the first light's intensity is infinite, so a reached pixel of
    another slice adds NaN; drop_wild: a walk model that forgets such
    lights (the test of the test)."""
    from lsr_tpu_torch import convert
    from lsr_tpu_torch.lighting import light_walk
    from lsr_tpu_torch.lighting import shade_kernel as sk

    tl = convert.lights_soa(_light_set("mixed"), "cpu")
    if wild:
        tl.intensity[0] = float("inf")
    tcam = scene["t"][4]
    kw = dict(cluster_slice_plane=_t(_slice_plane(scene)), slices=SLICES,
              zn=tcam.zn, zf=tcam.zf)
    if planes:
        vis, idx = _seeded_planes(tl.count)
        kw.update(local_vis_stack=_t(vis).permute(1, 2, 0),
                  light_shadow_index=_t(idx))
    args = [_t(a) for a in _fused_inputs(scene)] + [
        _t(np.asarray([0.5, 2.5, -4.0], np.float32)),
        _t(np.asarray([0.3, -0.7, 0.5], np.float32)),
        _t(np.asarray([2.0, 1.92, 1.8], np.float32)), tl, tcam.view,
        tcam.proj, W, H]
    lit, _ = sk.shade_fused(*args, **kw)
    counts = sk._prepare(*args, 64, 128, 256, 8, None, "pbr_mr",
                         kw.get("local_vis_stack"),
                         kw.get("light_shadow_index"),
                         kw["cluster_slice_plane"], SLICES, tcam.zn,
                         tcam.zf)[2]
    if drop_wild:
        monkeypatch.setattr(light_walk, "finite_gain",
                            lambda blk: torch.ones_like(blk[..., 16],
                                                        dtype=torch.bool))
    terms = light_walk.walked_terms(sk.light_terms, counts, 256, 8, 64, 128,
                                    SLICES)
    monkeypatch.setattr(sk, "light_terms", terms)
    walked, _ = sk.shade_fused(*args, **kw)
    return lit, walked, terms.pairs


@pytest.mark.parametrize("planes", [False, True])
def test_shade_plain_clustered_unchanged_by_what_the_walk_skips(
        scene, monkeypatch, planes):
    """B2b's sliced walk (csrc/shade_fused.cu, light_walk.cuh's SLICED
    steps): the box, the uncovered-warp rule and the vote count only the
    pixels of a list's slice.  The plain clustered version with the terms
    of every pair it skips set to +0 equals itself bit for bit; the walk
    keeps under a fifth of the (covered pixel, listed light) pairs of the
    slices."""
    lit, walked, (listed, kept) = _clustered_walk(scene, monkeypatch, planes)
    assert torch.equal(walked.view(torch.int32), lit.view(torch.int32))
    assert 0 < kept < 0.2 * listed, (kept, listed)


def test_shade_clustered_walk_keeps_non_finite_gain_lights(scene,
                                                           monkeypatch):
    """A light of infinite intensity gives NaN at the pixels of other
    slices that it reaches (lsr_tpu's gain * 0): the sliced walk keeps it,
    bit for bit with the plain version, NaN included; a walk model that
    treats it as any light changes the result."""
    lit, walked, _ = _clustered_walk(scene, monkeypatch, False, wild=True)
    assert bool(torch.isnan(lit).any())
    assert torch.equal(walked.view(torch.int32), lit.view(torch.int32))
    monkeypatch.undo()
    lit, walked, _ = _clustered_walk(scene, monkeypatch, False, wild=True,
                                     drop_wild=True)
    assert not torch.equal(walked.view(torch.int32), lit.view(torch.int32))


# ---------------------------------------------------------------------------
# G-buffer, materials, texture, ambient, post
# ---------------------------------------------------------------------------

def test_interpolate_gbuffer_matches_jax(scene):
    """Same setup + visibility buffer: attributes within 2e-5 (world
    positions ~1-10: f32 interpolation with FMA vs without), ids, coverage
    and material records exact."""
    from lsr_tpu_torch.raster.interp import interpolate_gbuffer

    s = scene["setup"]
    tsetup = torch_setup(s)
    gb = interpolate_gbuffer(tsetup, _t(scene["depth"]), _t(scene["tid"]),
                             materials=scene["t"][3].materials,
                             want_face_normal=True)
    from lsr_tpu.raster.interp import interpolate_gbuffer as jinterp

    jgb = jinterp(s, scene["depth"], scene["tid"],
                  materials=scene["j"][3].materials, want_face_normal=True)
    for f in ("world_pos", "normal_ws", "uv", "bary", "face_normal",
              "tangent"):
        np.testing.assert_allclose(getattr(gb, f).numpy(),
                                   np.asarray(getattr(jgb, f)), rtol=0,
                                   atol=2e-5, err_msg=f)
    for f in ("obj_id", "covered", "tri_id", "mat"):
        np.testing.assert_array_equal(getattr(gb, f).numpy(),
                                      np.asarray(getattr(jgb, f)), err_msg=f)


def test_material_lookup_clamps_like_jax():
    """Object ids past the end of the material table clamp to its last row
    (lsr_tpu's XLA gather semantics, which the 26-object / 5-material
    flagship scene relies on)."""
    from lsr_tpu.shading.common import gather_materials as jgm
    from lsr_tpu.shading.common import make_materials as jmm

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.shading.common import gather_materials as tgm

    jm = jmm(base_color=[(0.1, 0.2, 0.3), (0.4, 0.5, 0.6), (0.7, 0.8, 0.9)],
             metallic=[0.1, 0.2, 0.3], roughness=[0.4, 0.5, 0.6],
             tex_id=[-1, 0, -1])
    ids = np.array([[-1, 0, 1], [2, 3, 25]], np.int32)
    want = jgm(jm, jnp.asarray(ids))
    got = tgm(convert.materials_soa(jm, "cpu"), _t(ids))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_texture_and_ambient_match_jax(scene):
    """Bilinear texture sampling (quads path) and the fake-IBL ambient within
    1e-6 on the scene's G-buffer."""
    from lsr_tpu.shading.common import eval_fake_ibl as jibl
    from lsr_tpu.shading.common import sample_texture_bilinear as jtex

    from lsr_tpu_torch.shading.common import eval_fake_ibl as tibl
    from lsr_tpu_torch.shading.common import sample_texture_bilinear as ttex

    jctx, tctx = scene["j"][3], scene["t"][3]
    gb = scene["gb"]
    rng = np.random.default_rng(4)
    uv = rng.uniform(-3.0, 3.0, (H, W, 2)).astype(np.float32)
    tex_id = rng.integers(-1, 1, (H, W)).astype(np.int32)
    want = jtex(jctx.textures, jnp.asarray(tex_id), jnp.asarray(uv),
                quads=jctx.texture_quads)
    got = ttex(tctx.textures, _t(tex_id), _t(uv), quads=tctx.texture_quads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    n = np.asarray(gb.normal_ws)
    v = rng.standard_normal((H, W, 3)).astype(np.float32)
    alb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    m, r, ao = (rng.uniform(0, 1, (H, W, 1)).astype(np.float32)
                for _ in range(3))
    want = jibl(*[jnp.asarray(a) for a in (n, v, alb, m, r, ao)])
    got = tibl(*[_t(a) for a in (n, v, alb, m, r, ao)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_tonemap_and_fxaa_match_jax():
    """Same HDR into both post chains (gradients and hard-edged discs):
    tonemap within 1 LSB everywhere and exact on >= 99.9% of channels
    (pow(c, 1/2.2) ulps can cross a rounding boundary); FXAA on the same LDR
    within 1 LSB everywhere and exact on >= 99.9% of pixels (its luma is one
    FMA chain under XLA:CPU, so a luma tie can break the other way)."""
    from lsr_tpu.passes.post import fxaa_pass as jfx
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    from lsr_tpu_torch.passes.post import fxaa_pass as tfx
    from lsr_tpu_torch.passes.tonemap import tonemap_pass as ttm

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    hdr = np.stack([xx / W * 2.0, yy / H * 1.5, 0.3 + 0.0 * xx], -1)
    for cx, cy, r, c in ((40, 30, 18, (3.0, 0.2, 0.1)),
                         (90, 60, 25, (0.1, 0.8, 2.5)),
                         (70, 20, 9, (0.0, 0.0, 0.0))):
        hdr[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = c
    hdr = hdr.astype(np.float32)
    jl = np.asarray(jtm(jnp.asarray(hdr))).astype(int)
    tl = ttm(_t(hdr)).numpy().astype(int)
    d = np.abs(jl - tl)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())
    ldr = jl.astype(np.uint8)
    ja = np.asarray(jfx(jnp.asarray(ldr))).astype(int)
    ta = tfx(torch.as_tensor(ldr)).numpy().astype(int)
    d = np.abs(ja - ta).max(-1)
    assert (ja != jl).any(-1).mean() > 0.02     # FXAA is active on the edges
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())


def test_forward_plus_rejects_unported_options(scene):
    """The branches of shade_forward_plus that raised until this slice
    (the test keeps its name): use_kernel=False, another sun model (toon:
    the general branch either way), environment probes on the fused branch
    (the scene's lights plus one probe) and the context's surface maps
    (a bump normal map on the ground), each from lsr_tpu's G-buffer,
    against lsr_tpu's shade_forward_plus: HDR within 1e-4 on >= 99.9% of
    pixels, and each option changes the frame."""
    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.passes.forward_plus import shade_forward_plus as jsh
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.shading.common import bump_normal_texture, make_materials
    from lsr_tpu.shading.models import make_shade_context

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.passes.forward_plus import shade_forward_plus as tsh
    from torch_scenes import torch_gbuffer

    _, _, jl, jctx, cam, ctx_t = scene["j"]
    gb = interpolate_gbuffer(scene["setup"], scene["depth"], scene["tid"],
                             materials=jctx.materials)
    tgb = torch_gbuffer(gb)
    m = jctx.materials
    tex = np.stack([np.asarray(jctx.textures[0]), bump_normal_texture(128)])
    maps_ctx = make_shade_context(
        make_materials(base_color=np.asarray(m.base_color),
                       metallic=np.asarray(m.metallic),
                       roughness=np.asarray(m.roughness),
                       tex_id=np.asarray(m.tex_id),
                       normal_tex=[-1, -1, -1, -1, 1]),
        light_dir_ws=jctx.light_dir_ws, light_color=jctx.light_color,
        light_intensity=jctx.light_intensity, camera_pos=ctx_t.camera_pos,
        textures=jnp.asarray(tex))
    lb = LightSetBuilder()
    for i in range(int(jl.type.shape[0])):
        kw = {k: np.asarray(getattr(jl, k))[i] for k in (
            "direction", "inner_angle", "outer_angle")}
        lb._add(type=int(jl.type[i]),
                position=tuple(np.asarray(jl.position[i]).tolist()),
                color=tuple(np.asarray(jl.color[i]).tolist()),
                intensity=float(jl.intensity[i]), range=float(jl.range[i]),
                direction=tuple(kw["direction"].tolist()),
                inner_angle=float(kw["inner_angle"]),
                outer_angle=float(kw["outer_angle"]))
    lb.env_probe((0.0, 0.0, 0.0), color=(2.0, 1.5, 1.0), intensity=1.5,
                 range=3.0)
    probe_lights = lb.build()
    # The G-buffer's material record carries the texture slots.
    gb_maps = interpolate_gbuffer(scene["setup"], scene["depth"],
                                  scene["tid"], materials=maps_ctx.materials)
    cases = {"use_kernel": (ctx_t, jl, dict(use_kernel=False), gb),
             "sun_model": (ctx_t, jl, dict(sun_model="toon"), gb),
             "env_probes": (ctx_t, probe_lights, dict(env_probes=True), gb),
             "surface maps": (maps_ctx, jl, {}, gb_maps)}
    base_t, _ = tsh(tgb, convert.shade_context(
        ctx_t, convert.materials_soa(ctx_t.materials, "cpu"), "cpu"),
        convert.lights_soa(jl, "cpu"), _t(cam.view), _t(cam.proj),
        float(cam.zn), float(cam.zf), W, H, cap=32)
    for name, (jc, lights, kw, jgb) in cases.items():
        want, _ = jsh(jgb, jc, lights, cam.view, cam.proj, cam.zn, cam.zf, W,
                      H, cap=32, **kw)
        tc = convert.shade_context(jc, convert.materials_soa(
            jc.materials, "cpu"), "cpu")
        got, _ = tsh(torch_gbuffer(jgb), tc, convert.lights_soa(lights, "cpu"),
                     _t(cam.view), _t(cam.proj), float(cam.zn),
                     float(cam.zf), W, H, cap=32, **kw)
        err = np.abs(got.numpy() - np.asarray(want)).max(-1)
        assert np.isfinite(got.numpy()).all(), name
        assert (err <= 1e-4).mean() >= 0.999, (name, float(err.max()))
        if name != "use_kernel":
            assert float((got - base_t).abs().max()) > 1e-3, name

