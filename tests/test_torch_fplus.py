"""lsr_tpu_torch's Forward+ light accumulation (kernel B6's plain path) vs
lsr_tpu's accumulate_lights_pallas in Pallas interpret mode (CPU).

Both packages get lsr_tpu's own G-buffer of a small rendered scene
(tests/torch_scenes.py) and the same light set: 12 lights cycling spot,
rect, tube and point (tests/test_lights.py:190-204, with non-unit
attenuation powers and mixed attenuation models added), at lsr_tpu's own
test tiles (16x128, cap 32, chunk 8) and at the default 64x128 (cap 256,
chunk 16).  Tolerance: lsr_tpu's own bar for this kernel
(tests/test_lights.py:224-227, atol 3e-4 and rtol 2e-3) is not needed; the
results agree within atol 2e-5 + rtol 1e-5 (f32 rounding: XLA:CPU fuses
multiply-adds, and sums the chunk in its own order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_scenes import jax_camera, jax_flagship_scene, to_torch

W, H = 128, 64


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, _, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid)
    b = LightSetBuilder()
    rng = np.random.default_rng(5)
    for i in range(12):
        p = tuple(rng.uniform([-3, 0, -3], [3, 2, 3]).tolist())
        c = tuple(rng.uniform(0.3, 1.0, 3).tolist())
        if i % 4 == 0:
            b.spot(p, (0, -1, 0), color=c, intensity=2.0, range=4.0)
        elif i % 4 == 1:
            b.rect_area(p, (0, -1, 0), color=c, intensity=1.5, range=4.0,
                        atten_power=1.5)
        elif i % 4 == 2:
            b.tube_area(p, axis=(1, 0, 0), color=c, intensity=1.5, range=4.0,
                        atten_model=i % 3)
        else:
            b.point(p, color=c, intensity=1.5, range=3.0, atten_model=1)
    lights = b.build()
    _, _, tl, _, tcam, tct = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    return dict(gb=gb, lights=lights, cam=cam, eye=ctx_t.camera_pos,
                tl=tl, tcam=tcam, teye=tct.camera_pos)


@pytest.mark.parametrize("tile_h,cap,chunk", [(16, 32, 8), (64, 256, 16),
                                              (64, 256, 8)])
def test_accumulate_lights_matches_pallas(scene, tile_h, cap, chunk):
    """Diffuse and specular within atol 2e-5 + rtol 1e-5; the bin counts
    equal."""
    from lsr_tpu.lighting.fplus_kernel import accumulate_lights_pallas

    from lsr_tpu_torch.lighting.fplus_kernel import accumulate_lights

    gb, cam = scene["gb"], scene["cam"]
    jd, js, jst = accumulate_lights_pallas(
        gb.world_pos, gb.normal_ws, gb.covered, scene["eye"], scene["lights"],
        cam.view, cam.proj, W, H, tile_h=tile_h, tile_w=128, cap=cap,
        chunk=chunk, interpret=True)
    td, ts, tst = accumulate_lights(
        _t(gb.world_pos), _t(gb.normal_ws), _t(gb.covered), scene["teye"],
        scene["tl"], scene["tcam"].view, scene["tcam"].proj, W, H,
        tile_h=tile_h, tile_w=128, cap=cap, chunk=chunk)
    assert int(tst["max_count"]) == int(jst["max_count"]) > 0
    assert int(tst["overflow_bins"]) == int(jst["overflow_bins"])
    jd, js = np.asarray(jd), np.asarray(js)
    assert jd.max() > 0.05 and js.max() > 0.01        # lights do land
    np.testing.assert_allclose(td.numpy(), jd, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), js, atol=2e-5, rtol=1e-5)


def test_accumulate_lights_walks_at_most_cap(scene):
    """A cap below the busiest tile's count truncates that tile's walk to
    cap / chunk chunks, as lsr_tpu's kernel does: equal to the Pallas
    kernel on the same truncated lists (same tolerance)."""
    from lsr_tpu.lighting.fplus_kernel import accumulate_lights_pallas

    from lsr_tpu_torch.lighting.fplus_kernel import accumulate_lights

    gb, cam = scene["gb"], scene["cam"]
    jd, js, jst = accumulate_lights_pallas(
        gb.world_pos, gb.normal_ws, gb.covered, scene["eye"], scene["lights"],
        cam.view, cam.proj, W, H, tile_h=16, tile_w=128, cap=8, chunk=8,
        interpret=True)
    td, ts, tst = accumulate_lights(
        _t(gb.world_pos), _t(gb.normal_ws), _t(gb.covered), scene["teye"],
        scene["tl"], scene["tcam"].view, scene["tcam"].proj, W, H,
        tile_h=16, tile_w=128, cap=8, chunk=8)
    assert int(jst["overflow_bins"]) > 0
    assert int(tst["overflow_bins"]) == int(jst["overflow_bins"])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5,
                               rtol=1e-5)


def test_accumulate_lights_checks_its_arguments(scene):
    """Chunks other than 8 / 16, caps that are not a multiple of the chunk
    and tiles that are not multiples of 8x32 raise; a non-CPU, non-CUDA
    tensor raises rather than running the plain version."""
    from lsr_tpu_torch.lighting.fplus_kernel import accumulate_lights

    gb = scene["gb"]
    args = (_t(gb.world_pos), _t(gb.normal_ws), _t(gb.covered), scene["teye"],
            scene["tl"], scene["tcam"].view, scene["tcam"].proj, W, H)
    for kw in (dict(chunk=4, cap=32), dict(chunk=8, cap=36),
               dict(tile_h=12)):
        with pytest.raises(ValueError):
            accumulate_lights(*args, **kw)
    meta = (args[0].to("meta"),) + args[1:]
    with pytest.raises(ValueError, match="unsupported device"):
        accumulate_lights(*meta)


def _fplus_walk(scene, monkeypatch, tile_h, cap, chunk, eager=False):
    """accumulate_lights on the CPU (kernel B6's plain version): (diffuse
    and specular as they are, the same with the terms of every pair that
    B6's light walk skips set to +0 (light_walk.walked_terms), its (listed,
    walked) covered pairs).  eager: the box test's range 20% short."""
    from lsr_tpu_torch.lighting import fplus_kernel as fk
    from lsr_tpu_torch.lighting import light_walk

    gb = scene["gb"]
    args = (_t(gb.world_pos), _t(gb.normal_ws), _t(gb.covered), scene["teye"],
            scene["tl"], scene["tcam"].view, scene["tcam"].proj, W, H,
            tile_h, 128, cap, chunk)
    d, s, _ = fk.accumulate_lights(*args)
    counts = fk._prepare(*args, None)[2]
    if eager:
        near = light_walk.lights_near_box

        def tight(blk, *a):
            blk = blk.clone()
            blk[..., 17] *= 0.8
            return near(blk, *a)

        monkeypatch.setattr(light_walk, "lights_near_box", tight)
    terms = light_walk.walked_terms(fk.light_terms, counts, cap, chunk,
                                    tile_h, 128)
    monkeypatch.setattr(fk, "light_terms", terms)
    dw, sw, _ = fk.accumulate_lights(*args)
    return torch.cat([d, s]), torch.cat([dw, sw]), terms.pairs


@pytest.mark.parametrize("tile_h,cap,chunk", [(64, 256, 16), (16, 64, 8)])
def test_accumulate_plain_unchanged_by_what_the_walk_skips(
        scene, monkeypatch, tile_h, cap, chunk):
    """Kernel B6's light walk (csrc/light_walk.cuh) leaves out list slots
    past its walk, lights its 8x4 warp's box test drops and lights its
    warp's vote finds no pixel for.  The plain version with the terms of
    every such pair set to +0 before the chunk sums equals the plain
    version bit for bit, at 64x128 tiles with 16-light chunks and at 16x128
    with 8; and the walk does leave out pairs the lists hold."""
    out, walked, (listed, kept) = _fplus_walk(scene, monkeypatch, tile_h, cap,
                                              chunk)
    assert torch.equal(walked.view(torch.int32), out.view(torch.int32))
    assert 0 < kept < 0.5 * listed, (kept, listed)


def test_accumulate_walk_sweep_catches_an_eager_skip(scene, monkeypatch):
    """The test of the test: with the box test's range 20% short the same
    comparison finds a changed pixel."""
    out, walked, _ = _fplus_walk(scene, monkeypatch, 64, 256, 16, eager=True)
    assert not torch.equal(walked.view(torch.int32), out.view(torch.int32))
