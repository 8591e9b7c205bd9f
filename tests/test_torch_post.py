"""lsr_tpu_torch's post passes and SSAO vs lsr_tpu (CPU): motion vectors
and motion blur, light shafts (the default zoom-compose march and the
linear one), the gaussian blur and its kernel, bloom, fog, outlines, depth
of field (autofocus and fixed focus), TAA, lens flare, and SSAO, on the same
inputs: lsr_tpu's G-buffer of Config #5's scene at 96x72
(tests/torch_scenes.py) and images made from numpy seeds.

Tolerance 1e-5 absolute unless a test states otherwise (float32 rounding:
XLA:CPU fuses multiply-adds, torch does not); bit for bit where the
operation is data movement (_shift_clamped) or a comparison of the same
depths (the SSAO mask).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import jax_full_scene, jax_gbuffer, state_to_torch, torch_gbuffer

W, H = 96, 72
TOL = 1e-5


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def frame():
    """Config #5's scene (no IBL: not read here) and lsr_tpu's G-buffer of
    it; an HDR image with values past 1 (the bloom threshold) and a
    velocity field."""
    js = jax_full_scene(W, H, ibl=False)
    setup, depth, tid, gb = jax_gbuffer(js, W, H)
    rng = np.random.default_rng(21)
    hdr = rng.uniform(0, 1.6, (H, W, 3)).astype(np.float32)
    vel = rng.normal(0, 6, (H, W, 2)).astype(np.float32)
    return dict(js=js, ts=state_to_torch(js), gb=gb, tgb=torch_gbuffer(gb),
                depth=np.asarray(depth), tid=np.asarray(tid), hdr=hdr,
                vel=vel)


def test_motion_vectors_match_jax(frame):
    """Velocity of the moving object non-zero, every other pixel's zero,
    and within 1e-4 px of lsr_tpu's (each side inverts the model matrices
    in float32)."""
    from lsr_tpu.passes.post import motion_vectors_pass as jmv
    from lsr_tpu_torch.passes.post import motion_vectors_pass as tmv

    js, ts = frame["js"], frame["ts"]
    cam, tcam = js["camera"], ts["camera"]
    # prev_viewproj of another camera, so that the camera moves too.
    from lsr_tpu.scene.scene import make_camera

    prev = np.array(make_camera(W, H, (0.9, 1.6, -4.4), (0, 0, 0.5)).viewproj)
    want = np.asarray(jmv(frame["gb"], js["objects"], cam.viewproj,
                          jnp.asarray(prev), W, H))
    got = tmv(frame["tgb"], ts["objects"], tcam.viewproj, T(prev), W,
              H).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # Camera still: only the moving object (object 0) moves.
    got0 = tmv(frame["tgb"], ts["objects"], tcam.viewproj, tcam.viewproj, W,
               H).numpy()
    moving = np.asarray(frame["gb"].obj_id) == 0
    assert moving.any() and (np.abs(got0[moving]).sum(-1) > 0).all()
    assert (got0[~moving] == 0).all()


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_motion_blur_matches_jax(frame, dtype):
    """The velocity line blur with the pass's parameters, on HDR floats and
    on u8 (rounded, so within 1 there)."""
    from lsr_tpu.passes.post import motion_blur_pass as jmb
    from lsr_tpu_torch.passes.post import motion_blur_pass as tmb

    img = frame["hdr"]
    if dtype == "u8":
        img = (np.clip(img / 1.6, 0, 1) * 255).astype(np.uint8)
    kw = dict(samples=8, strength=1.5, depth_reject=0.02)
    want = np.asarray(jmb(jnp.asarray(img), jnp.asarray(frame["depth"]),
                          jnp.asarray(frame["vel"]), jnp.float32(1 / 60),
                          **kw))
    got = tmb(T(img), T(frame["depth"]), T(frame["vel"]), 1 / 60,
              **kw).numpy()
    assert got.dtype == want.dtype
    tol = 1 if dtype == "u8" else TOL
    assert np.abs(got.astype(np.float32) - want).max() <= tol
    assert (np.abs(got.astype(np.float32) - img) > 0).any()  # it blurs


@pytest.mark.parametrize("log_march", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_light_shafts_match_jax(frame, log_march, dtype):
    """The god-ray march with the pass's parameters, toward a sun on
    screen (the camera looks at it): the default zoom-compose march and
    the linear one, on HDR floats and on u8 (within 1).  The reference is
    lsr_tpu's pass op by op, with its parameters as float32 values as its
    jitted pass sees them: jit on XLA:CPU fuses each tap's position into
    multiply-adds, and a position that then rounds to the neighbouring
    pixel moves 4.5% of the linear march's values by up to 2e-3 (the same
    kind of fact as ROADMAP C7 / C11)."""
    from lsr_tpu.passes.post import light_shafts_pass as jls
    from lsr_tpu.scene.scene import make_camera
    from lsr_tpu_torch.passes.post import light_shafts_pass as tls

    sun = np.array([0.2, -0.3, 0.9], np.float32)
    eye = np.array([0.0, 1.0, 0.0], np.float32)
    vp = np.array(make_camera(W, H, tuple(eye), tuple(eye - sun * 5)).viewproj)
    img = frame["hdr"]
    if dtype == "u8":
        img = (np.clip(img / 1.6, 0, 1) * 255).astype(np.uint8)
    kw = dict(density=0.9, weight=0.35, decay=0.94)
    want = np.asarray(jls.__wrapped__(
        jnp.asarray(img), jnp.asarray(frame["depth"]), jnp.asarray(eye),
        jnp.asarray(sun), jnp.asarray(vp), steps=48, log_march=log_march,
        **{k: jnp.float32(v) for k, v in kw.items()}))
    got = tls(T(img), T(frame["depth"]), T(eye), T(sun), T(vp), steps=48,
              log_march=log_march, **kw).numpy()
    assert got.dtype == want.dtype
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert d.max() <= (1 if dtype == "u8" else TOL), d.max()
    assert (np.abs(want.astype(np.float32) - img) > 0).mean() > 0.5


@pytest.mark.parametrize("off", [-3, -1, 1, 2, 5])
@pytest.mark.parametrize("axis", [0, 1])
def test_shift_clamped_bit_equal(off, axis):
    """Edge-clamped shifts are data movement: bit for bit."""
    from lsr_tpu.passes.post import _shift_clamped as js
    from lsr_tpu_torch.passes.post import _shift_clamped as ts

    x = np.random.default_rng(2).normal(size=(9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(ts(T(x), off, axis).numpy(),
                                  np.asarray(js(jnp.asarray(x), off, axis)))


def test_blur_bloom_fog_outline_match_jax(frame):
    """The gaussian kernel (radius 2, 4 and a given sigma), the separable
    blur, bloom with the pass's parameters, fog and outlines."""
    from lsr_tpu.passes import post as jp
    from lsr_tpu_torch.passes import post as tp

    for r, s in ((2, None), (4, None), (3, 1.7)):
        np.testing.assert_allclose(tp._gaussian_kernel1d(r, s).numpy(),
                                   np.asarray(jp._gaussian_kernel1d(r, s)),
                                   rtol=0, atol=1e-7)
    hdr, depth = frame["hdr"], frame["depth"]
    J = jnp.asarray
    pairs = [
        (tp.gaussian_blur(T(hdr), radius=3),
         jp.gaussian_blur(J(hdr), radius=3)),
        (tp.bloom_pass(T(hdr), threshold=1.0, intensity=0.5, blur_radius=4),
         jp.bloom_pass(J(hdr), threshold=1.0, intensity=0.5, blur_radius=4)),
        (tp.fog_pass(T(hdr), T(depth)), jp.fog_pass(J(hdr), J(depth))),
        (tp.outline_pass(T(hdr), T(depth)), jp.outline_pass(J(hdr), J(depth))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("focus", [-1.0, 0.97])
def test_depth_of_field_matches_jax(frame, focus):
    """Autofocus on the median of the center window (an even count of
    depths: the two middle values averaged, as jnp.median) and a fixed
    focus, focus range 0.05."""
    from lsr_tpu.passes.post import depth_of_field_pass as jd
    from lsr_tpu_torch.passes.post import _median_midpoint
    from lsr_tpu_torch.passes.post import depth_of_field_pass as td

    hdr, depth = frame["hdr"], frame["depth"]
    want = np.asarray(jd(jnp.asarray(hdr), jnp.asarray(depth),
                         focus_depth=focus, focus_range=0.05))
    got = td(T(hdr), T(depth), focus_depth=focus, focus_range=0.05).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    x = np.array([3.0, 1.0, 4.0, 2.0], np.float32)
    assert float(_median_midpoint(T(x))) == float(jnp.median(x)) == 2.5


def test_taa_and_lens_flare_match_jax(frame):
    """TAA (history reprojected by velocity, clamped to the wrapping 3x3
    neighbourhood, blend 0.1) and the lens flare."""
    from lsr_tpu.passes.post import lens_flare_pass as jlf
    from lsr_tpu.passes.post import taa_pass as jtaa
    from lsr_tpu_torch.passes.post import lens_flare_pass as tlf
    from lsr_tpu_torch.passes.post import taa_pass as ttaa

    rng = np.random.default_rng(5)
    hist = rng.uniform(0, 1.6, (H, W, 3)).astype(np.float32)
    hdr, vel = frame["hdr"], frame["vel"]
    jr, jh = jtaa(jnp.asarray(hdr), jnp.asarray(hist), jnp.asarray(vel),
                  blend=0.1)
    tr, th = ttaa(T(hdr), T(hist), T(vel), blend=0.1)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=TOL)
    assert torch.equal(tr, th)
    big = hdr * 2.0
    np.testing.assert_allclose(tlf(T(big)).numpy(),
                               np.asarray(jlf(jnp.asarray(big))), rtol=0,
                               atol=TOL)


def test_ssao_bit_equal_on_the_same_depth(frame):
    """The SSAO mask from the same depth buffer and coverage is lsr_tpu's
    op-by-op mask bit for bit (ssao_depth_pass and ssao_pass of a
    G-buffer), and it darkens some covered pixels; the tap offsets are the
    same integers.  lsr_tpu's jitted form differs from its own op-by-op
    form by a few ULP (XLA:CPU rewrites the 3x3 average), within 1e-6."""
    from lsr_tpu.passes.ssao import _spiral_offsets as jsp
    from lsr_tpu.passes.ssao import ssao_depth_pass as jd
    from lsr_tpu.passes.ssao import ssao_pass as jg
    from lsr_tpu_torch.passes.ssao import _spiral_offsets as tsp
    from lsr_tpu_torch.passes.ssao import ssao_depth_pass as td
    from lsr_tpu_torch.passes.ssao import ssao_pass as tg

    np.testing.assert_array_equal(tsp(12, 8.0), jsp(12, 8.0))
    cam = frame["js"]["camera"]
    covered = frame["tid"] >= 0
    args = (jnp.asarray(frame["depth"]), jnp.asarray(covered), cam.zn,
            cam.zf)
    want = np.asarray(jd.__wrapped__(*args))
    got = td(T(frame["depth"]), T(covered), float(cam.zn),
             float(cam.zf)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got, np.asarray(jd(*args)), rtol=0, atol=1e-6)
    assert (got[covered] < 1.0).any() and (got[~covered] == 1.0).all()
    gb = frame["gb"]
    want_g = np.asarray(jd.__wrapped__(gb.depth01, gb.covered, cam.zn,
                                       cam.zf, samples=8, radius_px=5.0))
    got_g = tg(frame["tgb"], float(cam.zn), float(cam.zf), samples=8,
               radius_px=5.0).numpy()
    np.testing.assert_array_equal(got_g.view(np.int32), want_g.view(np.int32))
    np.testing.assert_allclose(
        got_g, np.asarray(jg(gb, cam.zn, cam.zf, samples=8, radius_px=5.0)),
        rtol=0, atol=1e-6)
