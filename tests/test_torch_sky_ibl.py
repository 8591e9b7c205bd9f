"""lsr_tpu_torch's sky models and image-based lighting vs lsr_tpu (CPU):
procedural_sky, sample_cubemap (on cube edges too), camera_ray_dirs,
render_sky, the sky cubemap, the irradiance and prefiltered-specular bakes,
sample_prefiltered and eval_ibl, on the same inputs made from numpy seeds.

Tolerance 1e-5 absolute unless a test states otherwise; the residual is
float32 rounding (XLA:CPU fuses multiply-adds, torch does not).  The host
helpers (_face_dirs, _hammersley) are equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = 1e-5
SUN = (0.35, -0.7, 0.5)


def _dirs(n=4000, seed=3):
    """Random directions plus the cube's edge and corner ties (|x| = |y|,
    |y| = |z|, all equal) and the axes."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    ties = np.array([[1, 1, 0], [-1, 1, 0], [0, 1, 1], [0, -1, -1],
                     [1, 0, 1], [-1, 0, -1], [1, 1, 1], [-1, -1, -1],
                     [1, -1, 1], [1, 0, 0], [0, 1, 0], [0, 0, -1],
                     [0.5, 0.5, 0.2], [0.3, -0.3, 0.3]], np.float32)
    return np.concatenate([d, ties])


def _faces(size=8, seed=5):
    return np.random.default_rng(seed).uniform(
        0, 2, (6, size, size, 3)).astype(np.float32)


def _on_disk(d, sun, margin=1e-4):
    """Directions within (or at the rounding edge of) the sun disk
    (cos > 0.995 - margin)."""
    if sun is None:
        return np.zeros(d.shape[:-1], bool)
    u = d / np.linalg.norm(d, axis=-1, keepdims=True)
    s = -np.asarray(sun, np.float64)
    return u @ (s / np.linalg.norm(s)) > 0.995 - margin


def test_host_helpers_equal():
    """_face_dirs and _hammersley are the same arrays."""
    from lsr_tpu.resources import ibl as j
    from lsr_tpu_torch.resources import ibl as t

    for s in (4, 7, 16):
        np.testing.assert_array_equal(t._face_dirs(s), j._face_dirs(s))
    for n in (32, 64, 128, 256):
        np.testing.assert_array_equal(t._hammersley(n), j._hammersley(n))


@pytest.mark.parametrize("sun", [None, SUN])
def test_procedural_sky_matches_jax(sun):
    """The gradient sky (and the sun disk) on random directions; the disk's
    edge multiplies a cosine's rounding by ~5,000, so 1e-5 holds off the
    disk and 5e-4 on it."""
    from lsr_tpu.sky.sky_models import procedural_sky as jsky
    from lsr_tpu_torch.sky.sky_models import procedural_sky as tsky

    d = _dirs()
    want = np.asarray(jsky(jnp.asarray(d), sun_dir_ws=None if sun is None
                           else jnp.asarray(sun, jnp.float32)))
    got = tsky(torch.as_tensor(d), sun_dir_ws=sun).numpy()
    err = np.abs(got - want).max(-1)
    disk = _on_disk(d, sun)
    assert err[~disk].max() <= TOL, err[~disk].max()
    assert sun is None or (disk.any() and err[disk].max() <= 5e-4)


def test_sample_cubemap_matches_jax():
    """Bilinear cubemap lookups on random directions and on the cube's
    edges and corners, where the face choice ties (X before Y before Z)."""
    from lsr_tpu.sky.sky_models import sample_cubemap as js
    from lsr_tpu_torch.sky.sky_models import sample_cubemap as ts

    faces, d = _faces(), _dirs()
    want = np.asarray(js(jnp.asarray(faces), jnp.asarray(d)))
    got = ts(torch.as_tensor(faces), torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[-14:], want[-14:], rtol=0, atol=TOL)


def test_camera_rays_and_render_sky_match_jax():
    """camera_ray_dirs on the same inverse, and render_sky (procedural with
    the sun, and the cubemap kind on the baked 16^2 sky) for a scene
    camera, 64x48.  render_sky inverts the view-projection on each side
    (float32 LU), so the rays differ by the inverses' rounding."""
    from lsr_tpu.scene.scene import make_camera
    from lsr_tpu.sky.sky_models import camera_ray_dirs as jrays
    from lsr_tpu.sky.sky_models import render_sky as jrender
    from lsr_tpu_torch.sky.sky_models import camera_ray_dirs as trays
    from lsr_tpu_torch.sky.sky_models import render_sky as trender

    w, h = 64, 48
    cam = make_camera(w, h, (0.8, 1.6, -4.5), (0, 0, 0.5))
    vp = np.array(cam.viewproj)
    inv = np.asarray(jnp.linalg.inv(jnp.asarray(vp)))
    np.testing.assert_allclose(
        trays(torch.as_tensor(inv.copy()), w, h).numpy(),
        np.asarray(jrays(jnp.asarray(inv), w, h)), rtol=0, atol=TOL)
    from lsr_tpu.sky.sky_models import procedural_sky_cubemap

    faces = np.asarray(procedural_sky_cubemap(16))
    for kind, cube in (("procedural", None), ("cubemap", faces)):
        want = np.asarray(jrender(jnp.asarray(vp), w, h, kind=kind,
                                  sun_dir_ws=jnp.asarray(SUN, jnp.float32),
                                  cubemap=None if cube is None
                                  else jnp.asarray(cube)))
        got = trender(torch.as_tensor(vp), w, h, kind=kind, sun_dir_ws=SUN,
                      cubemap=None if cube is None
                      else torch.as_tensor(cube)).numpy()
        assert got.shape == (h, w, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_sky_cubemap_and_bakes_match_jax():
    """The 32^2 sky cubemap, the irradiance map (8^2, 128 samples) and the
    prefiltered chain (16^2, 64 samples, 4 mips) of Config #5, each summed
    in chunks of 32 in lsr_tpu's order."""
    from lsr_tpu.resources.ibl import (
        compute_irradiance_map as jirr, compute_prefiltered_specular as jpre)
    from lsr_tpu.sky.sky_models import procedural_sky_cubemap as jcube
    from lsr_tpu_torch.resources.ibl import (
        compute_irradiance_map as tirr, compute_prefiltered_specular as tpre)
    from lsr_tpu_torch.sky.sky_models import procedural_sky_cubemap as tcube

    jc = jcube(32, sun_dir_ws=jnp.asarray(SUN, jnp.float32))
    tc = tcube(32, sun_dir_ws=SUN, device="cpu")
    err = np.abs(tc.numpy() - np.asarray(jc)).max(-1)
    from lsr_tpu_torch.resources.ibl import _face_dirs

    disk = _on_disk(_face_dirs(32), SUN)          # the sun disk (as above)
    assert err[~disk].max() <= TOL and err[disk].max() <= 5e-4
    # The bakes read the same cubemap (lsr_tpu's), so that only the bake
    # differs.
    cube = np.asarray(jc)
    np.testing.assert_allclose(
        tirr(torch.as_tensor(cube), out_size=8, samples=128).numpy(),
        np.asarray(jirr(jnp.asarray(cube), out_size=8, samples=128)),
        rtol=0, atol=TOL)
    want = jpre(jnp.asarray(cube), out_size=16, samples=64, mips=4)
    got = tpre(torch.as_tensor(cube), out_size=16, samples=64, mips=4)
    assert [g.shape for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


def test_sample_prefiltered_and_eval_ibl_match_jax():
    """The roughness-interpolated lookup and the IBL ambient term on random
    normals, view vectors and materials (roughness across [0, 1] and past
    it, so that every mip pair and the clamp are taken)."""
    from lsr_tpu.resources.ibl import eval_ibl as jeval
    from lsr_tpu.resources.ibl import sample_prefiltered as jsp
    from lsr_tpu_torch.resources.ibl import eval_ibl as teval
    from lsr_tpu_torch.resources.ibl import sample_prefiltered as tsp

    rng = np.random.default_rng(8)
    irr = _faces(4, 1)
    mips = [_faces(s, 2 + s) for s in (16, 8, 4, 4)]
    hw = (24, 32)
    n = rng.normal(size=hw + (3,)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.normal(size=hw + (3,)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    base = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    metal = rng.uniform(0, 1, hw + (1,)).astype(np.float32)
    rough = rng.uniform(-0.1, 1.1, hw + (1,)).astype(np.float32)
    ao = rng.uniform(0, 1.2, hw + (1,)).astype(np.float32)
    J, T = jnp.asarray, torch.as_tensor
    np.testing.assert_allclose(
        tsp([T(m) for m in mips], T(v), T(rough[..., 0])).numpy(),
        np.asarray(jsp([J(m) for m in mips], J(v), J(rough[..., 0]))),
        rtol=0, atol=TOL)
    args = (n, v, base, metal, rough, ao)
    want = np.asarray(jeval(J(irr), [J(m) for m in mips],
                            *(J(a) for a in args)))
    got = teval(T(irr), [T(m) for m in mips], *(T(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
