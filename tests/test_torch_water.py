"""Procedural noise, the hello-shaders fields and the water pass
(lsr_tpu_torch.shading.procedural, lsr_tpu_torch.passes.water) against
lsr_tpu's, on numpy-seeded inputs.

Tolerance 1e-5 absolute.  Apart from it:
- a floor() or round() that lands on the other side of a cell edge or a
  half pixel (a "flip") is counted apart, and the count is asserted small;
- f_random's fract(sin(.) * 43758.5) turns an ulp of sin into up to ~4e-3,
  so values built on it are held by the share of them within 1e-5, with
  sin itself held to 2 ulp everywhere;
- lsr_tpu jits its shader fields, and XLA:CPU then contracts multiply-adds
  into FMAs, which the warped fbm amplifies chaotically: the fields are
  held against the unjitted forms (__wrapped__), as the port's other parity
  tests hold lsr_tpu's jitted passes (ROADMAP C17).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = 1e-5
W, H = 64, 48


def _xy(seed, n=20000, lo=-30.0, hi=30.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, n).astype(np.float32),
            rng.uniform(lo, hi, n).astype(np.float32))


def _cell_flips(x, y):
    """Points whose snoise2 lattice cell floor(x + s), floor(y + s) differs
    between the two packages' arithmetic."""
    c = 0.366025403784439
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    js, ts = (jx + jy) * c, (tx + ty) * c
    return ((np.asarray(jnp.floor(jx + js)) != torch.floor(tx + ts).numpy())
            | (np.asarray(jnp.floor(jy + js)) != torch.floor(ty + ts).numpy()))


@pytest.mark.parametrize("fn", ["snoise2", "fbm"])
def test_noise_matches_jax(fn):
    from lsr_tpu.shading import procedural as jp
    from lsr_tpu_torch.shading import procedural as tp

    x, y = _xy(1)
    a = np.asarray(getattr(jp, fn)(jnp.asarray(x), jnp.asarray(y)))
    b = getattr(tp, fn)(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    bad = np.abs(a - b) > TOL
    flips = _cell_flips(x, y)
    assert int((bad & ~flips).sum()) == 0, float(np.abs(a - b).max())
    assert int(flips.sum()) <= len(x) // 1000
    assert np.abs(a).max() > 0.3


def test_f_random_matches_jax_by_share():
    from lsr_tpu.shading import procedural as jp
    from lsr_tpu_torch.shading import procedural as tp

    x, y = _xy(2)
    arg = x * np.float32(12.9898) + y * np.float32(78.233)
    sj = np.asarray(jnp.sin(jnp.asarray(arg)))
    st = torch.sin(torch.as_tensor(arg)).numpy()
    ulp = np.spacing(np.abs(sj).astype(np.float32))
    assert np.all(np.abs(sj - st) <= 2 * ulp)
    a = np.asarray(jp.f_random(jnp.asarray(x), jnp.asarray(y)))
    b = tp.f_random(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert np.all((b >= 0) & (b < 1))
    share = float((np.abs(a - b) <= TOL).mean())
    assert share >= 0.95, (share, int((np.abs(a - b) > TOL).sum()))


def test_hsb_and_uv_grid_match_jax():
    from lsr_tpu.shading import procedural as jp
    from lsr_tpu_torch.shading import procedural as tp

    for a, b in zip(jp.uv_grid(W, H), tp.uv_grid(W, H, device="cpu")):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rng = np.random.default_rng(3)
    h, s, v = (rng.uniform(-1, 2, (32, 5)).astype(np.float32)
               for _ in range(3))
    a = np.asarray(jp.hsb_to_rgb(*map(jnp.asarray, (h, s, v))))
    b = tp.hsb_to_rgb(*map(torch.as_tensor, (h, s, v))).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)


# Fields built on f_random, and the share of their values within TOL.
_HASHED = {"mongolian_flag": 0.95, "green_noise": 0.95}


@pytest.mark.parametrize("name", ["color_gradient", "color_hsb",
                                  "color_hsb_polar", "color_mix", "fbm",
                                  "green_noise", "mongolian_flag",
                                  "worm_hole"])
@pytest.mark.parametrize("t", [0.0, 2.0])
def test_shader_fields_match_jax(name, t):
    from lsr_tpu.shading.procedural import PROCEDURAL_SHADERS as J
    from lsr_tpu_torch.shading.procedural import PROCEDURAL_SHADERS as T

    a = np.asarray(J[name].__wrapped__(W, H, t))
    b = T[name](W, H, t, device="cpu").numpy()
    assert a.shape == b.shape == (H, W, 3)
    err = np.abs(a - b).max(-1)
    if name in _HASHED:
        share = float((err <= TOL).mean())
        assert share >= _HASHED[name], (share, int((err > TOL).sum()))
    else:
        assert float(err.max()) <= TOL, float(err.max())


def test_mirror_and_mirrored_camera_match_jax():
    from lsr_tpu.core import math3d as jm
    from lsr_tpu.passes import water as jw
    from lsr_tpu_torch.passes import water as tw

    np.testing.assert_array_equal(tw.mirror_matrix_y(-0.8).numpy(),
                                  np.asarray(jw.mirror_matrix_y(-0.8)))
    view = jm.look_at_lh(jnp.asarray([1.2, 1.2, -4.2]),
                         jnp.asarray([0.0, -0.1, 0.0]),
                         jnp.asarray([0.0, 1.0, 0.0]))
    a = np.asarray(jw.mirrored_camera(view, -0.8))
    b = tw.mirrored_camera(torch.as_tensor(np.array(view)), -0.8).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    # The mirror flips y about the plane: a point at the plane is fixed.
    p = torch.tensor([[0.3, -0.8, 2.0, 1.0]])
    assert torch.equal(p @ tw.mirror_matrix_y(-0.8).T, p)


@pytest.fixture(scope="module")
def water_gbuffer():
    """hello_water's scene (UV-sphere stand-in) through lsr_tpu's brute
    raster at W x H: the G-buffer, the water object's id and the eye."""
    from lsr_tpu.core import math3d as jm
    from lsr_tpu.io.obj import make_plane, make_uv_sphere
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.scene.scene import SceneBuilder, make_camera

    b = SceneBuilder()
    b.add(make_uv_sphere(rings=16, sectors=32),
          np.asarray(jm.translate([0.0, 0.35, 0.0]) @ jm.rotate_y(0.4)))
    water = b.add(make_plane(8.0, y=-0.8), material=1, casts_shadow=False)
    geom, objects = b.build()
    eye = (1.2, 1.2, -4.2)
    cam = make_camera(W, H, eye, (0, -0.1, 0))
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    return interpolate_gbuffer(setup, depth, tid), water, eye


@pytest.mark.parametrize("time", [0.0, 1.0, 7.5])
def test_shade_water_matches_jax(water_gbuffer, time):
    """shade_water on lsr_tpu's G-buffer (carried over) with a random
    reflection and base frame: within 1e-5 but at ripple flips, pixels
    whose rounded reflection texel differs between the packages
    (counted, at most 0.5% of the water)."""
    from lsr_tpu.passes.water import shade_water as jshade
    from lsr_tpu.shading.procedural import snoise2 as jn
    from lsr_tpu_torch.passes.water import shade_water
    from lsr_tpu_torch.shading.procedural import snoise2
    from torch_scenes import torch_gbuffer

    gb, water, eye = water_gbuffer
    rng = np.random.default_rng(int(time * 10) + 5)
    refl = rng.uniform(0, 3, (H, W, 3)).astype(np.float32)
    base = rng.uniform(0, 3, (H, W, 3)).astype(np.float32)
    a = np.asarray(jshade(gb, jnp.asarray(refl), water, jnp.asarray(base),
                          jnp.asarray(eye, jnp.float32), time=time))
    tgb = torch_gbuffer(gb)
    b = shade_water(tgb, torch.as_tensor(refl), water, torch.as_tensor(base),
                    torch.tensor(eye), time=time).numpy()

    def texel(noise, wp):
        wx, wz = wp[..., 0] * 3.0, wp[..., 2] * 3.0
        nx = noise(wx + np.float32(time) * 0.7, wz)
        ny = noise(wx + 13.1, wz - np.float32(time) * 0.6)
        xs = np.arange(W, dtype=np.float32)[None, :]
        ys = np.arange(H, dtype=np.float32)[:, None]
        return (np.round(xs + np.asarray(nx) * 6.0),
                np.round(ys + np.asarray(ny) * 6.0))

    wp = np.asarray(gb.world_pos)
    tj = texel(lambda x, z: jn(jnp.asarray(x), jnp.asarray(z)), wp)
    tt = texel(lambda x, z: snoise2(torch.as_tensor(x), torch.as_tensor(z))
               .numpy(), tgb.world_pos.numpy())
    is_water = np.asarray(gb.obj_id) == water
    flips = is_water & ((tj[0] != tt[0]) | (tj[1] != tt[1]))
    err = np.abs(a - b).max(-1)
    assert float(err[~flips].max()) <= TOL, float(err[~flips].max())
    assert int(flips.sum()) <= max(1, is_water.sum() // 200)
    assert is_water.sum() > 100 and (~is_water).sum() > 100
    np.testing.assert_array_equal(b[~is_water], base[~is_water])
