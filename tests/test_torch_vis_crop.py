"""lsr_tpu_torch's crop cascade for the local-shadow visibility planes vs
lsr_tpu (CPU): the static cascade (crop_sizes, scaled_crop_sizes,
crop_levels), the windows and run flags of kernel V1's plain version
(vis_windows_plain) against lsr_tpu's _spot_in_map / _point_in_reach,
_crop_bounds and _cropped_plane's level choice, the cropped planes against
lsr_tpu's cropped planes, and the port's cropped planes against its
uncropped ones.

The drill scene is the grid-2 procedural stand-in (tests/torch_scenes.py)
under five shadowed lights made for the four cases: a tight spot (level 0
of the cascade), a wide spot (no level holds it: the whole grid), a spot
that looks up, away from every receiver (an empty footprint), and two
points, the second culled this frame (caster_enabled False).  lsr_tpu's
atlas is rendered slot by slot op by op (torch_scenes.jax_local_atlas) and
converted; its planes and masks run op by op.  Tolerances:
- the cascades, windows and run flags are integers: equal;
- the planes with vis_crop set on both sides agree as in
  test_torch_local_shadows.py: within 1.3e-3 under ESM, within 1e-6 on >=
  99.9% of pixels under PCF;
- the port's cropped planes equal its uncropped planes bit for bit: the
  window holds the footprint, outside which a plane is 1.0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_scenes import jax_flagship_scene

W, H = 128, 96
SPOT, POINT = 64, 32
ENABLED = np.array([1, 1, 1, 1, 0], bool)
TIGHT, WIDE, EMPTY, POINT_ON, CULLED = range(5)
# The hand-written cascades of lsr_tpu's tests (tests/test_local_shadows.py:
# 222-325) and one for the drill grid, whose level 0 holds the tight spot
# at both vis scales and no level the wide spot.
HAND = ((64, 128), ((32, 128), (64, 128)), ((64, 256), (96, 256)),
        ((560, 640), (680, 960)), ())
DRILL = ((24, 64), (48, 96))
CASCADES = {"none": (), "default": None, "drill": DRILL}


@pytest.mark.parametrize("sc", [1, 2, 4])
@pytest.mark.parametrize("spec", ["1920x1080", "1280x720", "800x600"]
                         + [f"hand{i}" for i in range(len(HAND))])
def test_crop_sizes_match_jax(spec, sc):
    """crop_sizes, scaled_crop_sizes and crop_levels equal lsr_tpu's
    _crop_sizes, _scaled_crop_sizes and _cropped_plane's level filter."""
    from lsr_tpu.lighting import local_shadows as jls

    from lsr_tpu_torch.lighting import local_shadows as tls

    if spec.startswith("hand"):
        crop, h, w = HAND[int(spec[4:])], 96, 256
    else:
        w, h = (int(v) for v in spec.split("x"))
        crop = jls.default_vis_crop(h, w)
        assert tls.default_vis_crop(h, w) == crop
    assert tls.crop_sizes(crop) == jls._crop_sizes(crop)
    scaled = jls._scaled_crop_sizes(crop, sc)
    assert tls.scaled_crop_sizes(crop, sc) == scaled
    gh, gw = -(-h // sc), -(-w // sc)
    assert tls.crop_levels(scaled, gh, gw) == _jax_levels(scaled, gh, gw)


def _jax_levels(sizes, h, w):
    """_cropped_plane's level filter (lsr_tpu local_shadows.py:689-700)."""
    sizes = [(min(ch, h), min(cw, w)) for ch, cw in sizes]
    seen, lv = set(), []
    for s in sizes:
        if s in seen or (s[0] >= h and s[1] >= w):
            continue
        seen.add(s)
        lv.append(s)
    return tuple(lv)


def _jax_windows(jsh, wp):
    """[((y0c, x0c, ch, cw), run)] of each plane, as lsr_tpu's
    _cropped_plane chooses them (:674-730) from _crop_bounds of its own
    masks (_spot_in_map, _point_in_reach) on the strided grid."""
    from lsr_tpu.lighting import local_shadows as jls

    sc = max(1, int(jsh.vis_scale))
    wps = wp[::sc, ::sc]
    h, w = wps.shape[:2]
    sizes = jls._scaled_crop_sizes(jsh.vis_crop, sc)
    lv = _jax_levels(sizes, h, w)
    out = []
    for k in range(jsh.n_shadowed):
        en = (True if jsh.caster_enabled is None
              else bool(jsh.caster_enabled[k]))
        if not sizes:
            out.append(((0, 0, h, w), en))
            continue
        in_map = (jls._point_in_reach
                  if jsh.kinds[k] == jls.SHADOW_POINT_CUBE
                  else jls._spot_in_map)
        y0, y1, x0, x1, nonempty = (
            int(v) for v in jls._crop_bounds(in_map(jsh, k, wps)))
        win = (0, 0, h, w)
        for ch, cw in lv:
            if y1 - y0 + 1 <= ch and x1 - x0 + 1 <= cw:
                win = (int(np.clip(y0, 0, max(h - ch, 0))),
                       int(np.clip(x0, 0, max(w - cw, 0))), ch, cw)
                break
        out.append((win, bool(nonempty) and en))
    return out


@pytest.fixture(scope="module")
def scene():
    """The grid-2 stand-in's geometry and camera 0 of the bench orbit, the
    five drill lights, and lsr_tpu's G-buffer (brute raster)."""
    import jax.numpy as jnp

    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup
    from lsr_tpu.shading.models import _norm
    from torch_scenes import jax_camera

    geom, objects, _, ctx = jax_flagship_scene(n_lights=16, grid=2)
    lb = LightSetBuilder()
    lb.spot((0.9, 3.0, -0.3), (0.0, -1.0, 0.0), intensity=3.0, range=5.0,
            inner_angle=0.1, outer_angle=0.15)
    lb.spot((-3.5, 4.0, 1.5), (0.0, -1.0, 0.0), intensity=3.0, range=9.0,
            inner_angle=0.6, outer_angle=1.1)
    lb.spot((0.0, 3.0, 0.0), (0.0, 1.0, 0.0), intensity=3.0, range=5.0,
            inner_angle=0.4, outer_angle=0.7)
    lb.point((0.8, 0.2, -1.6), intensity=2.0, range=2.0)
    lb.point((-2.4, 1.2, -2.4), intensity=2.0, range=3.0)
    lights = lb.build()
    casters = plan_shadow_casters(lights)
    assert casters == ((0, 1, 2), (3, 4))
    cam, _ = jax_camera(0, ctx, W, H)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials,
                             want_face_normal=False)
    wp, nm = gb.world_pos, _norm(gb.normal_ws)
    return dict(geom=geom, objects=objects, lights=lights, casters=casters,
                wp=wp, nm=jnp.asarray(nm), covered=np.asarray(gb.covered))


@pytest.fixture(scope="module", params=["esm", "pcf"])
def atlas(request, scene):
    """(filter, lsr_tpu's atlas op by op, culled light CULLED)."""
    from torch_scenes import jax_local_atlas

    return request.param, jax_local_atlas(
        scene["geom"], scene["objects"], scene["lights"], *scene["casters"],
        SPOT, POINT, request.param, caster_enabled=ENABLED)


def _maps(atlas, vis_scale, cascade):
    """(lsr_tpu's maps, the port's) at vis_scale with the named cascade."""
    from lsr_tpu.lighting.local_shadows import default_vis_crop

    from lsr_tpu_torch.convert import local_shadow_maps

    crop = CASCADES[cascade]
    if crop is None:
        crop = default_vis_crop(H, W)
    ref = dataclasses.replace(atlas[1], vis_scale=vis_scale, vis_crop=crop)
    return ref, local_shadow_maps(ref, "cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("cascade", ["none", "default", "drill"])
@pytest.mark.parametrize("vis_scale", [1, 2])
def test_windows_match_jax(atlas, scene, vis_scale, cascade):
    """vis_windows_plain equals, as integers, the window and run flag of
    lsr_tpu's cascade on its own masks, for every plane; the drill lights
    land where they are meant to."""
    from lsr_tpu_torch.lighting import local_shadows as tls

    ref, sh = _maps(atlas, vis_scale, cascade)
    win, run = tls.vis_windows_plain(sh, _t(scene["wp"]))
    assert win.dtype == torch.int32 and run.dtype == torch.bool
    want = _jax_windows(ref, scene["wp"])
    assert [tuple(r) for r in win.tolist()] == [w for w, _ in want]
    assert run.tolist() == [r for _, r in want]
    gh, gw = -(-H // vis_scale), -(-W // vis_scale)
    full = (0, 0, gh, gw)
    assert run.tolist() == ([True, True, True, True, False]
                            if cascade == "none"
                            else [True, True, False, True, False])
    if cascade == "drill":
        lv = tls.vis_levels(sh, gh, gw)
        assert tuple(win[TIGHT, 2:].tolist()) == lv[0]
        assert tuple(win[WIDE].tolist()) == full
        assert tuple(win[EMPTY].tolist()) == full


@pytest.mark.parametrize("cascade", ["default", "drill"])
@pytest.mark.parametrize("vis_scale", [1, 2])
def test_cropped_planes_match_jax(atlas, scene, vis_scale, cascade):
    """The planes with vis_crop set on both sides: lsr_tpu's lax.cond
    cascade against the port's windows and planes, within the contract of
    test_torch_local_shadows.py."""
    from lsr_tpu.lighting.local_shadows import (
        local_shadow_vis_planes as jplanes)

    from lsr_tpu_torch.lighting.local_shadows import local_shadow_vis_planes

    ref, sh = _maps(atlas, vis_scale, cascade)
    want = np.asarray(jplanes(ref, scene["wp"], scene["nm"]))
    got = local_shadow_vis_planes(sh, _t(scene["wp"]),
                                  _t(scene["nm"])).numpy()
    assert got.shape == want.shape == (6, H, W)
    for k in (EMPTY, CULLED, 5):
        assert (got[k] == 1.0).all()
    assert ((want[:-1] < 0.999) & scene["covered"]).sum() > 10
    d = np.abs(got - want)
    if atlas[0] == "esm":
        assert d.max() <= 1.3e-3, d.max()
    else:
        assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 0.03, d.max()


@pytest.mark.parametrize("cascade", ["default", "drill"])
@pytest.mark.parametrize("vis_scale", [1, 2])
def test_cropped_planes_equal_uncropped(atlas, scene, vis_scale, cascade):
    """The port's planes with a crop cascade equal its planes without one
    bit for bit (the strided grid's and the upsampled ones), and the
    windowed plain version equals the whole grid's planes masked by the
    run flags."""
    from lsr_tpu_torch.lighting import local_shadows as tls

    _, sh = _maps(atlas, vis_scale, cascade)
    _, sh0 = _maps(atlas, vis_scale, "none")
    wp, nm = _t(scene["wp"]), _t(scene["nm"])
    win, run = tls.vis_windows_plain(sh, wp)
    assert bool((win[:, 2] * win[:, 3] < (-(-H // vis_scale))
                 * (-(-W // vis_scale))).any())
    cropped = tls.vis_planes_plain(sh, wp, nm, win, run)
    plain = tls.vis_planes_plain(sh0, wp, nm, *tls.vis_windows_plain(sh0, wp))
    assert torch.equal(cropped, plain)
    assert torch.equal(tls.local_shadow_vis_planes(sh, wp, nm),
                       tls.local_shadow_vis_planes(sh0, wp, nm))
    assert (cropped[EMPTY] == 1.0).all() and (cropped[CULLED] == 1.0).all()
    assert bool((cropped[TIGHT] < 1.0).any())
