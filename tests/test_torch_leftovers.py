"""The leftovers of modules the port already held, each against lsr_tpu on
the same inputs (numpy seeds): core.math3d, core.color, core.util,
geometry (support shapes, volumes, occlusion pass), camera.light_camera,
scene.scene, lighting (shadow_sample, light_runtime, light_culling,
local_shadows) and raster.setup.scene_setup_slots.

Tolerances: masks, integer classes, record layouts and the q16 counts are
equal; float results within 1e-6 absolute (f32 products summed in another
order differ by an ulp), with lsr_tpu's own tests' anchor values where
they name one (test_math3d.py, test_harness_util.py,
test_support_shapes.py, test_shadow_culling.py, test_esm_shadows.py).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu_torch import convert

TOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# core.math3d, core.color, core.util
# ---------------------------------------------------------------------------

_M3_CASES = {
    "scale": lambda m, d: m.scale([2.0, -1.0, 0.5]),
    "scale_scalar": lambda m, d: m.scale(3.0),
    "rotate_z": lambda m, d: m.rotate_z(0.7),
    "compose_trs_4x4": lambda m, d: m.compose_trs(
        [1.0, 2.0, 3.0], m.rotate_y(np.pi / 2), [2.0, 2.0, 2.0]),
    "compose_trs_3x3": lambda m, d: m.compose_trs(
        [0.5, -1.0, 2.0], m.rotate_x(0.3)[:3, :3], [1.0, 0.5, 2.0]),
    "euler_xyz": lambda m, d: m.euler_xyz(0.3, -1.1, 2.0),
    "transform_dirs": lambda m, d: m.transform_dirs(
        m.euler_xyz(0.2, 0.4, -0.9), d(np.random.default_rng(1).normal(
            size=(16, 3)).astype(np.float32))),
    "project_to_ndc": lambda m, d: m.project_to_ndc(d(np.array(
        [[2.0, 4.0, 6.0, 2.0], [1.0, 1.0, 1.0, 0.0], [3.0, -2.0, 1.0,
                                                       -1e-14]],
        np.float32))),
    "ndc_to_screen": lambda m, d: m.ndc_to_screen(d(np.array(
        [[0.0, 0.0], [-1.0, -1.0], [1.0, 1.0], [0.3, -0.7]], np.float32)),
        640, 480),
    "reflect": lambda m, d: m.reflect(
        d(np.random.default_rng(2).normal(size=(8, 3)).astype(np.float32)),
        d(np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (8, 1)))),
}


@pytest.mark.parametrize("case", sorted(_M3_CASES))
def test_math3d_leftovers_match_jax(case):
    from lsr_tpu.core import math3d as jm
    from lsr_tpu_torch.core import math3d as tm

    a = np.asarray(_M3_CASES[case](jm, jnp.asarray))
    b = _M3_CASES[case](tm, torch.as_tensor).numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_math3d_leftovers_anchor_values():
    """lsr_tpu's tests/test_math3d.py anchors, on the port."""
    from lsr_tpu_torch.core import math3d as m3

    mdl = m3.compose_trs([1, 2, 3], m3.rotate_y(np.pi / 2), [2.0, 2.0, 2.0])
    p = m3.transform_points(mdl, torch.tensor([[1.0, 0.0, 0.0]])).numpy()
    assert np.allclose(p[0], [1, 2, 1], atol=1e-5)
    degenerate = m3.scale([1.0, 1.0, 0.0])
    assert np.allclose(m3.normal_matrix(degenerate).numpy(),
                       degenerate[:3, :3].numpy(), atol=1e-6)
    s = m3.ndc_to_screen(torch.tensor([[0.0, 0.0], [-1.0, -1.0],
                                       [1.0, 1.0]]), 640, 480).numpy()
    assert np.allclose(s, [[319.5, 239.5], [0, 0], [639, 479]])
    ndc = m3.project_to_ndc(torch.tensor([[2.0, 4.0, 6.0, 2.0]])).numpy()
    assert np.allclose(ndc[0], [1, 2, 3])


@pytest.mark.parametrize("fn", ["srgb_u8_to_linear", "srgb_to_linear",
                                "linear_to_srgb", "u8_to_f01", "luma_bt601"])
def test_color_leftovers_match_jax(fn):
    from lsr_tpu.core import color as jc
    from lsr_tpu_torch.core import color as tc

    rng = np.random.default_rng(3)
    if fn in ("srgb_u8_to_linear", "u8_to_f01"):
        x = rng.integers(0, 256, (64, 3)).astype(np.uint8)
    else:
        x = rng.uniform(-0.2, 1.5, (64, 3)).astype(np.float32)
    a = np.asarray(getattr(jc, fn)(jnp.asarray(x)))
    b = getattr(tc, fn)(torch.as_tensor(x)).numpy()
    assert b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_util_leftovers_match_jax(capsys):
    """Units, Result, FrameClock and the log helpers (lsr_tpu's
    tests/test_harness_util.py anchors), each beside lsr_tpu's."""
    from lsr_tpu.core import util as ju
    from lsr_tpu_torch.core import util as tu

    for k in ("METER", "KILOMETER", "CENTIMETER", "MILLIMETER", "SECOND",
              "MILLISECOND", "GRAVITY"):
        assert getattr(tu, k) == getattr(ju, k), k
    assert tu.meters(2.5) == ju.meters(2.5)

    ok = tu.Result.success(5)
    assert ok.ok and ok.unwrap() == 5
    bad = tu.Result.failure("nope")
    assert not bad.ok and bad.error == ju.Result.failure("nope").error
    assert tu.Result.failure("").error == ju.Result.failure("").error
    with pytest.raises(RuntimeError):
        bad.unwrap()

    for util in (ju, tu):
        t = [0.0]
        clk = util.FrameClock(now_fn=lambda: t[0])
        t[0] = 0.1
        assert abs(clk.tick() - 0.1) < 1e-9
        t[0] = 0.3
        clk.tick()
        assert clk.frame == 2 and abs(clk.fps() - 2 / 0.3) < 1e-6

    out = {}
    for name, util in (("j", ju), ("t", tu)):
        util.set_log_level("debug")
        util.log_debug("d")
        util.log_info("i")
        util.log_warn("w")
        util.log_error("e")
        util.set_log_level("warn")
        util.log_info("hidden")
        util.set_log_level("info")
        cap = capsys.readouterr()
        out[name] = (cap.out, cap.err)
    assert out["t"] == out["j"]
    with pytest.raises(ValueError):
        tu.set_log_level("loud")


# ---------------------------------------------------------------------------
# geometry: support shapes, volumes; camera: follow rig
# ---------------------------------------------------------------------------

def _cells():
    """Two convex cells (P, 4): lsr_tpu's unit cube and a random frustum."""
    from lsr_tpu.core import math3d as jm
    from lsr_tpu.geometry.volumes import extract_frustum_planes

    cube = np.array([[1, 0, 0, 1], [-1, 0, 0, 1], [0, 1, 0, 1],
                     [0, -1, 0, 1], [0, 0, 1, 1], [0, 0, -1, 1]], np.float32)
    vp = jm.perspective_lh_no(1.0, 1.3, 0.1, 20.0) @ jm.look_at_lh(
        jnp.asarray([1.0, 2.0, -6.0]), jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]))
    return {"cube": cube, "frustum": np.array(extract_frustum_planes(vp))}


def _shape_records(mod, rng):
    n = 48
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    ax = rng.normal(size=(n, 3)).astype(np.float32)
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    he = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    r = rng.uniform(0.05, 1.0, n).astype(np.float32)
    h = rng.uniform(0.2, 2.0, n).astype(np.float32)
    return [
        mod.make_aabbs(c - he, c + he),
        mod.make_cylinders(c, ax, h, r),
        mod.make_cone_frustums(c, ax, h * 0.2, h, r * 0.3, r),
    ]


@pytest.mark.parametrize("cell", ["cube", "frustum"])
def test_support_shape_records_and_classes_match_jax(cell):
    from lsr_tpu.geometry import support_shapes as js
    from lsr_tpu_torch.geometry import support_shapes as ts

    assert (ts.CULL_OUTSIDE, ts.CULL_INTERSECTING, ts.CULL_INSIDE) == (
        js.CULL_OUTSIDE, js.CULL_INTERSECTING, js.CULL_INSIDE)
    planes = _cells()[cell]
    jr = _shape_records(js, np.random.default_rng(4))
    tr = _shape_records(ts, np.random.default_rng(4))
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        ja = np.asarray(js.classify_support_shapes(a, jnp.asarray(planes)))
        ta = ts.classify_support_shapes(b, torch.as_tensor(planes)).numpy()
        assert ta.dtype == np.int32
        np.testing.assert_array_equal(ta, ja)
    rng = np.random.default_rng(5)
    verts = rng.uniform(-2.5, 2.5, (40, 1, 3)) + rng.uniform(
        -0.6, 0.6, (40, 8, 3))
    verts = verts.astype(np.float32)
    ja = np.asarray(js.classify_convex_vertices(jnp.asarray(verts),
                                                jnp.asarray(planes)))
    ta = ts.classify_convex_vertices(torch.as_tensor(verts),
                                     torch.as_tensor(planes)).numpy()
    np.testing.assert_array_equal(ta, ja)
    assert len(set(ja.tolist())) > 1


def test_support_shapes_anchor_classes():
    """lsr_tpu's tests/test_support_shapes.py unit-cube classes, on the
    port (make_cylinders' row; boxes by both classifiers)."""
    from lsr_tpu_torch.geometry import support_shapes as ts

    cell = torch.as_tensor(_cells()["cube"])
    rec = torch.cat([
        ts.make_cylinders([[0.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]], [0.3], [0.3]),
        ts.make_aabbs([[-3.0, -0.1, -0.1]], [[-2.0, 0.1, 0.1]]),
        ts.make_aabbs([[0.5, -0.1, -0.1]], [[1.5, 0.1, 0.1]]),
    ])
    assert ts.classify_support_shapes(rec, cell).tolist() == [
        ts.CULL_INSIDE, ts.CULL_OUTSIDE, ts.CULL_INTERSECTING]
    rng = np.random.default_rng(0)
    centers = rng.uniform(-2.0, 2.0, (32, 3)).astype(np.float32)
    he = rng.uniform(0.1, 0.8, (32, 3)).astype(np.float32)
    corners = np.stack([centers + he * np.asarray(s, np.float32)
                        for s in [(x, y, z) for x in (-1, 1)
                                  for y in (-1, 1) for z in (-1, 1)]], 1)
    np.testing.assert_array_equal(
        ts.classify_support_shapes(ts.make_aabbs(centers - he, centers + he),
                                   cell).numpy(),
        ts.classify_convex_vertices(torch.as_tensor(corners), cell).numpy())


def test_volumes_and_follow_camera_match_jax():
    from lsr_tpu.camera.light_camera import follow_camera_eye as jf
    from lsr_tpu.geometry import volumes as jv
    from lsr_tpu_torch.camera.light_camera import follow_camera_eye as tf
    from lsr_tpu_torch.geometry import volumes as tv

    rng = np.random.default_rng(6)
    pos = rng.normal(size=(100, 3)).astype(np.float32)
    for a, b in zip(jv.mesh_local_aabb(jnp.asarray(pos)),
                    tv.mesh_local_aabb(torch.as_tensor(pos))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jv.mesh_local_aabb(pos), tv.mesh_local_aabb(pos)):
        np.testing.assert_array_equal(b, a)
    pts = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    mins = rng.uniform(-1, 0, (64, 3)).astype(np.float32)
    maxs = mins + rng.uniform(0.1, 2, (64, 3)).astype(np.float32)
    a = np.asarray(jv.point_aabb_distance_sq(*map(jnp.asarray,
                                                   (pts, mins, maxs))))
    b = tv.point_aabb_distance_sq(*map(torch.as_tensor,
                                       (pts, mins, maxs))).numpy()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    assert (a == 0).any() and (a > 0).any()

    for kw in ({}, {"prev_eye": (1.0, 2.0, 3.0), "lag": 0.25},
               {"prev_eye": (0.0, 0.0, 0.0), "lag": 2.0}):
        a = np.asarray(jf((1.0, 0.5, -2.0), jnp.float32(0.8), distance=4.0,
                          height=1.5, **kw))
        b = tf((1.0, 0.5, -2.0), 0.8, distance=4.0, height=1.5, **kw).numpy()
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# scene: cull_scene, SunLight, update_prev; the occlusion pass
# ---------------------------------------------------------------------------

def _wall_scene():
    """lsr_tpu's tests/test_shadow_culling.py wall: a wall, a cube hidden
    behind it and one beside it, plus UV spheres around, two of them
    outside the frustum (lsr_tpu side)."""
    from lsr_tpu.core import math3d as jm
    from lsr_tpu.io.obj import make_cube, make_uv_sphere
    from lsr_tpu.scene.scene import SceneBuilder

    b = SceneBuilder()
    b.add(make_cube(1.0), np.asarray(jm.translate([0, 0, 0.0])
                                     @ jm.scale([6.0, 6.0, 0.2])))
    b.add(make_cube(0.8), np.asarray(jm.translate([0.0, 0.0, 3.0])))
    b.add(make_cube(0.8), np.asarray(jm.translate([8.0, 0.0, 3.0])))
    rng = np.random.default_rng(8)
    sphere = make_uv_sphere(rings=8, sectors=16)
    for _ in range(7):
        b.add(sphere, np.asarray(jm.translate(
            rng.uniform([-12, -3, -2], [12, 3, 12]).tolist())))
    for p in ([0.0, 0.0, -12.0], [30.0, 0.0, 0.0]):    # outside the frustum
        b.add(sphere, np.asarray(jm.translate(p)))
    return b.build()


def test_cull_scene_and_occlusion_pass_match_jax():
    """cull_scene equals lsr_tpu's; run_occlusion_pass equals lsr_tpu's
    pass op by op (its occluder raster through the brute kernel, its
    rectangle tests unjitted): the hidden cube culled, the rest kept."""
    from lsr_tpu.geometry.occlusion import (
        occlusion_cull_aabbs, render_occluder_depth)
    from lsr_tpu.scene.scene import cull_scene as jcull
    from lsr_tpu.scene.scene import make_camera, object_world_aabbs
    from lsr_tpu_torch.geometry.occlusion import run_occlusion_pass
    from lsr_tpu_torch.scene.scene import cull_scene

    geom, objects = _wall_scene()
    cam = make_camera(160, 96, (0, 0, -6.0), (0, 0, 0), fov=np.pi / 2)
    jf = jcull(objects, cam.viewproj)
    tg, to = convert.geometry(geom, "cpu"), convert.objects_soa(objects,
                                                                "cpu")
    tc = convert.camera_state(cam, "cpu")
    tf = cull_scene(to, tc.viewproj)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert not np.asarray(jf).all() and np.asarray(jf).any()

    for occluders in (None, [True] + [False] * 11):
        occ = jf if occluders is None else jnp.asarray(occluders)
        depth = render_occluder_depth(geom, objects, cam.viewproj, cam.zn,
                                      cam.zf, 160, 96, occluder_mask=occ,
                                      kernel="brute")
        wmin, wmax = object_world_aabbs(objects)
        ja = np.asarray(jf & occlusion_cull_aabbs.__wrapped__(
            depth, cam.viewproj, wmin, wmax, cam.zn, cam.zf))
        ta = run_occlusion_pass(
            tg, to, tc.viewproj, tc.zn, tc.zf, tf, width=160, height=96,
            occluder_mask=None if occluders is None
            else torch.tensor(occluders)).numpy()
        np.testing.assert_array_equal(ta, ja)
        assert ja[0] and not ja[1] and ja[2]


def test_sun_light_and_update_prev():
    from lsr_tpu.scene.scene import SunLight as JSun
    from lsr_tpu_torch.scene.scene import SunLight, make_camera, update_prev

    assert [f.name for f in dataclasses.fields(SunLight)] == [
        f.name for f in dataclasses.fields(JSun)]
    a = make_camera(64, 48, (0, 1, -4), (0, 0, 0), device="cpu")
    b = make_camera(64, 48, (1, 1, -4), (0, 0, 0), device="cpu")
    c = update_prev(b, a)
    assert torch.equal(c.prev_viewproj, a.viewproj)
    assert torch.equal(c.viewproj, b.viewproj)


# ---------------------------------------------------------------------------
# lighting: shadow_sample, light_runtime, light_culling, local_shadows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
def test_count_lit_matches_jax(packed):
    """count_lit on f32 windows and on lsr_tpu's packed q16 pairs
    (pack_taps_u16), with a lane mask: equal counts."""
    from lsr_tpu.lighting import shadow_sample as jss
    from lsr_tpu_torch.lighting.shadow_sample import count_lit

    rng = np.random.default_rng(9)
    win = rng.uniform(0, 1, (50, 26)).astype(np.float32)
    z = rng.uniform(0, 1, 50).astype(np.float32)
    z[:5] = win[:5, 3]                          # ties compare as lit
    mask = (rng.uniform(size=26) > 0.2).astype(np.float32)
    jw = jnp.asarray(win)
    tw = torch.as_tensor(win)
    if packed:
        jw = jss.pack_taps_u16(jw)
        tw = torch.as_tensor(np.asarray(jw).astype(np.int64))
    a = np.asarray(jss.count_lit(jw, jnp.asarray(z), jnp.asarray(mask)))
    b = count_lit(tw, torch.as_tensor(z), torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(b, a)
    assert a.min() < a.max()


def test_fetch_soft_matches_jax():
    """fetch_soft from lsr_tpu's packed soft map (pack_soft_u16 of an ESM
    prefiltered map), even and odd texels: equal values (the uint32 table
    read as it is, and as int64)."""
    from lsr_tpu.lighting import shadow_sample as jss
    from lsr_tpu_torch.lighting.shadow_sample import fetch_soft

    rng = np.random.default_rng(10)
    depth = rng.uniform(0.2, 1.0, (32, 32)).astype(np.float32)
    packed = jss.pack_soft_u16(jss.prefilter_esm(jnp.asarray(depth), 2))
    idx = rng.integers(0, 32 * 32, (7, 9)).astype(np.int32)
    a = np.asarray(jss.fetch_soft(packed, jnp.asarray(idx)))
    for tab in (torch.as_tensor(np.array(packed)),
                torch.as_tensor(np.asarray(packed).astype(np.int64))):
        b = fetch_soft(tab, torch.as_tensor(idx)).numpy()
        np.testing.assert_array_equal(b, a)


def _light_ring(n=12, radius=3.0, rng_range=2.0):
    """lsr_tpu's tests/test_lights.py ring of point and spot lights."""
    from lsr_tpu.lighting.light_types import LightSetBuilder

    lb = LightSetBuilder()
    for i in range(n):
        a = 2 * np.pi * i / n
        p = (radius * np.cos(a), 0.5, radius * np.sin(a))
        if i % 3 == 2:
            lb.spot(p, (0, -1, 0), range=rng_range, intensity=2.0)
        else:
            lb.point(p, color=(1.0, 0.8, 0.6), intensity=2.0,
                     range=rng_range)
    lb.env_probe((0.0, 0.0, 0.0), range=50.0)
    return lb.build()


def test_collect_object_lights_and_animate_match_jax():
    from lsr_tpu.lighting.light_runtime import (
        animate_lights as ja, collect_object_lights as jc)
    from lsr_tpu_torch.lighting.light_runtime import (
        animate_lights, collect_object_lights)

    lights = _light_ring()
    tl = convert.lights_soa(lights, "cpu")
    rng = np.random.default_rng(11)
    centers = rng.uniform(-4, 4, (10, 3)).astype(np.float32)
    centers[:, 1] = 0.5
    centers[-1] = (50.0, 0.0, 0.0)
    radii = rng.uniform(0.2, 1.5, 10).astype(np.float32)
    for cap in (2, 4, 16):
        ji, jn = jc(lights, jnp.asarray(centers), jnp.asarray(radii), cap=cap)
        ti, tn = collect_object_lights(tl, torch.as_tensor(centers),
                                       torch.as_tensor(radii), cap=cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert int(jn[-1]) == 0 and int(np.asarray(jn).max()) > 1

    for kw in ({"orbit_radius": 0.5, "pulse_amount": 0.3},
               {"orbit_radius": 1.0, "orbit_axis": (0.0, 1.0, 0.0),
                "phase": np.linspace(0, 1, lights.count)},
               {"orbit_radius": 0.7, "orbit_axis": (1.0, 0.2, 0.0),
                "orbit_speed": 2.0}):
        ph = kw.pop("phase", None)
        a = ja(lights, 1.5, phase=None if ph is None else jnp.asarray(
            ph, jnp.float32), **kw)
        b = animate_lights(tl, 1.5, phase=None if ph is None else
                           torch.as_tensor(ph, dtype=torch.float32), **kw)
        np.testing.assert_allclose(b.position.numpy(),
                                   np.asarray(a.position), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(b.intensity.numpy(),
                                   np.asarray(a.intensity), rtol=TOL,
                                   atol=TOL)


def test_view_space_spheres_and_shadow_none_match_jax():
    from lsr_tpu.core import math3d as jm
    from lsr_tpu.lighting.light_culling import view_space_spheres as jv
    from lsr_tpu.lighting.local_shadows import SHADOW_NONE as JNONE
    from lsr_tpu_torch.lighting.light_culling import view_space_spheres
    from lsr_tpu_torch.lighting.local_shadows import SHADOW_NONE

    assert SHADOW_NONE == JNONE
    view = jm.look_at_lh(jnp.asarray([2.0, 3.0, -5.0]),
                         jnp.asarray([0.0, 0.0, 0.0]),
                         jnp.asarray([0.0, 1.0, 0.0]))
    rng = np.random.default_rng(12)
    c = rng.uniform(-5, 5, (33, 3)).astype(np.float32)
    r = rng.uniform(0.1, 3, 33).astype(np.float32)
    jc, jr = jv(view, jnp.asarray(c), jnp.asarray(r))
    tc, tr = view_space_spheres(_t(view), torch.as_tensor(c),
                                torch.as_tensor(r))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# ---------------------------------------------------------------------------
# raster.setup.scene_setup_slots
# ---------------------------------------------------------------------------

def test_scene_setup_slots_matches_per_slot_setup_and_jax():
    """Every slot of scene_setup_slots equals the port's scene_setup with
    that slot's view-projection bit for bit (lsr_tpu's contract,
    raster/setup.py:297); against lsr_tpu's scene_setup_slots: bbox and
    valid equal, 1/w and z/w within 2e-5 relative (the vertex transform's
    f32 sums, as tests/test_torch_raster.py holds scene_setup)."""
    from lsr_tpu.lighting.local_shadows import plan_slot_stacks as jplan
    from lsr_tpu.raster.setup import scene_setup_slots as jslots
    from lsr_tpu_torch.raster.setup import (
        CULL_BACK, TriSetup, scene_setup, scene_setup_slots)
    from torch_scenes import jax_flagship_scene

    geom, objects, lights, _ = jax_flagship_scene(n_lights=16, grid=2)
    spot_vp = jplan(lights, (0, 1, 2), (8,))[5]
    o = np.asarray(objects.model).shape[0]
    vis = np.random.default_rng(13).uniform(size=(3, o)) > 0.3
    js = jslots(geom.positions, geom.normals, geom.uvs, geom.indices,
                geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
                spot_vp, 64, cull_mode=CULL_BACK,
                obj_visible_slots=jnp.asarray(vis))
    tg, to = convert.geometry(geom, "cpu"), convert.objects_soa(objects,
                                                                "cpu")
    vps = _t(spot_vp)
    ts = scene_setup_slots(tg.positions, tg.normals, tg.uvs, tg.indices,
                           tg.vtx_obj, tg.tri_obj, to.model, to.normal_mat,
                           vps, 64, cull_mode=CULL_BACK,
                           obj_visible_slots=torch.as_tensor(vis))
    for s in range(3):
        one = scene_setup(tg.positions, tg.normals, tg.uvs, tg.indices,
                          tg.vtx_obj, tg.tri_obj, to.model, to.normal_mat,
                          vps[s], 64, 64, cull_mode=CULL_BACK,
                          obj_visible=torch.as_tensor(vis[s]))
        for f in dataclasses.fields(TriSetup):
            assert torch.equal(getattr(ts, f.name)[s], getattr(one, f.name)), \
                (s, f.name)
    np.testing.assert_array_equal(ts.bbox.numpy(), np.asarray(js.bbox))
    v = np.asarray(js.valid)
    np.testing.assert_array_equal(ts.valid.numpy(), v)
    assert v.any() and not v.all()
    for f in ("iw", "ziw", "coef"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[v],
                                   np.asarray(getattr(js, f))[v], rtol=2e-5,
                                   atol=1e-6, err_msg=f)


def test_vertex_stage_clip_equals_jax_bit_for_bit():
    """The repair of the port's clip transform (raster/setup.py:
    clip_transform): scene_setup's clip corners follow lsr_tpu's
    summation order, so the setup of the demos' UV sphere under
    hello_normal_mapping's camera equals lsr_tpu's bit for bit, thin pole
    triangles included (a torch matmul differed by up to 44 ulps there,
    0.2% in a sliver's edge coefficients)."""
    from lsr_tpu.core import math3d as jm
    from lsr_tpu.io.obj import make_plane, make_uv_sphere
    from lsr_tpu.raster.setup import scene_setup as jsetup
    from lsr_tpu.raster.setup import vertex_stage as jvs
    from lsr_tpu.scene.scene import SceneBuilder, make_camera
    from lsr_tpu_torch.raster.setup import TriSetup, scene_setup, vertex_stage

    b = SceneBuilder()
    b.add(make_uv_sphere(rings=16, sectors=32),
          np.asarray(jm.translate([0.0, 0.25, 0.0]) @ jm.rotate_y(0.4)))
    b.add(make_plane(5.0, y=-1.0), material=1)
    geom, objects = b.build()
    cam = make_camera(96, 72, (0.8, 1.2, -3.2), (0, 0, 0))
    tg, to = convert.geometry(geom, "cpu"), convert.objects_soa(objects,
                                                                "cpu")
    vp = _t(cam.viewproj)
    _, jc, _ = jvs(geom.positions, geom.normals, geom.uvs, geom.vtx_obj,
                   objects.model, objects.normal_mat, cam.viewproj)
    _, tc, _ = vertex_stage(tg.positions, tg.normals, tg.uvs, tg.vtx_obj,
                            to.model, to.normal_mat, vp)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    js = jsetup(geom.positions, geom.normals, geom.uvs, geom.indices,
                geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
                cam.viewproj, 96, 72)
    ts = scene_setup(tg.positions, tg.normals, tg.uvs, tg.indices,
                     tg.vtx_obj, tg.tri_obj, to.model, to.normal_mat, vp, 96,
                     72)
    v = np.asarray(js.valid)
    np.testing.assert_array_equal(ts.valid.numpy(), v)
    for f in ("coef", "iw", "ziw", "bbox"):
        np.testing.assert_array_equal(getattr(ts, f).numpy()[v],
                                      np.asarray(getattr(js, f))[v],
                                      err_msg=f)
    assert {f.name for f in dataclasses.fields(TriSetup)} >= {"coef", "iw"}
