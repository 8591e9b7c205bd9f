"""lsr_tpu_torch's per-frame scene and light culling vs lsr_tpu (CPU):
frustum planes and object masks, the 320x180 occluder depth (kernel B1's
view-z depth-only mode; its plain version on the CPU), the HiZ pyramid,
the occlusion masks and the camera light cull (bench.py:188-210).

Both packages get the grid-2 procedural scene with 16 lights
(tests/torch_scenes.py) from several angles of the bench orbit; lsr_tpu
runs op by op.  Tolerances: the frustum planes are the same f32 sums
(jnp.linalg.norm's fused multiply-adds emulated, core/math3d.norm3), so
they and every mask are equal.  The occluder depth follows the C1 raster
contract (ROADMAP C1): coverage equal on >= 99.5% of covered texels, depth
within 2e-3 where both cover; lsr_tpu's reference is its brute raster.
Given the same depth, the pyramid and the occlusion masks are equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import jax_camera, jax_flagship_scene, to_torch

W, H = 160, 96
ANGLES = [0, 9, 40, 150]


@pytest.fixture(scope="module")
def scene():
    return jax_flagship_scene(n_lights=16, grid=2)


@pytest.fixture(scope="module", params=ANGLES)
def view(request, scene):
    geom, objects, lights, ctx = scene
    cam, ctx_t = jax_camera(request.param, ctx, W, H)
    return (geom, objects, lights, ctx, cam), to_torch(geom, objects, lights,
                                                       ctx, cam, ctx_t)


def test_frustum_planes_and_object_cull_match_jax(view):
    from lsr_tpu.geometry.volumes import extract_frustum_planes as jplanes
    from lsr_tpu.geometry.volumes import frustum_cull_objects as jcull
    from lsr_tpu.scene.scene import object_world_aabbs as jaabbs

    from lsr_tpu_torch.geometry.volumes import (
        extract_frustum_planes,
        frustum_cull_objects,
    )
    from lsr_tpu_torch.scene.scene import object_world_aabbs

    (_, objects, _, _, cam), (_, to, _, _, tcam, _) = view
    np.testing.assert_array_equal(
        extract_frustum_planes(tcam.viewproj).numpy(),
        np.asarray(jplanes(cam.viewproj)))
    wmin, wmax = jaabbs(objects)
    want = np.asarray(jcull(cam.viewproj, wmin, wmax))
    got = frustum_cull_objects(tcam.viewproj, *object_world_aabbs(to))
    np.testing.assert_array_equal(got.numpy(), want)


def test_frustum_cull_of_a_stack_is_per_view():
    """A (S, 4, 4) stack of view-projections culls like S single calls
    (the shadow atlas culls every slot at once), including on boxes that
    straddle the planes."""
    from lsr_tpu_torch.core import math3d as m3
    from lsr_tpu_torch.geometry.volumes import (
        extract_frustum_planes,
        frustum_cull_objects,
        sphere_outside_planes,
    )

    rng = np.random.default_rng(3)
    vps = torch.stack([m3.matmul4(
        m3.perspective_lh_no(float(f), 1.0, 0.1, 20.0),
        m3.look_at_lh(rng.uniform(-3, 3, 3).tolist(), [0.0, 0.0, 0.0],
                      [0.0, 1.0, 0.0])) for f in (0.6, 1.1, 1.6)])
    c = torch.as_tensor(rng.uniform(-6, 6, (64, 3)).astype(np.float32))
    e = torch.as_tensor(rng.uniform(0.1, 2, (64, 3)).astype(np.float32))
    both = frustum_cull_objects(vps, c - e, c + e)
    one = torch.stack([frustum_cull_objects(v, c - e, c + e) for v in vps])
    assert torch.equal(both, one) and 0 < int(both.sum()) < both.numel()
    planes = extract_frustum_planes(vps)
    r = e[:, 0]
    assert torch.equal(sphere_outside_planes(planes, c, r),
                       torch.stack([sphere_outside_planes(p, c, r)
                                    for p in planes]))


@pytest.fixture(scope="module")
def occluders(view):
    """(lsr_tpu's occluder depth (brute), the port's), for the frustum
    visible objects."""
    from lsr_tpu.geometry.occlusion import render_occluder_depth as jocc
    from lsr_tpu.geometry.volumes import frustum_cull_objects as jcull
    from lsr_tpu.scene.scene import object_world_aabbs as jaabbs

    from lsr_tpu_torch.geometry.occlusion import render_occluder_depth

    (geom, objects, _, _, cam), (tg, to, _, _, tcam, _) = view
    vis = objects.visible & jcull(cam.viewproj, *jaabbs(objects))
    want = np.array(jocc(geom, objects, cam.viewproj, cam.zn, cam.zf, 320,
                         180, occluder_mask=vis, kernel="brute"))
    got = render_occluder_depth(tg, to, tcam.viewproj, tcam.zn, tcam.zf, 320,
                                180, occluder_mask=torch.as_tensor(
                                    np.array(vis)))
    return want, got.numpy()


def test_occluder_depth_matches_jax(occluders):
    want, got = occluders
    assert got.shape == (180, 320)
    cov_w, cov_g = want < 1.0, got < 1.0
    assert cov_w.sum() > 0.1 * want.size
    assert (cov_w != cov_g).sum() <= 0.005 * cov_w.sum()
    assert np.abs(want - got)[cov_w & cov_g].max() <= 2e-3


def test_hiz_pyramid_matches_jax(occluders):
    from lsr_tpu.geometry.occlusion import build_hiz_pyramid as jpyr

    from lsr_tpu_torch.geometry.occlusion import build_hiz_pyramid

    want, _ = occluders
    for a, b in zip(jpyr(jnp.asarray(want), 8),
                    build_hiz_pyramid(torch.as_tensor(want), 8)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_occlusion_and_light_cull_match_jax(view, occluders):
    """On lsr_tpu's occluder depth: the objects' occlusion mask and the
    lights' camera cull mask are lsr_tpu's."""
    from lsr_tpu.geometry.occlusion import occlusion_cull_aabbs as jocc_cull
    from lsr_tpu.lighting.light_culling import cull_lights_camera as jlcull
    from lsr_tpu.scene.scene import object_world_aabbs as jaabbs

    from lsr_tpu_torch.geometry.occlusion import occlusion_cull_aabbs
    from lsr_tpu_torch.lighting.light_culling import cull_lights_camera
    from lsr_tpu_torch.scene.scene import object_world_aabbs

    (_, objects, lights, _, cam), (_, to, tl, _, tcam, _) = view
    occ, _ = occluders
    wmin, wmax = jaabbs(objects)
    want = np.asarray(jocc_cull(jnp.asarray(occ), cam.viewproj, wmin, wmax,
                                cam.zn, cam.zf))
    got = occlusion_cull_aabbs(torch.as_tensor(occ), tcam.viewproj,
                               *object_world_aabbs(to), tcam.zn, tcam.zf)
    np.testing.assert_array_equal(got.numpy(), want)
    for depth in (None, occ):
        lw = np.asarray(jlcull(lights, cam.viewproj,
                               occ_depth=None if depth is None
                               else jnp.asarray(depth), zn=cam.zn, zf=cam.zf))
        lg = cull_lights_camera(tl, tcam.viewproj,
                                occ_depth=None if depth is None
                                else torch.as_tensor(depth),
                                zn=tcam.zn, zf=tcam.zf)
        np.testing.assert_array_equal(lg.numpy(), lw)


def test_light_cull_keeps_global_lights_and_drops_hidden_ones():
    """Directional and env-probe lights always pass; a point light far
    behind the camera is culled, one in front of it kept."""
    from lsr_tpu_torch.lighting.light_culling import cull_lights_camera
    from lsr_tpu_torch.lighting.light_types import LightSetBuilder
    from lsr_tpu_torch.scene.scene import make_camera

    b = LightSetBuilder()
    b.point((0.0, 0.0, 0.0), range=1.0)
    b.point((0.0, 0.0, -30.0), range=1.0)
    b._add(type=0, position=(0.0, 0.0, -30.0))     # directional
    lights = b.build("cpu")
    cam = make_camera(64, 48, (0.0, 0.0, -5.0), (0.0, 0.0, 0.0),
                      device="cpu")
    assert cull_lights_camera(lights, cam.viewproj).tolist() == [True, False,
                                                                 True]
