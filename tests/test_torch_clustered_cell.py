"""The clustered_forward composition of the benchmark's cell
paths_1080p_768.clustered, cut to the CPU (160x96, 200 lights, at most 16
lights a cluster, the 16 log-Z slices kept, shadow maps cut to 128 / 64 /
32, the 160x90 occluder proxy), where the clusters and B2b's lists hit
their caps:

- the port (renderbench/port_side.py's program, execute_jitted, the
  kernels' plain versions) against the benchmark's plain reference
  (renderbench/reference) at the same inputs: bit for bit, frame and light
  grid, since the reference is the port's plain route frozen;
- the plain reference against lsr_tpu (JAX on the CPU) for the same scene
  and camera, lsr_tpu's stages composed op by op as
  test_torch_render_paths.py composes them (its cull with the brute
  occluder raster, sun map, atlas slot by slot, brute raster, G-buffer,
  shade_forward_plus in mode "clustered", background, tonemap, FXAA).

Each tolerance is written where it is used, with its reason.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from renderbench import port_side, ref_side, scene  # noqa: E402
from renderbench.reference.pipeline.executor import (  # noqa: E402
    RenderContext as RefContext,
)

W, H = 160, 96
N_LIGHTS = 200
CAP = 16                # lights a 16-px cluster; B2b's lists take 2 * CAP
SLICES = 16
SUN, SLOT, FACE = 128, 64, 32
OCC = (160, 90)
FRAMES = 3              # the port's frames: sizing, sizing, warm-up order


def cut_config() -> dict:
    """The cell's configuration at the CPU's size: resolution, light count
    and map sizes cut, every other key the file's."""
    with open(os.path.join(ROOT, "renderbench", "configs",
                           "paths_1080p_768.json")) as f:
        cfg = json.load(f)
    cfg["resolution"] = [W, H]
    cfg["scene"]["lights"][2]["count"] = N_LIGHTS - 10
    cfg["pipeline"].update(local_map=SLOT, local_point=FACE, sun_map=SUN)
    return cfg


def _traffic() -> dict:
    with open(os.path.join(ROOT, "renderbench", "traffic",
                           "clustered.json")) as f:
        return json.load(f)


def _shrink(fp):
    fp.technique.max_lights_per_tile = CAP
    fp.technique.cluster_slices = SLICES
    fp.pass_params.culling.occ_width, fp.pass_params.culling.occ_height = OCC
    return fp


@pytest.fixture(scope="module")
def sides():
    """(port program, reference, inputs, cfg): both sides on the CPU at the
    cut size, the cycle starting at camera 0."""
    cfg, traffic = cut_config(), _traffic()
    inputs = scene.scene_inputs(cfg)
    dev = torch.device("cpu")
    prog = port_side.Program(cfg, traffic, inputs, dev)
    _shrink(prog.fp)
    ref = ref_side.Reference(cfg, traffic, inputs, 0, dev)
    _shrink(ref.fp)
    return prog, ref, inputs, cfg


@pytest.fixture(scope="module")
def port_states(sides):
    """The port's frames 0 .. FRAMES - 1 (full states)."""
    prog = sides[0]
    return [prog.call(k) for k in range(FRAMES)]


@pytest.fixture(scope="module")
def ref_frame0(sides):
    """The reference's frame 0 (no visibility history), its full state."""
    ref = sides[1]
    ref.pipe.reset_history()
    with torch.no_grad():
        return ref.pipe.execute(RefContext(), ref._state(0), ref.fp)


def test_clusters_hit_their_caps(port_states):
    """The cut keeps the cell's load: some clusters hold more lights than
    the cap (the truncation order matters) and the grid is 16 slices deep."""
    grid = port_states[0]["light_grid"]
    assert grid["slices"] == SLICES
    assert grid["lists"].shape == (10 * 6 * SLICES, CAP)
    assert int(grid["overflow_bins"]) > 0 and int(grid["max_count"]) > CAP
    assert int((grid["counts"] == CAP).sum()) >= int(grid["overflow_bins"])


def test_port_matches_the_plain_reference(sides, port_states, ref_frame0):
    """Frame 0's light grid, HDR and LDR images bit for bit; frame 2 (the
    scene cull's history carried, the reference replaying it) its LDR image
    bit for bit, as the benchmark compares it."""
    prog, ref = sides[0], sides[1]
    got, want = port_states[0], ref_frame0
    for k in ("lists", "counts", "max_count", "overflow_bins"):
        assert torch.equal(got["light_grid"][k], want["light_grid"][k]), k
    assert torch.equal(got["hdr"].view(torch.int32),
                       want["hdr"].view(torch.int32))
    assert torch.equal(got["ldr"], want["ldr"])
    last = FRAMES - 1
    assert torch.equal(prog.compared(port_states[last])["ldr"],
                       ref.frame_outputs(last)["ldr"])


def _jax_builders():
    """renderbench.scene.build_with's builders for lsr_tpu (no device)."""
    from lsr_tpu.io.obj import MeshData
    from lsr_tpu.lighting.light_types import LightSetBuilder
    from lsr_tpu.scene.scene import SceneBuilder
    from lsr_tpu.shading.common import make_materials
    from lsr_tpu.shading.models import make_shade_context

    class Scene(SceneBuilder):
        def build(self, device=None):
            return super().build()

    class Lights(LightSetBuilder):
        def build(self, device=None):
            return super().build()

    return types.SimpleNamespace(
        MeshData=MeshData, SceneBuilder=Scene, LightSetBuilder=Lights,
        make_materials=lambda device=None, **kw: make_materials(**kw),
        make_shade_context=lambda mats, device=None, textures=None, **kw:
        make_shade_context(mats, **kw))


@pytest.fixture(scope="module")
def jax_frame0(sides):
    """lsr_tpu's frame 0 of the same scene and camera, op by op (module
    docstring): (view mask, light enable mask, tid, hdr, ldr, lists,
    counts)."""
    import jax.numpy as jnp

    from lsr_tpu.lighting.light_culling import cull_lights_clustered
    from lsr_tpu.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.passes.post import fxaa_pass
    from lsr_tpu.passes.tonemap import tonemap_pass
    from lsr_tpu.scene.scene import make_camera
    from torch_scenes import (
        jax_local_atlas,
        jax_reference_cull,
        jax_sun_shadow,
    )
    from torch_scenes import jax_gbuffer

    _, _, inputs, cfg = sides
    geom, objects, lights, ctx = scene.build_with(_jax_builders(), inputs,
                                                  None)
    c = cfg["camera"]
    eye = scene.camera_eye(cfg, _traffic(), 0)
    cam = make_camera(W, H, eye, tuple(c["target"]), fov=c["fov"],
                      zn=c["zn"], zf=c["zf"])
    objs, lights_f, _ = jax_reference_cull(geom, objects, lights, cam, *OCC)
    _, _, sc = jax_sun_shadow(geom, objects, ctx, SUN, "pcf")
    spot_ids, point_ids = plan_shadow_casters(lights)
    ids = list(spot_ids) + list(point_ids)
    local = jax_local_atlas(geom, objects, lights_f, spot_ids, point_ids,
                            SLOT, FACE, "pcf",
                            caster_enabled=np.asarray(lights_f.enabled)[ids])
    js = {"geom": geom, "objects": objects, "camera": cam,
          "shade_ctx": ctx}
    _, _, tid, gb = jax_gbuffer(js, W, H, obj_visible=objs.visible)
    bg = jnp.broadcast_to(jnp.asarray((0.04, 0.06, 0.1), jnp.float32),
                          (H, W, 3))
    hdr, _ = shade_forward_plus(
        gb, dataclasses.replace(ctx, shadow=sc), lights_f, cam.view,
        cam.proj, cam.zn, cam.zf, W, H, tile_size=16, cap=CAP,
        mode="clustered", slices=SLICES, sun_model="pbr_mr",
        use_kernel=True, local_shadows=local)
    hdr = jnp.where(gb.covered[..., None], hdr, bg)
    ldr = fxaa_pass(tonemap_pass(hdr))
    lists, counts, _ = cull_lights_clustered(
        lights_f, cam.view, cam.proj, cam.zn, cam.zf, W, H, tile_size=16,
        cap=CAP, slices=SLICES)
    return tuple(np.asarray(a) for a in (
        objs.visible, lights_f.enabled, tid, hdr, ldr, lists, counts))


def test_reference_matches_lsr_tpu(ref_frame0, jax_frame0):
    """The plain reference's frame 0 against lsr_tpu's: the scene cull's
    masks equal; the cluster grid's lists and counts equal entry for entry
    (lsr_tpu's log / pow and torch's may differ by an ulp, which would move
    a light on a slice boundary: none does on this scene, so the count of
    differing entries is held to 0); the frame under C1's contract
    (ROADMAP C1: tids equal on >= 99.5% of covered pixels, for the brute
    rasters' f32 edge ties; HDR within 1e-4 on >= 99.9% of the pixels where
    tids agree, for XLA's and torch's f32 reduction orders in the shading;
    LDR within 1 on >= 99.9% of pixels, the tonemap's rounding of those
    HDR differences)."""
    vis, en, tid, hdr, ldr, lists, counts = jax_frame0
    st = ref_frame0
    np.testing.assert_array_equal(st["view_mask"].numpy(), vis)
    np.testing.assert_array_equal(st["lights"].enabled.numpy(), en)
    grid = st["light_grid"]
    assert int((grid["lists"].numpy() != lists).sum()) == 0
    assert int((grid["counts"].numpy() != counts).sum()) == 0
    t = st["tid"].numpy()
    covered = tid >= 0
    same = t == tid
    assert (same | ~covered).mean() >= 0.995 and covered.mean() > 0.3
    err = np.abs(st["hdr"].numpy() - hdr).max(-1)
    assert (err[same] <= 1e-4).mean() >= 0.999, float(err[same].max())
    d = np.abs(st["ldr"].numpy().astype(int) - ldr.astype(int)).max(-1)
    assert (d <= 1).mean() >= 0.999
