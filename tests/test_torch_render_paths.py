"""The render-path presets through lsr_tpu_torch's pipeline vs lsr_tpu
(CPU): render_paths.scene_state against its lsr_tpu twin, each of the five
presets (forward_classic, forward_plus, deferred, tiled_deferred,
clustered_forward) rendered by the port's PluggablePipeline against lsr_tpu's
frame for the same preset, the three ways to execute a plan, and the
unported passes.

The reference, for every preset, is lsr_tpu's stages composed op by op as
its pipeline composes them (tests/torch_scenes.py: jax_reference_cull with
the brute occluder raster, jax_sun_shadow, jax_local_atlas slot by slot,
scene_setup on the view mask -> rasterize_brute -> interpolate_gbuffer ->
shade_forward_plus in the preset's mode, the frame's background, tonemap,
FXAA), not lsr_tpu's PluggablePipeline: that one renders the sun map jitted
(its texel snap moves, ROADMAP C11) and the atlas under lax.map (C15), and
runs its rasters in Pallas interpret mode.  forward_classic, forward_plus
and deferred light in mode "tiled", tiled_deferred in "tiled_depth_range",
clustered_forward in "clustered" (8 slices here).

128x96, the render-path scene with 16 lights, a 128^2 sun map (PCF), 64^2
spot slots, 32^2 cube faces, a 160x90 occluder proxy.  C1's contract for
frames: tids equal on >= 99.5% of covered pixels, HDR within 1e-4 on >=
99.9% of agreeing pixels, LDR within 1 LSB on >= 99.9%; the cull masks
equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from lsr_tpu_torch.pipeline.executor import RenderContext
from torch_scenes import (
    jax_local_atlas,
    jax_reference_cull,
    jax_render_path_scene as jax_scene_state,
    jax_sun_shadow,
    state_to_torch,
)

W, H = 128, 96
N_LIGHTS = 16
SUN, SLOT, FACE = 128, 64, 32
OCC = (160, 90)
SLICES = 8
PRESETS = ["forward_classic", "forward_plus", "deferred", "tiled_deferred",
           "clustered_forward"]
MODE = {"forward_classic": "tiled", "forward_plus": "tiled",
        "deferred": "tiled", "tiled_deferred": "tiled_depth_range",
        "clustered_forward": "clustered"}


def _shrink(fp):
    """The test's sizes on a preset's FrameParams (both packages' stages
    take the same)."""
    fp.pass_params.shadow.map_size = SUN
    fp.pass_params.culling.occ_width, fp.pass_params.culling.occ_height = OCC
    fp.technique.cluster_slices = SLICES
    return fp


@pytest.fixture(scope="module")
def jstate():
    return jax_scene_state(W, H, N_LIGHTS)


@pytest.fixture(scope="module")
def pipes(jstate):
    """{preset: (pipeline, fp, the frame state)}: the presets of
    build_preset_pipelines on the CPU, each to render lsr_tpu's twin scene
    (converted) with its camera."""
    from lsr_tpu_torch.render_paths import build_preset_pipelines

    _, pipes = build_preset_pipelines(
        W, H, set(PRESETS), local_map=SLOT, local_point=FACE, device="cpu",
        with_pipes=True)
    state = state_to_torch(jstate)
    return {k: (pipe, _shrink(fp), state)
            for k, (pipe, fp, _) in pipes.items()}


@pytest.fixture(scope="module")
def port_frames(pipes):
    """{preset: the port's frame 0 state} through execute_jitted."""
    out = {}
    for name in PRESETS:
        pipe, fp, state = pipes[name]
        pipe.reset_history()
        out[name] = pipe.execute_jitted(RenderContext(), state, fp)
    return out


@pytest.fixture(scope="module")
def reference(jstate):
    """lsr_tpu's frame per lighting mode, op by op (module docstring):
    {mode: (view mask, light enable mask, tid, hdr, ldr)}."""
    import jax.numpy as jnp

    from lsr_tpu.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu.passes.forward_plus import shade_forward_plus
    from lsr_tpu.passes.post import fxaa_pass
    from lsr_tpu.passes.tonemap import tonemap_pass
    from lsr_tpu.raster.brute import rasterize_brute
    from lsr_tpu.raster.interp import interpolate_gbuffer
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, lights = jstate["geom"], jstate["objects"], jstate["lights"]
    ctx, cam = jstate["shade_ctx"], jstate["camera"]
    objs, lights_f, _ = jax_reference_cull(geom, objects, lights, cam, *OCC)
    _, _, sc = jax_sun_shadow(geom, objects, ctx, SUN, "pcf")
    spot_ids, point_ids = plan_shadow_casters(lights)
    ids = list(spot_ids) + list(point_ids)
    local = jax_local_atlas(geom, objects, lights_f, spot_ids, point_ids,
                            SLOT, FACE, "pcf",
                            caster_enabled=np.asarray(lights_f.enabled)[ids])
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, W, H,
                        obj_visible=objs.visible)
    depth, tid = rasterize_brute(setup, W, H, cam.zn, cam.zf)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials)
    ctx_sh = dataclasses.replace(ctx, shadow=sc)
    bg = jnp.broadcast_to(jnp.asarray((0.04, 0.06, 0.1), jnp.float32),
                          (H, W, 3))
    out = {}
    for mode in ("tiled", "tiled_depth_range", "clustered"):
        hdr, _ = shade_forward_plus(
            gb, ctx_sh, lights_f, cam.view, cam.proj, cam.zn, cam.zf, W, H,
            tile_size=16, cap=128, mode=mode, slices=SLICES,
            sun_model="pbr_mr", use_kernel=True, local_shadows=local)
        hdr = jnp.where(gb.covered[..., None], hdr, bg)
        ldr = fxaa_pass(tonemap_pass(hdr))
        out[mode] = tuple(np.asarray(a) for a in (
            objs.visible, lights_f.enabled, tid, hdr, ldr))
    return out


def test_scene_state_matches_jax(jstate):
    """render_paths.scene_state on the CPU is lsr_tpu's twin converted:
    geometry, objects, lights, materials and shade context equal, the
    normal matrices (inverse-transpose on each side) and the camera
    matrices within 1e-6 (orbit_camera's frame 0 is the scene's
    camera)."""
    from lsr_tpu_torch.render_paths import orbit_camera, scene_state

    got = scene_state(W, H, N_LIGHTS, device="cpu")
    want = state_to_torch(jstate)
    for key in ("geom", "objects", "lights"):
        for f in dataclasses.fields(got[key]):
            a, b = getattr(got[key], f.name), getattr(want[key], f.name)
            if f.name == "normal_mat":
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                           atol=1e-6)
            elif isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (key, f.name)
            else:
                assert a == b, (key, f.name)
    for f in ("light_dir_ws", "light_color", "light_intensity", "camera_pos"):
        assert torch.equal(getattr(got["shade_ctx"], f),
                           getattr(want["shade_ctx"], f)), f
    for f in dataclasses.fields(got["shade_ctx"].materials):
        assert torch.equal(getattr(got["shade_ctx"].materials, f.name),
                           getattr(want["shade_ctx"].materials, f.name))
    for cam in (got["camera"], orbit_camera(W, H, 0, "cpu")):
        for f in ("view", "proj", "viewproj"):
            np.testing.assert_allclose(getattr(cam, f).numpy(),
                                       getattr(want["camera"], f).numpy(),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(name, port_frames, reference):
    """Each preset's frame 0 through the port's pipeline against lsr_tpu's
    frame for its lighting mode, under C1's contract; the scene cull's
    masks equal."""
    st = port_frames[name]
    vis, en, tid, hdr, ldr = reference[MODE[name]]
    np.testing.assert_array_equal(st["view_mask"].numpy(), vis)
    np.testing.assert_array_equal(st["lights"].enabled.numpy(), en)
    t = st["tid"].numpy()
    covered = tid >= 0
    same = t == tid
    assert (same | ~covered).mean() >= 0.995 and covered.mean() > 0.3
    err = np.abs(st["hdr"].numpy() - hdr).max(-1)
    assert (err[same] <= 1e-4).mean() >= 0.999, float(err[same].max())
    d = np.abs(st["ldr"].numpy().astype(int) - ldr.astype(int)).max(-1)
    assert (d <= 1).mean() >= 0.999
    assert st["ldr"].dtype == torch.uint8 and st["ldr"].shape == (H, W, 3)


def test_execute_modes_bit_equal(pipes, port_frames):
    """execute, execute_jitted and execute_segmented of the clustered_forward
    pipeline give the same frame bit for bit; segmented times every pass
    of its plan."""
    pipe, fp, state = pipes["clustered_forward"]
    want = port_frames["clustered_forward"]
    for how in ("execute", "execute_segmented"):
        pipe.reset_history()
        ctx = RenderContext()
        st = getattr(pipe, how)(ctx, state, fp)
        assert torch.equal(st["ldr"], want["ldr"]), how
        assert torch.equal(st["hdr"].view(torch.int32),
                           want["hdr"].view(torch.int32)), how
        assert set(ctx.debug.pass_ms) == {p.pass_id for p in pipe.passes}


def test_presets_share_the_scene(port_frames):
    """The five presets render the same scene: the same cull and raster,
    and LDR frames within 1 LSB of each other (each lights through kernel
    B2's plain version in its own mode)."""
    base = port_frames["forward_plus"]
    for name, st in port_frames.items():
        assert torch.equal(st["tid"], base["tid"]), name
        d = (st["ldr"].int() - base["ldr"].int()).abs().max()
        assert int(d) <= 1, name


@pytest.mark.parametrize("preset,post,item", [
    ("forward_classic+ssao", ("fxaa",), "A14"),
    ("forward_plus", ("bloom",), "A14")])
def test_unported_passes_raise_in_a_frame(preset, post, item, jstate,
                                          port_frames):
    """A frame whose chain holds a pass the port lacked until ROADMAP
    `item` was done (the case ids keep their names from when it raised):
    the SSAO composition, lit by the general branch (the SSAO mask sends it
    there), and forward_plus with bloom render lsr_tpu's frame for the same
    chain (tests/torch_scenes.jax_chain_frame) under C1; the SSAO
    composition's LDR differs from forward_classic's (run_phases.py:292-300)
    and its SSAO darkens covered pixels."""
    from lsr_tpu_torch.render_paths import build_preset_pipelines
    from torch_scenes import frame_contract, jax_chain_frame

    _, pipes = build_preset_pipelines(
        W, H, {preset}, post=post, local_map=SLOT, local_point=FACE,
        device="cpu", with_pipes=True)
    pipe, fp, _ = pipes[preset]
    _shrink(fp)
    chain = [pipe.passes[i].pass_id for i in pipe.build_plan(fp).order]
    assert ("ssao" in chain) == (preset == "forward_classic+ssao")
    assert ("bloom" in chain) == ("bloom" in post)
    st = pipe.execute_jitted(RenderContext(), state_to_torch(jstate), fp)
    ref = jax_chain_frame(jstate, fp, chain, W, H, OCC, SUN, SLOT, FACE)
    frame_contract(st["tid"], ref["tid"], st["hdr"], ref["hdr"], st["ldr"],
                   ref["ldr"])
    if preset == "forward_classic+ssao":
        ao = st["ssao_mask"]
        np.testing.assert_allclose(ao.numpy(), np.asarray(ref["ssao_mask"]),
                                   rtol=0, atol=1e-6)
        assert float(ao[st["tid"] >= 0].min()) < 0.9
        assert not torch.equal(st["ldr"], port_frames["forward_classic"]["ldr"])
