"""lsr_tpu's compositions through lsr_tpu_torch's pipeline vs lsr_tpu (CPU):
forward_plus under the "full" post stack (Phase F's forward_plus+full) and
Config #5, the full multi-pass frame of demos/hello_full_pipeline.py (sky,
IBL, G-buffer with motion vectors, tiled deferred with the tile depth
range, the full post stack), frame 0 and a second frame with TAA's
history carried.

The reference is lsr_tpu's frame for the same pass chain composed op by op
(tests/torch_scenes.jax_chain_frame): the cull, sun map, local atlas and
camera raster as in tests/test_torch_render_paths.py, then lsr_tpu's own
RenderPass classes for every other pass.  Both sides render the same
scene state (lsr_tpu's twin, converted).  ROADMAP C1's whole-frame
contract: tids on >= 99.5% of covered pixels, HDR within 1e-4 on >= 99.9%
of agreeing pixels, LDR within 1 LSB on >= 99.9%.

Sizes: 128x96, the render-path scene with 16 lights, a 128^2 sun map,
64^2 spot slots, 32^2 cube faces, a 160x90 occluder proxy; Config #5 at
96x72 with a 128^2 sun map.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from lsr_tpu_torch.pipeline.executor import RenderContext
from torch_scenes import (
    frame_contract,
    jax_chain_frame,
    jax_full_scene,
    jax_render_path_scene,
    state_to_torch,
)

W, H = 128, 96
FW, FH = 96, 72
SUN, SLOT, FACE = 128, 64, 32
OCC = (160, 90)


def _plan_ids(pipe, fp):
    return [pipe.passes[i].pass_id for i in pipe.build_plan(fp).order]


@pytest.fixture(scope="module")
def fp_full():
    """forward_plus+full on the render-path scene: (port state of frame 0,
    lsr_tpu's reference state, the chain)."""
    from lsr_tpu_torch.render_paths import build_forward_plus_full

    js = jax_render_path_scene(W, H, 16)
    _, pipes = build_forward_plus_full(W, H, local_map=SLOT, local_point=FACE,
                                       device="cpu", with_pipes=True)
    pipe, fp, _ = pipes["forward_plus+full"]
    fp.pass_params.shadow.map_size = SUN
    fp.pass_params.culling.occ_width, fp.pass_params.culling.occ_height = OCC
    chain = _plan_ids(pipe, fp)
    st = pipe.execute_jitted(RenderContext(), state_to_torch(js), fp)
    ref = jax_chain_frame(js, fp, chain, W, H, OCC, SUN, SLOT, FACE)
    return st, ref, chain, fp


def test_forward_plus_full_matches_jax(fp_full):
    """forward_plus under the full stack (light shafts, motion blur,
    bloom, depth of field, TAA, FXAA; motion vectors on): the chain is
    Phase F's, and the frame is lsr_tpu's under C1."""
    st, ref, chain, fp = fp_full
    assert chain[-8:] == ["pbr_forward_plus", "light_shafts", "motion_blur",
                          "bloom", "depth_of_field", "taa", "tonemap",
                          "fxaa"]
    assert fp.enable_motion_vectors and fp.enable_taa and fp.enable_bloom
    frame_contract(st["tid"], ref["tid"], st["hdr"], ref["hdr"], st["ldr"],
                   ref["ldr"])
    assert st["history_color"] is not None
    assert st["ldr"].shape == (H, W, 3) and st["ldr"].dtype == torch.uint8


@pytest.fixture(scope="module")
def config5():
    """Config #5 at 96x72 with TAA on: two frames on each side, TAA's
    history carried by the pipeline (port) and by hand (reference)."""
    from lsr_tpu_torch.full_pipeline import build_full_pipeline

    js = jax_full_scene(FW, FH)
    state = state_to_torch(js)
    frame_fn, pipe, fp = build_full_pipeline(FW, FH, taa=True, state=state,
                                             device="cpu")
    fp.pass_params.shadow.map_size = SUN
    chain = _plan_ids(pipe, fp)
    # The lighting pass's HDR: the same plan with the post passes off.
    lit_fp = dataclasses.replace(
        fp, enable_light_shafts=False, enable_motion_blur=False,
        enable_bloom=False, enable_dof=False, enable_taa=False)
    lit = pipe.execute_jitted(RenderContext(), state, lit_fp)["hdr"]
    pipe.reset_history()
    ports = [frame_fn(i) for i in range(2)]
    refs, hist = [], None
    for _ in range(2):
        refs.append(jax_chain_frame(js, fp, chain, FW, FH, sun=SUN,
                                    history=hist,
                                    keep=("deferred_lighting_tiled",)))
        hist = refs[-1]["history_color"]
    return ports, refs, chain, js, lit


def test_config5_chain_and_scene(config5):
    """The pipeline's chain is the demo's, and full_scene builds lsr_tpu's
    twin: the same geometry, objects, lights and materials, IBL maps baked
    on each side within 5e-4 (the sun disk of the 32^2 sky cubemap
    amplifies rounding), the same camera within 1e-6."""
    from lsr_tpu_torch.full_pipeline import full_scene

    _, _, chain, js, _ = config5
    assert chain == ["shadow_map", "sky", "gbuffer", "light_culling",
                     "deferred_lighting_tiled", "light_shafts", "motion_blur",
                     "bloom", "depth_of_field", "taa", "tonemap", "fxaa"]
    got = full_scene(FW, FH, device="cpu")
    want = state_to_torch(js)
    for key in ("geom", "objects", "lights"):
        for f in dataclasses.fields(got[key]):
            a, b = getattr(got[key], f.name), getattr(want[key], f.name)
            if isinstance(a, torch.Tensor):
                np.testing.assert_allclose(a.double().numpy(),
                                           b.double().numpy(), rtol=0,
                                           atol=1e-6 if f.name == "normal_mat"
                                           else 0)
            else:
                assert a == b, (key, f.name)
    gi, wi = got["shade_ctx"].ibl, want["shade_ctx"].ibl
    for a, b in zip((gi[0],) + gi[1], (wi[0],) + wi[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-4)
    for f in ("view", "proj", "viewproj"):
        np.testing.assert_allclose(getattr(got["camera"], f).numpy(),
                                   getattr(want["camera"], f).numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("frame", [0, 1])
def test_config5_matches_jax(config5, frame):
    """Config #5's frame 0 and frame 1 (TAA blending frame 0's history)
    against lsr_tpu's: the lighting pass's HDR (before the post stack)
    under C1, the final frame under C1 with its HDR share at 99.5%: the
    depth of field and bloom spread each lit pixel's difference over their
    (2r + 1)^2 windows (two lit pixels over 1e-4 at 96x72 become 11 after
    the post stack).  The sky fills the uncovered pixels; the moving
    object's velocity is over 0.1 px and every other pixel's zero but for
    the float32 inverse's rounding (under 1e-4 px)."""
    ports, refs, _, _, lit = config5
    st, ref = ports[frame], refs[frame]
    frame_contract(st["tid"], ref["tid"], lit,
                   ref["hdr@deferred_lighting_tiled"], st["ldr"], ref["ldr"])
    frame_contract(st["tid"], ref["tid"], st["hdr"], ref["hdr"], st["ldr"],
                   ref["ldr"], hdr_share=0.995)
    np.testing.assert_allclose(st["velocity"].numpy(),
                               np.asarray(ref["velocity"]), rtol=0,
                               atol=1e-4)
    moving = st["gbuffer"].obj_id == 0
    speed = st["velocity"].abs().sum(-1)
    assert bool(moving.any()) and float(speed[moving].min()) > 0.1
    # Zero but for the float32 inverse of each model matrix.
    assert float(speed[~moving].max()) < 1e-4
    np.testing.assert_allclose(st["sky"].numpy(), np.asarray(ref["sky"]),
                               rtol=0, atol=1e-5)
    if frame == 1:
        assert not torch.equal(st["hdr"], ports[0]["hdr"])
