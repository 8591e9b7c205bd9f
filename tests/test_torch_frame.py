"""The whole forward+ slice, lsr_tpu_torch vs lsr_tpu (CPU).

lsr_tpu_torch.frame.make_flagship_frame (plain versions on CPU tensors)
against lsr_tpu's own stages composed the same way (bench.py:242-287 with
no shadows and no scene culling; rasterize_direct and shade_fused_pallas in
Pallas interpret mode), on the same procedural scene, lights, materials,
texture and camera.  128x96, 4 spheres + ground plane, 16 lights.

Tolerances: each package builds its own triangle setup, and XLA:CPU fuses
the JAX package's multiply-adds into FMAs where torch rounds twice.  The
edge functions of these sub-pixel triangles are ill-conditioned in f32, so
depth01 may differ by up to 2e-3 and a winning triangle may flip on edge or
tie pixels (<= 0.5% allowed).  Where both pick the same triangle, HDR
agrees within 1e-4 on >= 99.9% of pixels and within 2e-3 everywhere (GGX
highlight peaks, see test_torch_shade.py); LDR after tonemap + FXAA agrees
within 1 LSB on >= 99.9% of pixels.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_scenes import (
    jax_camera,
    jax_flagship_scene,
    jax_reference_stages,
    to_torch,
)

W, H = 128, 96


@pytest.fixture(scope="module")
def jax_scene():
    return jax_flagship_scene(n_lights=16, grid=2)


@pytest.fixture(scope="module", params=[0, 9])
def rendered(request, jax_scene):
    """(JAX reference stages + LDR, port stages + frame outputs) for orbit
    frame i of the bench camera."""
    from lsr_tpu.passes.post import fxaa_pass as jfx
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    from lsr_tpu_torch.frame import flagship_stages, make_flagship_frame

    geom, objects, lights, ctx = jax_scene
    cam, ctx_t = jax_camera(request.param, ctx, W, H)
    ref = jax_reference_stages(geom, objects, lights, ctx, cam, ctx_t, W, H)
    ref["ldr"] = np.asarray(jfx(jtm(ref["hdr"])))
    tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    out = make_flagship_frame(tg, to, tl, tc, W, H)(tcam, tct)
    st = flagship_stages(tg, to, tl, tc, tcam, tct, W, H)
    return ref, st, out


def test_frame_hdr_and_ldr_match_jax(rendered):
    ref, st, out = rendered
    tid_j, tid_t = np.asarray(ref["tid"]), st["tid"].numpy()
    same = tid_j == tid_t
    covered = max(int((tid_j >= 0).sum()), 1)
    assert (~same).sum() <= 0.005 * covered, ((~same).sum(), covered)
    assert covered > 0.3 * W * H
    d_depth = np.abs(np.asarray(ref["depth"]) - st["depth"].numpy())[same]
    assert d_depth.max() <= 2e-3, d_depth.max()

    d_hdr = np.abs(np.asarray(ref["hdr"]) - st["hdr"].numpy()).max(-1)[same]
    assert (d_hdr <= 1e-4).mean() >= 0.999, (d_hdr <= 1e-4).mean()
    assert d_hdr.max() <= 2e-3, d_hdr.max()

    ldr = out[0].numpy()
    assert ldr.shape == (H, W, 3) and ldr.dtype == np.uint8
    d_ldr = np.abs(ref["ldr"].astype(int) - ldr.astype(int)).max(-1)
    assert (d_ldr <= 1).mean() >= 0.999, (d_ldr <= 1).mean()


def test_frame_stats_match_jax(rendered):
    """n_valid, max supers per tile, max lights per bin and overflowing
    bins: the same integers."""
    ref, _, out = rendered
    _, n_valid, max_sup, max_lights, overflow = out
    assert int(n_valid) == int(np.asarray(ref["setup"].valid).sum())
    assert int(max_sup) == int(ref["max_sup"])
    assert int(max_lights) == int(ref["stats"]["max_lights_per_bin"])
    assert int(overflow) == int(ref["stats"]["overflow_bins"])


def test_frame_is_deterministic(jax_scene):
    """Two calls of the frame on the same camera give identical bytes."""
    from lsr_tpu_torch.frame import make_flagship_frame

    geom, objects, lights, ctx = jax_scene
    cam, ctx_t = jax_camera(3, ctx, W, H)
    tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    frame = make_flagship_frame(tg, to, tl, tc, W, H)
    a = frame(tcam, tct)[0]
    b = frame(tcam, tct)[0]
    assert (a == b).all()
