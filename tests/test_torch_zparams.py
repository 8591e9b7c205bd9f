"""zn / zf as device data in lsr_tpu_torch (CPU): the rasters' z params
(raster/brute.zparams, the port's z_ref of lsr_tpu/raster/tiled.py:
585-589), the plain B1 / B3 / B4 rasters on them, the frames that carry a
camera's zn / zf as 0-d f32 tensors against lsr_tpu, and one captured
program serving two near / far pairs on a recording fake card.

Tolerances: the tensor z params equal the host-float form bit for bit;
the plain rasters on them equal the host-float arithmetic they replaced
bit for bit; the frames against lsr_tpu, ROADMAP C1's contract (tids on
>= 99.5% of covered pixels and depth within 2e-3 where they agree, LDR
within 1 LSB on >= 99.9% of pixels, the frame's counts equal); the replay
at the second pair and its eager frame, bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu.scene.scene import make_camera as jmake_camera
from lsr_tpu_torch import convert
from lsr_tpu_torch.raster import brute, tiled
from lsr_tpu_torch.raster.brute import depth_params, zparams
from lsr_tpu_torch.scene.scene import f32_scalar
from torch_scenes import (
    EYE0,
    FOV,
    RecordingCard,
    jax_flagship_scene,
    jax_reference_stages,
    to_torch,
)

W, H, FS = 128, 96, 128
PAIRS = ((0.1, 100.0), (0.25, 40.0))
CUT = dict(with_cull=False, with_local=False)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_zparams_equal_depth_params():
    """Over a grid of (zn, zf), zf - zn below 1e-6 (and below 0) among
    them: the tensor form's [zn, inv_range] equals depth_params' f32
    values bit for bit, from tensors, from a tensor and a float, and from
    host floats (a memoised constant, the same tensor on every call)."""
    zns = (0.0, 1e-3, 0.1, 0.25, 1.0, 7.3, 250.0)
    for zn in zns:
        for zf in (zn, zn + 2e-7, zn + 1e-6, zn + 3e-6, zn - 1.0, 40.0,
                   100.0, 1e4):
            want = _bits(depth_params(zn, zf))
            t = zparams(f32_scalar(zn, "cpu"), f32_scalar(zf, "cpu"), "cpu")
            assert t.shape == (2,) and t.dtype == torch.float32
            assert (_bits(t.numpy()) == want).all(), (zn, zf)
            mixed = zparams(f32_scalar(zn, "cpu"), zf, "cpu")
            assert (_bits(mixed.numpy()) == want).all(), (zn, zf)
            host = zparams(zn, zf, "cpu")
            assert host is zparams(zn, zf, "cpu")
            assert (_bits(host.numpy()) == want).all(), (zn, zf)


@pytest.fixture(scope="module")
def scene():
    """The grid-2 flagship stand-in, its geometry set up at two cameras of
    the bench orbit with the two (zn, zf) pairs."""
    from lsr_tpu_torch import frame as fr
    from lsr_tpu_torch.raster.setup import scene_setup
    from lsr_tpu_torch.scene.scene import make_camera

    geom, objects, lights, ctx = fr.build_flagship_scene(16, grid=2,
                                                         device="cpu")
    out = []
    for zn, zf in PAIRS:
        cam = make_camera(W, H, EYE0, (0, 0, 0), fov=FOV, zn=zn, zf=zf,
                          device="cpu")
        out.append((cam, scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, W, H)))
    return out


def _raster(kind, setup, zn, zf):
    """One plain raster of `kind` (the wrappers on CPU tensors run their
    plain versions): (depth, tid)."""
    from lsr_tpu_torch.raster.setup import DEPTH_NDC01

    if kind == "brute_viewz":
        return brute.rasterize_brute(setup, W, H, zn, zf)
    if kind == "brute_ndc01":
        return brute.rasterize_brute(setup, W, H, zn, zf,
                                     depth_mode=DEPTH_NDC01)
    if kind == "b1_band":
        return tiled.rasterize_direct(setup, W, 32, zn, zf, y_offset=48,
                                      full_height=H)[:2]
    if kind == "b1_walk":
        rec, ss, n_pad = tiled.pack_direct_records(setup, False)
        cbb = tiled._chunk_bboxes(ss, n_pad, 16)
        sl, cnt, _ = tiled._super_lists(cbb, 16, -(-W // 128), -(-H // 128),
                                        128, 128)
        d0, t0 = tiled._targets(None, None, H, W, "cpu")
        return tiled.rasterize_direct_plain(rec, cbb, sl, cnt, d0, t0, W, H,
                                            zn, zf, block_cull=True)
    if kind == "b3":
        return tiled.rasterize_tiled(setup, W, H, zn, zf, fit_cap=True)[:2]
    return tiled.rasterize_chunklist(setup, W, H, zn, zf, tile_h=32,
                                     sub_h=8)[:2]


@pytest.mark.parametrize("kind", ["brute_viewz", "brute_ndc01", "b1_band",
                                  "b1_walk", "b3", "b4"])
def test_plain_rasters_on_tensor_zparams(monkeypatch, scene, kind):
    """The plain B1 (rasterize_brute, a B1b band, the walk model of B1's
    kernel), B3 and B4 rasters at both pairs, the camera's zn / zf tensors
    through zparams, equal the host-float arithmetic they replaced (the
    pair as Python floats, depth_params) bit for bit; the two pairs give
    different depths."""
    got = [_raster(kind, s, cam.zn, cam.zf) for cam, s in scene]
    with monkeypatch.context() as m:
        host = lambda zn, zf, dev: depth_params(float(zn),  # noqa: E731
                                                float(zf))
        m.setattr(brute, "zparams", host)
        m.setattr(tiled, "zparams", host)
        want = [_raster(kind, s, float(cam.zn), float(cam.zf))
                for cam, s in scene]
    for (d, t), (dw, tw) in zip(got, want):
        assert torch.equal(d, dw) and torch.equal(t, tw), kind
        assert (t >= 0).any()
    if kind != "brute_ndc01":
        assert not torch.equal(got[0][0], got[1][0])


def _jcam(ctx, zn, zf, i=0):
    """Frame i of the bench orbit on the JAX side with this zn / zf."""
    ang = 0.02 * i
    eye = (float(EYE0[0] * np.cos(ang) - EYE0[2] * np.sin(ang)),
           float(EYE0[1]),
           float(EYE0[0] * np.sin(ang) + EYE0[2] * np.cos(ang)))
    cam = jmake_camera(W, H, eye, (0, 0, 0), fov=FOV, zn=zn, zf=zf)
    return cam, dataclasses.replace(ctx, camera_pos=jnp.asarray(eye,
                                                                jnp.float32))


@pytest.fixture(scope="module")
def jscene():
    return jax_flagship_scene(n_lights=16, grid=2)


@pytest.mark.parametrize("pair", PAIRS)
def test_render_forward_at_pair_matches_jax(jscene, pair):
    """render_forward with the camera's zn / zf as tensors against
    lsr_tpu's render_forward op by op (__wrapped__, ROADMAP C7) with them
    as jnp.float32: tids and depth under C1, LDR within 1 LSB on >= 99.9%
    of pixels."""
    from lsr_tpu.render import render_forward as jrf

    from lsr_tpu_torch.render import render_forward

    geom, objects, lights, ctx = jscene
    cam, ctx_t = _jcam(ctx, *pair, i=3)
    _, to, _, _, tcam, tct = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    assert tcam.zn.shape == () and float(tcam.zn) == np.float32(pair[0])
    cols = ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")
    j_ldr, j_gb = jrf.__wrapped__(
        {k: jnp.asarray(getattr(geom, k)) for k in cols}, objects.model,
        objects.normal_mat, cam.viewproj, jnp.float32(pair[0]),
        jnp.float32(pair[1]), ctx_t, W, H, model_name="pbr_mr")
    b = convert.batch({k: np.asarray(getattr(geom, k)) for k in cols}, "cpu")
    t_ldr, t_gb = render_forward(b, to.model, to.normal_mat, tcam.viewproj,
                                 tcam.zn, tcam.zf, tct, W, H,
                                 model_name="pbr_mr")
    tid_j, tid_t = np.asarray(j_gb.tri_id), t_gb.tri_id.numpy()
    same = tid_j == tid_t
    assert (~same).sum() <= 0.005 * max(int((tid_j >= 0).sum()), 1)
    assert np.abs(np.asarray(j_gb.depth01)
                  - t_gb.depth01.numpy())[same].max() <= 2e-3
    assert (tid_t >= 0).sum() > 0.2 * W * H
    d = np.abs(np.asarray(j_ldr).astype(int)
               - t_ldr.numpy().astype(int)).max(-1)
    assert (d <= 1).mean() >= 0.999


@pytest.mark.parametrize("pair", PAIRS)
def test_flagship_frame_at_pair_matches_jax(jscene, pair):
    """The flagship frame (cut: no cull, no atlas; 128^2 sun map) with the
    camera's zn / zf as tensors against lsr_tpu's op-by-op frame at the
    same pair: LDR within 1 LSB on >= 99.9% of pixels, the frame's counts
    equal."""
    from lsr_tpu.passes.post import fxaa_pass as jfx
    from lsr_tpu.passes.tonemap import tonemap_pass as jtm

    from lsr_tpu_torch.frame import make_flagship_frame

    geom, objects, lights, ctx = jscene
    cam, ctx_t = _jcam(ctx, *pair, i=5)
    ref = jax_reference_stages(geom, objects, lights, ctx, cam, ctx_t, W, H,
                               shadow_size=FS)
    tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam,
                                         ctx_t)
    frame = make_flagship_frame(tg, to, tl, tc, W, H, shadow_size=FS, **CUT)
    ldr, n_valid, max_sup, max_lights, overflow = frame(tcam, tct)
    want = np.asarray(jfx(jtm(ref["hdr"])))
    d = np.abs(want.astype(int) - ldr.numpy().astype(int)).max(-1)
    assert (d <= 1).mean() >= 0.999
    assert int(n_valid) == int(np.asarray(ref["setup"].valid).sum())
    assert int(max_sup) == int(ref["max_sup"])
    assert int(max_lights) == int(ref["stats"]["max_lights_per_bin"])
    assert int(overflow) == int(ref["stats"]["overflow_bins"])


def _card(monkeypatch):
    """The recording fake card with the plain versions the frames reach on
    the CPU as its fake kernels."""
    from lsr_tpu_torch.lighting import resolve_kernel, shade_kernel

    card = RecordingCard().install(monkeypatch)
    for owner, name in ((tiled, "rasterize_brute"),
                        (tiled, "_banded_brute"),
                        (tiled, "rasterize_tiled_plain"),
                        (shade_kernel, "_shade_plain"),
                        (resolve_kernel, "_resolve_plain")):
        card.kernel(monkeypatch, owner, name)
    return card


def test_one_capture_serves_two_pairs(monkeypatch, jscene):
    """On the recording fake card: jit(make_flagship_frame(...)) (cut) at
    pair 0 warms up and captures; the camera at pair 1 has the same key,
    replays the tape without a second capture and equals its eager frame
    bit for bit; so does render_forward's checked program (sizing call,
    warm-up and capture at pair 0, replay at pair 1)."""
    from lsr_tpu_torch.frame import make_flagship_frame
    from lsr_tpu_torch.render import render_forward
    from lsr_tpu_torch.utils import jit as jm

    from lsr_tpu_torch import render
    from lsr_tpu_torch.utils.capacity import checked

    _card(monkeypatch)
    monkeypatch.setattr(render_forward, "program", checked(
        render._forward_frame, name="render_forward"))
    geom, objects, lights, ctx = jscene
    states = [to_torch(geom, objects, lights, ctx,
                       *_jcam(ctx, *p, i=2 + 2 * k))
              for k, p in enumerate(PAIRS)]
    tg, to, tl, tc = states[0][:4]
    cams = [s[4:] for s in states]
    frame = make_flagship_frame(tg, to, tl, tc, W, H, shadow_size=FS, **CUT)
    jf = jm.jit(frame)
    assert jm.trace_key(cams[0])[0] == jm.trace_key(cams[1])[0]
    outs = [jf(*c) for c in (cams[0], cams[0], cams[1])]
    want = frame(*cams[1])
    assert all(torch.equal(a, b) for a, b in zip(outs[2], want))
    assert jf.captures == 1 and len(jf.graphs) == 1
    assert not torch.equal(outs[1][0], outs[2][0])

    cols = ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")
    b = {k: getattr(tg, k) for k in cols}
    prog = render_forward.program
    calls = [(b, to.model, to.normal_mat, c.viewproj, c.zn, c.zf, ct, W, H)
             for c, ct in cams]
    captures = prog.captures
    for a in (calls[0], calls[0], calls[0], calls[1]):
        ldr, gb = render_forward(*a)
    key = prog.key(*calls[1], "blinn_phong", (0.05, 0.07, 0.12), True, 1024,
                   1.0, 2.2, tiled.DIRECT_ROW_LIMIT)
    (e_ldr, e_gb), _ = prog.fn(*calls[1], "blinn_phong", (0.05, 0.07, 0.12),
                               True, 1024, 1.0, 2.2, tiled.DIRECT_ROW_LIMIT,
                               prog.caps[key])
    assert prog.captures == captures + 1
    assert torch.equal(ldr, e_ldr) and torch.equal(gb.tri_id, e_gb.tri_id)
    assert torch.equal(gb.depth01, e_gb.depth01)
