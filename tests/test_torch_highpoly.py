"""The high-poly slice of lsr_tpu_torch vs lsr_tpu (CPU): the compact
geometry front-end, the pipeline raster route, render_forward, the
sun-only shading models and the high-poly forward+ frame.

Scenes: the grid-2 flagship stand-in at 160x96 (tests/torch_scenes.py),
lsr_tpu's near-clip cube (camera inside a make_cube), and the high-poly
sphere field cut to a 3x3 grid.  lsr_tpu runs its own functions (Pallas
kernels in interpret mode); the port runs its plain versions on CPU
tensors.  Thresholds that route to the compact setup and to kernel B3 are
lowered so that these small scenes take the high-poly path.

Tolerances: setups follow test_scene_setup_matches_jax (bbox and valid
exact, 1/w and z/w within 2e-5 relative); whole frames follow
test_torch_frame.py (each package builds its own setup, XLA:CPU contracts
multiply-adds into FMAs: depth01 within 2e-3 and tids on >= 99.5% of
covered pixels, HDR within 1e-4 on >= 99.9% of agreeing pixels and within
2e-3 everywhere, LDR within 1 LSB on >= 99.9% of pixels).  Comparisons
inside the port are exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_scenes import (
    jax_camera,
    jax_flagship_scene,
    jax_highpoly_camera,
    jax_highpoly_scene,
    to_torch,
    torch_setup,
)

W, H = 160, 96
GRID = 3


@pytest.fixture(scope="module")
def flag():
    """The grid-2 flagship scene on both sides."""
    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t),
                t=to_torch(geom, objects, lights, ctx, cam, ctx_t))


def _setup_args(geom, objects, cam):
    return (geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, W, H)


def _cube_args():
    """lsr_tpu's test_compact_matches_full_near_clip scene (camera inside a
    make_cube, so faces cross the near plane) as (jax args, torch args)."""
    import jax.numpy as jnp
    from lsr_tpu.core import math3d as m3
    from lsr_tpu.io.obj import make_cube

    mesh = make_cube(2.0)
    model = np.asarray(m3.translate([0.0, 0.0, -2.2]))
    vp = np.asarray(m3.perspective_lh_no(np.pi / 3, W / H, 0.1, 100.0)
                    @ m3.look_at_lh(jnp.array([0.0, 0.0, -3.0]),
                                    jnp.array([0.0, 0.0, 0.0]),
                                    jnp.array([0.0, 1.0, 0.0])))
    cols = [mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
            np.zeros(mesh.num_vertices, np.int32),
            np.zeros(mesh.num_triangles, np.int32), model[None],
            np.asarray(m3.normal_matrix(jnp.asarray(model)))[None], vp]
    to_t = lambda a: torch.as_tensor(  # noqa: E731
        a.astype(np.int64) if a.dtype == np.int32 else a.astype(np.float32))
    return ([jnp.asarray(c) for c in cols] + [W, H],
            [to_t(np.asarray(c)) for c in cols] + [W, H])


def _args(flag, which):
    """(jax args, torch args, kwargs) of scene_setup for a scene."""
    if which == "near_clip":
        ja, ta = _cube_args()
        return ja, ta, dict(cull_mode=0)
    geom, objects, _, _, cam, _ = flag["j"]
    tg, to, _, _, tcam, _ = flag["t"]
    return (_setup_args(geom, objects, cam), _setup_args(tg, to, tcam),
            dict(obj_visible=None))


def _frame_compare(tid_j, tid_t, depth_j, depth_t):
    tid_j, tid_t = np.asarray(tid_j), tid_t.numpy()
    same = tid_j == tid_t
    covered = max(int((tid_j >= 0).sum()), 1)
    assert (~same).sum() <= 0.005 * covered, ((~same).sum(), covered)
    d = np.abs(np.asarray(depth_j) - depth_t.numpy())[same]
    assert d.max() <= 2e-3, d.max()
    return same


def _ldr_close(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max(-1)
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()


# ---------------------------------------------------------------------------
# Scene, configuration
# ---------------------------------------------------------------------------

def test_highpoly_scene_matches_jax():
    """build_highpoly_scene draws the bench's rotations from
    default_rng(7): geometry and object tables exact, model matrices within
    1e-6, the flagship lights exactly."""
    from lsr_tpu_torch.highpoly import build_highpoly_scene
    from lsr_tpu_torch.lighting.light_types import COLUMNS

    jg, jo, jl, _ = jax_highpoly_scene(GRID, n_lights=16)
    tg, to, tl, _ = build_highpoly_scene(GRID, n_lights=16, device="cpu")
    assert tg.indices.shape[0] == GRID * GRID * 1024
    for f in ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_allclose(to.model.numpy(), np.asarray(jo.model),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to.material.numpy(), np.asarray(jo.material))
    for f in COLUMNS:
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)


def test_frame_params_convert():
    """convert.frame_params carries every field the port has, enums by
    value, nested blocks included."""
    from lsr_tpu.core.frame import (
        DebugViewMode, FrameParams, LightCullingMode, TechniqueMode)

    from lsr_tpu_torch import convert

    jfp = FrameParams(width=320, height=200, enable_fxaa=True,
                      debug_view=DebugViewMode.ALBEDO, raster_tile_h=32,
                      compact_cap_fraction=0.4)
    jfp.technique.mode = TechniqueMode.CLUSTERED_FORWARD
    jfp.technique.light_culling = LightCullingMode.TILED_DEPTH_RANGE
    jfp.pass_params.tonemap.exposure = 1.5
    jfp.pass_params.shadow.sun_vis_scale = 2
    fp = convert.frame_params(jfp)
    assert (fp.width, fp.height, fp.enable_fxaa, fp.raster_tile_h,
            fp.compact_cap_fraction) == (320, 200, True, 32, 0.4)
    assert fp.debug_view.value == "albedo"
    assert int(fp.technique.mode) == int(TechniqueMode.CLUSTERED_FORWARD)
    assert fp.technique.light_culling.value == "tiled_depth_range"
    assert fp.pass_params.tonemap.exposure == 1.5
    assert fp.pass_params.shadow.sun_vis_scale == 2


def test_unported_paths_raise(flag):
    """The models render_forward could not take until ROADMAP A14 was done
    (the test keeps its name from when they raised): toon, flat,
    debug_depth and Gouraud (vertex lighting from the setup) through
    render_forward on the grid-2 scene, against lsr_tpu's render_forward op
    by op (as test_render_forward_matches_jax): tids and depth under the
    frame contract, LDR within 1 LSB on >= 99.9% of pixels."""
    import jax.numpy as jnp
    from lsr_tpu.render import render_forward as jrf

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.render import render_forward

    geom, objects, _, _, cam, ctx_t = flag["j"]
    _, to, _, _, tcam, tct = flag["t"]
    cols = ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")
    b = convert.batch({k: np.asarray(getattr(geom, k)) for k in cols}, "cpu")
    for model in ("toon", "flat", "debug_depth", "gouraud"):
        j_ldr, j_gb = jrf.__wrapped__(
            {k: jnp.asarray(getattr(geom, k)) for k in cols}, objects.model,
            objects.normal_mat, cam.viewproj, cam.zn, cam.zf, ctx_t, W, H,
            model_name=model)
        t_ldr, t_gb = render_forward(b, to.model, to.normal_mat,
                                     tcam.viewproj, tcam.zn, tcam.zf, tct, W,
                                     H, model_name=model)
        assert t_ldr.shape == (H, W, 3) and t_ldr.dtype == torch.uint8
        _frame_compare(j_gb.tri_id, t_gb.tri_id, j_gb.depth01, t_gb.depth01)
        _ldr_close(j_ldr, t_ldr.numpy())


# ---------------------------------------------------------------------------
# Compact setup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["flagship", "near_clip"])
def test_scene_setup_compact_matches_jax(flag, which):
    """Row by row against lsr_tpu's scene_setup_compact: bbox, valid and
    obj_id exact, 1/w and z/w within 2e-5 relative; CompactStats equal."""
    from lsr_tpu.raster.setup import scene_setup_compact as jssc

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.raster.setup import scene_setup_compact

    ja, ta, kw = _args(flag, which)
    js, jst = jssc(*ja, **kw)
    ts, tst = scene_setup_compact(*ta, **kw)
    for f in ("bbox", "valid", "obj_id"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    v = np.asarray(js.valid)
    assert v.any()
    for f in ("iw", "ziw"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[v],
                                   np.asarray(getattr(js, f))[v], rtol=2e-5,
                                   atol=1e-7, err_msg=f)
    cj = convert.compact_stats(jst)
    assert (int(tst.n_direct), int(tst.n_clip), bool(tst.overflow),
            tst.cap_direct, tst.cap_clip) == (
        int(cj.n_direct), int(cj.n_clip), bool(cj.overflow), cj.cap_direct,
        cj.cap_clip)
    if which == "near_clip":
        assert int(tst.n_clip) > 0


@pytest.mark.parametrize("which", ["flagship", "near_clip"])
def test_compact_prefilter_is_build_setup_validity(flag, which):
    """lsr_tpu's compact prefilter repeats build_setup's f32 validity tests
    (ROADMAP C5).  In the port both are the same torch expressions on the
    same rotated corners: on every all-inside triangle the keep set equals
    scene_setup's valid of the row the near clip emits for it."""
    from lsr_tpu_torch.raster.setup import (
        compact_prefilter, scene_setup, vertex_stage)

    _, ta, kw = _args(flag, which)
    cull = kw.get("cull_mode", 1)
    full = scene_setup(*ta, cull_mode=cull)
    _, clip_v, _ = vertex_stage(*ta[:3], ta[4], ta[6], ta[7], ta[8])
    corners = clip_v[ta[3]]
    keep, needs_clip = compact_prefilter(corners, W, H, cull)
    all_in = ((corners[..., 2] + corners[..., 3]) >= 0).all(-1)
    assert all_in.any() and keep.any()
    assert torch.equal(keep[all_in], full.valid[0::2][all_in])
    assert not bool(keep[~all_in].any())
    assert torch.equal(needs_clip, ~all_in & (
        (corners[..., 2] + corners[..., 3]) >= 0).any(-1))


def test_compact_raster_equals_full_near_clip(flag):
    """With near-plane clipping, the port's compact setup rasterizes like
    its full setup: depth bit for bit, the same coverage and the same
    object per pixel (the sphere fields: the end-to-end test below)."""
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.setup import scene_setup, scene_setup_compact

    _, ta, kw = _args(flag, "near_clip")
    full = scene_setup(*ta, **kw)
    comp, _ = scene_setup_compact(*ta, **kw)
    d_f, t_f = rasterize_brute(full, W, H, 0.1, 100.0)
    d_c, t_c = rasterize_brute(comp, W, H, 0.1, 100.0)
    assert torch.equal(d_f, d_c)
    assert torch.equal(t_f >= 0, t_c >= 0)
    obj = lambda s, t: torch.where(  # noqa: E731
        t >= 0, s.obj_id[t.clamp(min=0).long()], -1)
    assert torch.equal(obj(full, t_f), obj(comp, t_c))


# ---------------------------------------------------------------------------
# Routing repairs
# ---------------------------------------------------------------------------

def _raster_state(flag, fp):
    tg, to, tl, tc, tcam, tct = flag["t"]
    return {"geom": tg, "objects": to, "lights": tl, "shade_ctx": tct,
            "camera": tcam}


def test_compact_overflow_falls_back(flag):
    """compact_cap_fraction 0.05 overflows the compact setup on this scene;
    the pipeline raster then falls back to scene_setup and renders exactly
    the full route's image instead of dropping triangles."""
    from lsr_tpu_torch.core.frame import FrameParams
    from lsr_tpu_torch.passes.standard_passes import _raster
    from lsr_tpu_torch.raster.setup import scene_setup_compact

    tg, to, _, _, tcam, _ = flag["t"]
    _, cst = scene_setup_compact(*_setup_args(tg, to, tcam),
                                 cap_fraction=0.05)
    assert bool(cst.overflow)
    full = _raster(_raster_state(flag, None), FrameParams(width=W, height=H))
    fp = FrameParams(width=W, height=H, compact_setup_threshold=0,
                     compact_cap_fraction=0.05)
    out = _raster(_raster_state(flag, fp), fp)
    st = out["raster_stats"]
    assert st["compact_fallback"] and bool(st["compact_overflow"])
    assert torch.equal(out["depth"], full["depth"])
    assert torch.equal(out["tid"], full["tid"])
    assert "compact_fallback" not in full["raster_stats"]


@pytest.mark.parametrize("entry", ["render_forward", "pipeline_raster"])
def test_b3_route_drops_no_triangle(flag, monkeypatch, entry):
    """Routed to kernel B3 (row limit 0) with lsr_tpu's list cap of 1024,
    where this scene's largest bin holds 1,846 triangles: the port raises
    the cap to 2048 and renders what lsr_tpu's rasterize_brute and
    rasterize_tiled(cap=2048) render, not lsr_tpu's truncated cap-1024
    image."""
    from lsr_tpu.raster.brute import rasterize_brute as jrb
    from lsr_tpu.raster.setup import scene_setup as jss
    from lsr_tpu.raster.tiled import rasterize_tiled as jrt

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.core.frame import FrameParams
    from lsr_tpu_torch.passes.standard_passes import _raster
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.render import render_forward

    monkeypatch.setattr(tiled, "DIRECT_ROW_LIMIT", 0)
    geom, objects, _, _, cam, _ = flag["j"]
    tg, to, _, tc, tcam, tct = flag["t"]
    js = jss(*_setup_args(geom, objects, cam))
    if entry == "render_forward":
        b = convert.batch({k: np.asarray(getattr(geom, k)) for k in (
            "positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")},
            "cpu")
        _, gb = render_forward(b, to.model, to.normal_mat, tcam.viewproj,
                               tcam.zn, tcam.zf, tct, W, H, cap=1024)
        depth, tid, tile_h = gb.depth01, gb.tri_id, 32
    else:
        fp = FrameParams(width=W, height=H, raster_cap=1024)
        out = _raster(_raster_state(flag, fp), fp)
        depth, tid, tile_h = out["depth"], out["tid"], fp.raster_tile_h
        st = out["raster_stats"]
        assert (st["raster_cap_used"], int(st["raster_max_bin"])) == (2048,
                                                                      1846)
    bd, bt = jrb(js, W, H, cam.zn, cam.zf)
    _frame_compare(bt, tid, bd, depth)
    td, tt, _ = jrt(js, W, H, cam.zn, cam.zf, tile_h=tile_h, cap=2048)
    _frame_compare(tt, tid, td, depth)
    _, t_cut, max_bin = jrt(js, W, H, cam.zn, cam.zf, tile_h=tile_h,
                            cap=1024)
    assert int(max_bin) == 1846
    assert int((np.asarray(t_cut) != tid.numpy()).sum()) > 1000


# ---------------------------------------------------------------------------
# Whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["blinn_phong", "pbr_mr"])
def test_render_forward_matches_jax(flag, model):
    """render_forward on the same scene and camera: tids and depth under
    the frame contract, LDR within 1 LSB on >= 99.9% of pixels.

    lsr_tpu's render_forward body runs op by op (its __wrapped__ function;
    the kernels keep their own jits).  Jitted whole on XLA:CPU it turns
    near-degenerate pole slivers of the UV spheres valid (build_setup is
    fused there), and their ill-conditioned edge functions take thousands
    of pixels at depth 0 (ROADMAP C7); the port follows the op-by-op
    semantics."""
    import jax.numpy as jnp
    from lsr_tpu.render import render_forward as jrf

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.render import render_forward

    geom, objects, _, _, cam, ctx_t = flag["j"]
    tg, to, _, _, tcam, tct = flag["t"]
    cols = ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")
    j_ldr, j_gb = jrf.__wrapped__(
        {k: jnp.asarray(getattr(geom, k)) for k in cols}, objects.model,
        objects.normal_mat, cam.viewproj, cam.zn, cam.zf, ctx_t, W, H,
        model_name=model)
    b = convert.batch({k: np.asarray(getattr(geom, k)) for k in cols}, "cpu")
    t_ldr, t_gb = render_forward(b, to.model, to.normal_mat, tcam.viewproj,
                                 tcam.zn, tcam.zf, tct, W, H,
                                 model_name=model)
    assert t_ldr.shape == (H, W, 3) and t_ldr.dtype == torch.uint8
    _frame_compare(j_gb.tri_id, t_gb.tri_id, j_gb.depth01, t_gb.depth01)
    assert int((t_gb.tri_id >= 0).sum()) > 0.2 * W * H
    _ldr_close(j_ldr, t_ldr.numpy())


def test_highpoly_frame_matches_jax(monkeypatch):
    """The high-poly forward+ frame at grid 3, thresholds lowered so that it
    takes the compact setup and kernel B3, against lsr_tpu's own
    ForwardPlusPass (fused branch) + tonemap + FXAA with the same
    FrameParams.  lsr_tpu's 150K row limit is a literal, so its raster
    takes rasterize_direct(spatial_sort); both rasterizers resolve the
    first-submitted triangle, so the contract is test_torch_frame.py's."""
    from lsr_tpu.core.frame import FrameParams, LightCullingMode, TechniqueMode
    from lsr_tpu.passes.post import fxaa_pass
    from lsr_tpu.passes.standard_passes import ForwardPlusPass
    from lsr_tpu.passes.tonemap import tonemap_pass

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.highpoly import make_highpoly_frame
    from lsr_tpu_torch.passes.standard_passes import _raster, fused_lighting
    from lsr_tpu_torch.raster import tiled

    geom, objects, lights, ctx = jax_highpoly_scene(GRID, n_lights=16)
    cam, ctx_t = jax_highpoly_camera(ctx, W, H, GRID)
    jfp = FrameParams(width=W, height=H, enable_shadows=False,
                      enable_fxaa=True, compact_setup_threshold=0)
    jfp.technique.mode = TechniqueMode.FORWARD_PLUS
    jfp.technique.light_culling = LightCullingMode.TILED_DEPTH_RANGE
    jst = ForwardPlusPass().execute_resolved(None, {
        "geom": geom, "objects": objects, "lights": lights,
        "shade_ctx": ctx_t, "camera": cam}, jfp, None)
    j_ldr = np.asarray(fxaa_pass(tonemap_pass(jst["hdr"])))

    monkeypatch.setattr(tiled, "DIRECT_ROW_LIMIT", 0)
    tg, to, tl, tc, tcam, tct = to_torch(geom, objects, lights, ctx, cam,
                                         ctx_t)
    t_ldr, st = make_highpoly_frame(tg, to, tl, tc,
                                    convert.frame_params(jfp))(tcam, tct)
    rs = st["raster_stats"]
    assert not rs["compact_fallback"]
    assert rs["raster_cap_used"] >= int(rs["raster_max_bin"])
    assert int(rs["compact_n_direct"]) == int(
        jst["raster_stats"]["compact_n_direct"])
    same = _frame_compare(jst["tid"], st["tid"], jst["depth"], st["depth"])
    assert int((st["tid"] >= 0).sum()) > 0.15 * W * H
    d_hdr = np.abs(np.asarray(jst["hdr"]) - st["hdr"].numpy()).max(-1)[same]
    assert d_hdr.max() <= 2e-3, d_hdr.max()
    assert t_ldr.shape == (H, W, 3) and t_ldr.dtype == torch.uint8
    _ldr_close(j_ldr, t_ldr.numpy())

    # The same shading on lsr_tpu's own visibility buffer (the prepass-reuse
    # branch of _raster): HDR within 1e-4 on >= 99.9% of pixels.  The whole
    # frames above agree on fewer (99.8% at this zoom, where highlights
    # reach 7): their setups differ by the vertex stage's FMA ulps, which
    # the interpolated normals carry at ~1e-5.
    fp = convert.frame_params(jfp)
    reuse = fused_lighting(_raster({
        "geom": tg, "objects": to, "lights": tl, "shade_ctx": tct,
        "camera": tcam, "setup": torch_setup(jst["setup"]),
        "depth": torch.as_tensor(np.array(jst["depth"])),
        "tid": torch.as_tensor(np.array(jst["tid"]))}, fp), fp)
    assert "raster_stats" not in reuse
    d_hdr = np.abs(np.asarray(jst["hdr"]) - reuse["hdr"].numpy()).max(-1)
    assert (d_hdr <= 1e-4).mean() >= 0.999, (d_hdr <= 1e-4).mean()
    assert d_hdr.max() <= 2e-3, d_hdr.max()


def test_e2e_compact_chunklist_matches_full_setup():
    """The bench's end-to-end step (compact setup + chunk-list raster) on
    the 2x2 field: 0 coverage mismatches and the same depth as the
    chunk-list raster of the full setup."""
    from lsr_tpu_torch.highpoly import (
        build_highpoly_scene, e2e_compact_chunklist, highpoly_camera)
    from lsr_tpu_torch.raster.setup import scene_setup
    from lsr_tpu_torch.raster.tiled import rasterize_chunklist

    geom, objects, _, ctx = build_highpoly_scene(2, n_lights=16, device="cpu")
    cam, _ = highpoly_camera(ctx, W, H, 2, device="cpu")
    d_e, t_e, max_cnt, setup, cst = e2e_compact_chunklist(geom, objects, cam,
                                                          W, H)
    assert not bool(cst.overflow) and int(max_cnt) > 0
    full = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                       geom.vtx_obj, geom.tri_obj, objects.model,
                       objects.normal_mat, cam.viewproj, W, H)
    d_f, t_f, _ = rasterize_chunklist(full, W, H, cam.zn, cam.zf)
    assert torch.equal(t_e >= 0, t_f >= 0)
    assert torch.equal(d_e, d_f)
    assert setup.count == cst.cap_direct + 2 * cst.cap_clip
