"""The port's demos (lsr_tpu_torch.demos) against lsr_tpu's own demo
scripts (demos/hello_*.py) on the same scene, at W x H with the UV-sphere
stand-in for the monkey (ROADMAP C2), on the CPU.

lsr_tpu's demo module is loaded from demos/ by path, its frame size line
set to W x H, its load_obj made to return the stand-in, and its rasters
sent through rasterize_brute (use_tiled=False where the demo has it, else
its rasterize_direct / rasterize_tiled / render_forward name patched), so
no Pallas kernel runs in interpret mode; its forward+ lighting runs
lsr_tpu's XLA branch (use_kernel=False), the port's its fused branch, whose
plain version stands for kernel B2.  The demos' PNG edge is patched to hand
the frame back.  The scene state lsr_tpu's demo builds, its camera too, is
carried into the port (lsr_tpu_torch.convert) and rendered by the port's
render(): XLA:CPU's float32 tan(pi / 6) is one ulp above the correctly
rounded value torch returns, so the two packages' default 60-degree
projections differ by an ulp, which a thin triangle's edge setup and a
normal-mapped specular lobe amplify past the contract (ROADMAP C19).  The
port's own build_scene is held to lsr_tpu's state separately.  Map sizes are cut (sun map 128^2, atlas 32^2, cubemap
16^2 faces), on both sides alike.

Each frame is held to ROADMAP C1's whole-frame contract
(torch_scenes.frame_contract: tids equal on >= 99.5% of covered pixels,
HDR within 1e-4 on >= 99.9% of agreeing pixels, LDR within 1 LSB on >=
99.9%); the shader sheet, which has no tids or HDR, by its LDR alone
(within 1 LSB on >= 99.9%).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import frame_contract

W, H = 96, 72
SUN_MAP = 128
ATLAS = 32
SKY = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_mesh():
    from lsr_tpu.io.obj import make_uv_sphere

    return make_uv_sphere(rings=16, sectors=32)


def _torch_mesh():
    from lsr_tpu_torch.demos.common import stand_in_mesh

    return stand_in_mesh()


class _Recorder:
    """Wraps fn; .calls holds (args, kwargs, result) of every call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.calls.append((a, k, out))
        return out


def _brute_direct(setup, w, h, zn, zf, **kw):
    """lsr_tpu's rasterize_direct through rasterize_brute (its XLA
    anchor), returning rasterize_direct's triple."""
    from lsr_tpu.raster.brute import rasterize_brute

    mode = {k: v for k, v in kw.items() if k == "depth_mode"}
    depth, tid = rasterize_brute(setup, w, h, zn, zf, **mode)
    return depth, tid, jnp.int32(0)


def jax_demo(name, monkeypatch, size=(W, H)):
    """lsr_tpu's demos/<name>.py as a fresh module, its `w, h = ...` line
    set to size, load_obj returning the stand-in, the PNG edge captured
    (.saved), rasterize_direct / rasterize_tiled / rasterize_brute and
    tonemap_pass recorded, the forward+ lighting on its XLA branch."""
    path = os.path.join(REPO, "demos", f"{name}.py")
    src = re.sub(r"w, h = \d+, \d+", f"w, h = {size[0]}, {size[1]}",
                 open(path).read(), count=1)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       os.environ.get("JAX_COMPILATION_CACHE_DIR", ""))
    mod = types.ModuleType(f"jax_demo_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    mod.load_obj = lambda _path: _jax_mesh()
    mod.saved = []
    mod.save_canvas_png = lambda _p, img: mod.saved.append(np.asarray(img))
    mod.fetch_image = np.asarray
    mod.os = types.SimpleNamespace(path=os.path, environ=os.environ,
                                   makedirs=lambda *a, **k: None)
    for fn in ("rasterize_direct", "rasterize_tiled"):
        if hasattr(mod, fn):
            setattr(mod, fn, _Recorder(_brute_direct))
    if hasattr(mod, "rasterize_brute"):
        mod.rasterize_brute = _Recorder(mod.rasterize_brute)
    if hasattr(mod, "tonemap_pass"):
        mod.tonemap_pass = _Recorder(mod.tonemap_pass)
    if hasattr(mod, "shade_forward_plus"):
        mod.shade_forward_plus = functools.partial(mod.shade_forward_plus,
                                                   use_kernel=False)
    mod.built = {}
    for cls in ("SceneBuilder", "LightSetBuilder"):
        if hasattr(mod, cls):
            setattr(mod, cls, _recording_builder(getattr(mod, cls),
                                                 mod.built, cls))
    for fn in ("make_shade_context", "make_materials"):
        if hasattr(mod, fn):
            setattr(mod, fn, _Recorder(getattr(mod, fn)))
    return mod


def _recording_builder(base, built, key):
    """A subclass of builder class base whose build() result is kept in
    built[key]."""
    class Recording(base):
        def build(self, *a, **k):
            built[key] = super().build(*a, **k)
            return built[key]

    return Recording


def port_state(mod, ctx=None):
    """The scene state lsr_tpu's demo built (recorded by jax_demo), carried
    into the port on the CPU (lsr_tpu_torch.convert): geom, objects,
    lights, materials and the last shading context."""
    from lsr_tpu_torch import convert

    out = {"device": torch.device("cpu")}
    if "SceneBuilder" in mod.built:
        geom, objects = mod.built["SceneBuilder"]
        out["geom"] = convert.geometry(geom, "cpu")
        out["objects"] = convert.objects_soa(objects, "cpu")
    if "LightSetBuilder" in mod.built:
        out["lights"] = convert.lights_soa(mod.built["LightSetBuilder"],
                                           "cpu")
    ctx = ctx if ctx is not None else (
        mod.make_shade_context.calls[-1][2]
        if getattr(mod.make_shade_context, "calls", None) else None)
    if ctx is not None:
        mats = convert.materials_soa(ctx.materials, "cpu")
        out["materials"] = mats
        out["ctx"] = convert.shade_context(ctx, mats, "cpu")
    return out


def jax_cameras(monkeypatch, demo):
    """The port demo's make_camera / simple_camera replaced by lsr_tpu's,
    carried into the port: the frame renders lsr_tpu's camera state."""
    from lsr_tpu.render import simple_camera as jsimple
    from lsr_tpu.scene.scene import make_camera as jmake
    from lsr_tpu_torch import convert

    def make_camera(*a, device=None, **k):
        return convert.camera_state(jmake(*a, **k), "cpu")

    def simple_camera(*a, device=None, **k):
        vp, zn, zf = jsimple(*a, **k)
        return _t(vp), float(zn), float(zf)

    for name, fn in (("make_camera", make_camera),
                     ("simple_camera", simple_camera)):
        if hasattr(demo, name):
            monkeypatch.setattr(demo, name, fn)


def same_state(own, carried):
    """The port's build_scene equals the state lsr_tpu's demo built:
    geometry, lights, materials, textures and flags exactly, matrices
    within 1e-6 (a rotation's cos / sin may round an ulp apart)."""
    def eq(a, b, name, tol=0.0):
        if a is None or b is None:
            assert a is None and b is None, name
            return
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                eq(getattr(a, f.name), getattr(b, f.name), f"{name}.{f.name}",
                   tol)
            return
        if isinstance(a, (tuple, list)):
            for k, (x, y) in enumerate(zip(a, b)):
                eq(x, y, f"{name}[{k}]", tol)
            return
        if isinstance(a, dict):
            for k in a:
                eq(a[k], b[k], f"{name}.{k}", tol)
            return
        if isinstance(a, torch.Tensor):
            a, b = a.numpy(), b.numpy()
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
        else:
            assert a == b, name

    for k in ("batch", "geom", "lights", "materials"):
        if k in carried and k in own:
            eq(own[k], carried[k], k)
    for k in ("models", "nmats", "objects"):
        if k in carried and k in own:
            eq(own[k], carried[k], k, 1e-6)
    c_own, c_jax = own["ctx"], carried["ctx"]
    for f in ("light_dir_ws", "light_color", "light_intensity", "camera_pos",
              "materials", "textures", "texture_quads", "surface_maps"):
        eq(getattr(c_own, f), getattr(c_jax, f), f"ctx.{f}")


def _contract(out, j_tid, j_hdr, j_ldr):
    return frame_contract(out["gb"].tri_id.numpy(), np.asarray(j_tid),
                          out["hdr"].numpy(), np.asarray(j_hdr),
                          out["ldr"].numpy(), np.asarray(j_ldr))


def _covered_share(out):
    c = out["gb"].covered.numpy()
    return float(c.mean())


# ---------------------------------------------------------------------------
# render_forward demos
# ---------------------------------------------------------------------------

def _render_forward_recorders(monkeypatch, mod):
    """lsr_tpu's render_forward op by op (its jit rasterizes pole slivers,
    ROADMAP C7) on rasterize_brute, and both packages' render_forward HDR
    (the input of their tonemap) recorded."""
    import lsr_tpu.render as jr
    import lsr_tpu_torch.render as tr

    jrec, trec = _Recorder(jr.tonemap_pass), _Recorder(tr.tonemap_pass)
    monkeypatch.setattr(jr, "tonemap_pass", jrec)
    monkeypatch.setattr(tr, "tonemap_pass", trec)
    mod.render_forward = _Recorder(functools.partial(
        jr.render_forward.__wrapped__, use_tiled=False))
    return jrec, trec


def _forward_scene(mod):
    """render_forward's scene (batch, models, normal matrices, context) as
    lsr_tpu's demo passed it, carried into the port."""
    from lsr_tpu_torch import convert

    a = mod.render_forward.calls[0][0]
    ctx = a[6]
    return {"batch": convert.batch(a[0], "cpu"), "models": _t(a[1]),
            "nmats": _t(a[2]), "device": torch.device("cpu"),
            "ctx": convert.shade_context(
                ctx, convert.materials_soa(ctx.materials, "cpu"), "cpu")}


def _t(a):
    return torch.as_tensor(np.array(a))


def test_hello_blinn_phong_matches_jax(monkeypatch):
    from lsr_tpu_torch.demos import hello_blinn_phong as demo

    mod = jax_demo("hello_blinn_phong", monkeypatch)
    jax_cameras(monkeypatch, demo)
    jrec, trec = _render_forward_recorders(monkeypatch, mod)
    mod.main()
    (_, _, (j_ldr, j_gb)), = mod.render_forward.calls
    carried = _forward_scene(mod)
    same_state(demo.build_scene(_torch_mesh(), "cpu"), carried)
    out = demo.render(carried, W, H)
    out["hdr"] = trec.calls[-1][0][0]
    _contract(out, j_gb.tri_id, jrec.calls[-1][0][0], j_ldr)
    np.testing.assert_array_equal(mod.saved[0], np.asarray(j_ldr))
    assert 0.2 < _covered_share(out) < 0.95


def test_hello_shading_models_matches_jax(monkeypatch):
    """Every panel: the frame contract on its tids, HDR and LDR; the
    sheet's layout equal."""
    from lsr_tpu_torch.demos import hello_shading_models as demo

    mod = jax_demo("hello_shading_models", monkeypatch)
    jax_cameras(monkeypatch, demo)
    jrec, trec = _render_forward_recorders(monkeypatch, mod)
    mod.main()
    carried = _forward_scene(mod)
    same_state(demo.build_scene(_torch_mesh(), "cpu"), carried)
    out = demo.render(carried, W, H)
    calls = mod.render_forward.calls
    assert len(calls) == len(demo.MODELS) == len(out["panels"]) == 9
    for k, (_, _, (j_ldr, j_gb)) in enumerate(calls):
        panel = {"gb": out["gb"], "hdr": trec.calls[k][0][0],
                 "ldr": out["panels"][k]}
        _contract(panel, j_gb.tri_id, jrec.calls[k][0][0], j_ldr)
    sheet = out["ldr"].numpy()
    assert sheet.shape == mod.saved[0].shape == (3 * H, 3 * W, 3)
    d = np.abs(sheet.astype(int) - mod.saved[0].astype(int)).max(-1)
    assert float((d <= 1).mean()) >= 0.999


# ---------------------------------------------------------------------------
# hello_water, hello_shadows, hello_ibl_skybox, hello_normal_mapping
# ---------------------------------------------------------------------------

def test_hello_water_matches_jax(monkeypatch):
    """The reflection pass (mirrored camera, CULL_FRONT, water masked
    out) and the main pass: the reflection's tids, the main view's tids,
    the water composite's HDR and the final LDR under the contract."""
    from lsr_tpu_torch.demos import hello_water as demo
    from lsr_tpu_torch.raster import tiled

    mod = jax_demo("hello_water", monkeypatch)
    jax_cameras(monkeypatch, demo)
    mod.main()
    scene = port_state(mod)
    scene["water_id"] = 1
    same_state(demo.build_scene(_torch_mesh(), "cpu"), scene)
    rec = _Recorder(tiled.rasterize_direct)
    monkeypatch.setattr(demo, "rasterize_direct", rec)
    out = demo.render(scene, W, H)
    (jr_refl, jr_main), (tr_refl, _) = (
        [np.asarray(c[2][1]) for c in mod.rasterize_direct.calls],
        [c[2][1].numpy() for c in rec.calls])
    assert float(((tr_refl == jr_refl) | (jr_refl < 0)).mean()) >= 0.995
    assert (jr_refl >= 0).any() and (jr_refl != jr_main).any()
    _contract(out, jr_main, mod.tonemap_pass.calls[0][0][0], mod.saved[0])
    assert (out["gb"].obj_id.numpy() == 1).sum() > 100


def test_hello_shadows_matches_jax(monkeypatch):
    """cull_scene + the occlusion pass (op by op, brute occluders on the
    lsr_tpu side), the PCF sun map at 128^2 and the binned camera raster:
    the visibility mask equal, the frame under the contract."""
    from lsr_tpu.geometry.occlusion import (
        occlusion_cull_aabbs, render_occluder_depth)
    from lsr_tpu.lighting.shadow_sample import make_shadow_context
    from lsr_tpu.passes.shadow import render_shadow_map
    from lsr_tpu.scene.scene import object_world_aabbs
    from lsr_tpu_torch.demos import hello_shadows as demo

    mod = jax_demo("hello_shadows", monkeypatch)
    jax_cameras(monkeypatch, demo)

    def occlusion(geom, objects, vp, zn, zf, frustum):
        occ = render_occluder_depth(geom, objects, vp, zn, zf,
                                    occluder_mask=frustum, kernel="brute")
        wmin, wmax = object_world_aabbs(objects)
        return frustum & occlusion_cull_aabbs.__wrapped__(
            occ, vp, wmin, wmax, zn, zf)

    def sun_shadow(geom, objects, sun, params):
        depth, vp = render_shadow_map.__wrapped__(
            geom, objects, sun, map_size=SUN_MAP, use_tiled=False)
        return make_shadow_context(
            depth, vp, bias_const=params.bias_const,
            bias_slope=params.bias_slope, strength=params.strength,
            pcf_radius=params.pcf_radius, pcf_step=params.pcf_step,
            filter_mode=params.filter_mode)

    mod.run_occlusion_pass = _Recorder(occlusion)
    mod.make_sun_shadow = sun_shadow
    mod.main()
    scene = port_state(mod)
    own = demo.build_scene(_torch_mesh(), "cpu")
    own["ctx"] = scene["ctx"]       # the demo makes its context per frame
    same_state(own, scene)
    out = demo.render(scene, W, H, shadow_size=SUN_MAP)
    j_vis = np.asarray(mod.run_occlusion_pass.calls[0][2])
    np.testing.assert_array_equal(out["visible"].numpy(), j_vis)
    (_, _, (_, j_tid, _)), = mod.rasterize_tiled.calls
    _contract(out, j_tid, mod.tonemap_pass.calls[0][0][0], mod.saved[0])
    assert int(out["max_bin"]) > demo.CAP       # 96x72: the cap was raised


def test_hello_ibl_skybox_matches_jax(monkeypatch, tmp_path):
    """Faces written by the port's stand-in writer and loaded by each
    package's load_cubemap (equal); the IBL baked from them by each
    package; env probes in the lighting; the cubemap sky behind."""
    from lsr_tpu.resources.cubemap import load_cubemap as jload
    from lsr_tpu_torch.demos import hello_ibl_skybox as demo
    from lsr_tpu_torch.demos.common import stand_in_mesh

    sky = demo.write_sky_faces(str(tmp_path), 2 * SKY, device="cpu")
    mod = jax_demo("hello_ibl_skybox", monkeypatch)
    jax_cameras(monkeypatch, demo)
    mod.load_cubemap = lambda _p, size: jload(sky, size=SKY)
    mod.main()
    own = demo.build_scene(stand_in_mesh(), "cpu", skybox=sky, sky_size=SKY)
    np.testing.assert_array_equal(own["faces"].numpy(), jload(sky, size=SKY))
    jctx = mod.make_shade_context.calls[0][2]
    irr, pref = own["ctx"].ibl
    np.testing.assert_allclose(irr.numpy(), np.asarray(jctx.ibl[0]),
                               rtol=0, atol=1e-5)
    for a, b in zip(pref, jctx.ibl[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    scene = port_state(mod)
    scene["faces"] = own["faces"]
    same_state(own, scene)
    out = demo.render(scene, W, H)
    (_, _, (_, j_tid, _)), = mod.rasterize_direct.calls
    _contract(out, j_tid, mod.tonemap_pass.calls[0][0][0], mod.saved[0])
    assert 0.1 < _covered_share(out) < 0.9


def test_hello_normal_mapping_matches_jax(monkeypatch):
    from lsr_tpu_torch.demos import hello_normal_mapping as demo

    mod = jax_demo("hello_normal_mapping", monkeypatch)
    jax_cameras(monkeypatch, demo)
    mod.main()
    scene = port_state(mod)
    assert scene["ctx"].surface_maps
    same_state(demo.build_scene(_torch_mesh(), "cpu"), scene)
    out = demo.render(scene, W, H)
    (_, _, (_, j_tid, _)), = mod.rasterize_direct.calls
    _contract(out, j_tid, mod.tonemap_pass.calls[0][0][0], mod.saved[0])


# ---------------------------------------------------------------------------
# hello_light_types, hello_local_shadows (lsr_tpu's build() / render())
# ---------------------------------------------------------------------------

def _built_state(mod):
    """lsr_tpu's build() of the demo, and its state in the port."""
    from lsr_tpu_torch import convert

    geom, objects, lights, ctx, eye = mod.build()
    mats = convert.materials_soa(ctx.materials, "cpu")
    return (geom, objects, lights, ctx, eye), {
        "geom": convert.geometry(geom, "cpu"),
        "objects": convert.objects_soa(objects, "cpu"),
        "lights": convert.lights_soa(lights, "cpu"), "materials": mats,
        "ctx": convert.shade_context(ctx, mats, "cpu"),
        "device": torch.device("cpu")}


def test_hello_light_types_matches_jax(monkeypatch):
    """Both of the port's raster routes (B1's plain version and
    rasterize_brute) against lsr_tpu's brute route; the two port frames
    equal bit for bit, as lsr_tpu's demo asserts of its backends."""
    from lsr_tpu_torch.demos import hello_light_types as demo

    mod = jax_demo("hello_light_types", monkeypatch)
    jax_cameras(monkeypatch, demo)
    state, scene = _built_state(mod)
    j_ldr, _ = mod.render(*state, W, H, use_tiled=False)
    (_, _, (_, j_tid)), = mod.rasterize_brute.calls
    same_state(demo.build_scene(_torch_mesh(), "cpu"), scene)
    outs = [demo.render(scene, W, H, use_tiled=t) for t in (True, False)]
    for out in outs:
        _contract(out, j_tid, mod.tonemap_pass.calls[0][0][0], j_ldr)
    assert torch.equal(outs[0]["ldr"], outs[1]["ldr"])
    assert int(outs[0]["stats"]["max_lights_per_bin"]) >= 2


@pytest.mark.parametrize("shadow_filter,atlas", [("pcf", "map"),
                                                 ("esm", "packed")])
def test_hello_local_shadows_matches_jax(monkeypatch, shadow_filter, atlas):
    """The atlas at 32^2 (lsr_tpu's slot by slot, op by op:
    torch_scenes.jax_local_atlas with the demo's pcf radius 1), the
    shadowed forward+ frame under the contract, for both filters and
    both of the port's atlas strategies."""
    from lsr_tpu_torch.demos import hello_local_shadows as demo
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters
    from torch_scenes import jax_local_atlas

    mod = jax_demo("hello_local_shadows", monkeypatch)
    jax_cameras(monkeypatch, demo)

    def atlas_ref(geom, objects, lights, spot_ids, point_ids, map_size,
                  pcf_radius, use_tiled, filter_mode, atlas_packed):
        assert (map_size, pcf_radius, use_tiled) == (512, 1, False)
        return jax_local_atlas(geom, objects, lights, spot_ids, point_ids,
                               ATLAS, ATLAS, filter_mode,
                               pcf_radius=pcf_radius)

    mod.render_local_shadow_maps = atlas_ref
    monkeypatch.setenv("LSR_DEMO_SHADOW_FILTER", shadow_filter)
    state, scene = _built_state(mod)
    j_ldr = mod.render(*state, W, H, use_tiled=False)
    (_, _, (_, j_tid)), = mod.rasterize_brute.calls
    scene["casters"] = plan_shadow_casters(scene["lights"], max_spot=8,
                                           max_point=2)
    assert scene["casters"] == ((0, 1), (2, 3))
    own = demo.build_scene(_torch_mesh(), "cpu")
    same_state(own, scene)
    assert own["casters"] == scene["casters"]
    out = demo.render(scene, W, H, shadow_filter=shadow_filter, atlas=atlas,
                      map_size=ATLAS)
    _contract(out, j_tid, mod.tonemap_pass.calls[0][0][0], j_ldr)


# ---------------------------------------------------------------------------
# hello_shaders
# ---------------------------------------------------------------------------

def test_hello_shaders_matches_jax(monkeypatch):
    """The contact sheet against lsr_tpu's, its fields unjitted (see
    tests/test_torch_water.py): within 1 LSB on >= 99.9% of values."""
    from lsr_tpu_torch.demos import hello_shaders as demo

    mod = jax_demo("hello_shaders", monkeypatch)
    mod.PROCEDURAL_SHADERS = {k: v.__wrapped__
                              for k, v in mod.PROCEDURAL_SHADERS.items()}
    mod.main()
    sheet = demo.render(demo.build_scene(device="cpu"), W, H)["ldr"].numpy()
    assert sheet.shape == mod.saved[0].shape == (2 * H, 4 * W, 3)
    d = np.abs(sheet.astype(int) - mod.saved[0].astype(int))
    assert float((d <= 1).mean()) >= 0.999, int((d > 1).sum())
