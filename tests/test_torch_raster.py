"""lsr_tpu_torch geometry front-end and direct rasterizer vs lsr_tpu (CPU).

Both packages get the same scene state (tests/torch_scenes.py, converted with
lsr_tpu_torch.convert).  The JAX side runs as its own CPU tests do:
rasterize_direct in Pallas interpret mode, rasterize_brute as the anchor.
The torch side runs its plain versions (rasterize_direct on CPU tensors is
rasterize_brute).

Tolerances, and why they are not bit-exact: XLA:CPU contracts the JAX
package's multiply-adds into FMAs (the vertex transform's lane FMAs, the
edge functions A*x + B*y + C), torch does not.  Given the same post-clip
corners, build_setup agrees bit for bit.  The affine edge functions of
sub-pixel triangles are ill-conditioned in f32 (C ~ sx*sy ~ 1e3-1e4 over an
area of ~0.1 px^2), so an ulp in a clip coordinate moves depth01 by up to
~1e-3 on sphere pixels.  Every test states the bound it allows.
"""

from __future__ import annotations

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_scenes import jax_camera, jax_flagship_scene, to_torch, torch_setup

W, H = 128, 96


@pytest.fixture(scope="module")
def scene():
    geom, objects, lights, ctx = jax_flagship_scene(n_lights=16, grid=2)
    cam, ctx_t = jax_camera(0, ctx, W, H)
    t = to_torch(geom, objects, lights, ctx, cam, ctx_t)
    return dict(j=(geom, objects, lights, ctx, cam, ctx_t), t=t)


@pytest.fixture(scope="module")
def setups(scene):
    """lsr_tpu's TriSetup and the same setup as lsr_tpu_torch tensors."""
    from lsr_tpu.raster.setup import scene_setup

    geom, objects, _, _, cam, _ = scene["j"]
    s = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                    geom.vtx_obj, geom.tri_obj, objects.model,
                    objects.normal_mat, cam.viewproj, W, H,
                    obj_visible=objects.visible)
    return s, torch_setup(s)


# ---------------------------------------------------------------------------
# Scene state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid,n_lights", [(2, 16), (5, 256)])
def test_flagship_scene_matches_jax(grid, n_lights):
    """build_flagship_scene draws the same rng values in the bench's order:
    geometry, lights, materials and texture exact; model matrices (cos/sin
    and a 4x4 product in f32) within 1e-6."""
    from lsr_tpu_torch.frame import build_flagship_scene, flagship_camera

    jg, jo, jl, jc = jax_flagship_scene(n_lights=n_lights, grid=grid)
    tg, to, tl, tc = build_flagship_scene(n_lights=n_lights, grid=grid,
                                         device="cpu")
    for f in ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_allclose(to.model.numpy(), np.asarray(jo.model),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(to.normal_mat.numpy(),
                               np.asarray(jo.normal_mat), rtol=0, atol=1e-6)
    for f in ("local_min", "local_max", "casts_shadow", "visible", "material"):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    from lsr_tpu_torch.lighting.light_types import COLUMNS

    for f in COLUMNS:
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    assert tl.kinds == (1, 2) and tl.apow1
    for f in ("base_color", "metallic", "roughness", "ao", "emissive",
              "tex_id"):
        np.testing.assert_array_equal(getattr(tc.materials, f).numpy(),
                                      np.asarray(getattr(jc.materials, f)))
    np.testing.assert_array_equal(tc.textures.numpy(), np.asarray(jc.textures))
    np.testing.assert_array_equal(tc.texture_quads.numpy(),
                                  np.asarray(jc.texture_quads))
    for i in (0, 7):
        tcam, tct = flagship_camera(i, tc, W, H, device="cpu")
        jcam, jct = jax_camera(i, jc, W, H)
        for f in ("view", "proj", "viewproj"):
            np.testing.assert_allclose(getattr(tcam, f).numpy(),
                                       np.asarray(getattr(jcam, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        assert (tcam.zn, tcam.zf) == (float(jcam.zn), float(jcam.zf))
        np.testing.assert_array_equal(tct.camera_pos.numpy(),
                                      np.asarray(jct.camera_pos))


def test_math_and_color_match_jax():
    """math3d within 1e-6; quantize_u8 rounds half UP (floor(x*255+0.5)),
    unlike torch.round's half-to-even, and matches lsr_tpu exactly."""
    from lsr_tpu.core import color as jcolor
    from lsr_tpu.core import math3d as jm

    from lsr_tpu_torch.core import color as tcolor
    from lsr_tpu_torch.core import math3d as tm

    pairs = [
        (tm.perspective_lh_no(1.1, 4 / 3, 0.1, 100.0),
         jm.perspective_lh_no(1.1, 4 / 3, 0.1, 100.0)),
        (tm.look_at_lh((1.0, 2.0, -3.0), (0.2, 0.1, 0.0), (0, 1, 0)),
         jm.look_at_lh(jnp.asarray([1.0, 2.0, -3.0]),
                       jnp.asarray([0.2, 0.1, 0.0]), jnp.asarray([0., 1, 0]))),
        (tm.translate([1.5, -2.0, 0.25]), jm.translate([1.5, -2.0, 0.25])),
        (tm.rotate_y(0.7), jm.rotate_y(0.7)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    x = np.concatenate([(np.arange(256) + 0.5) / 255.0,
                        np.random.default_rng(0).uniform(-0.1, 1.1, 4096)])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(tcolor.quantize_u8(torch.as_tensor(x)).numpy(),
                                  np.asarray(jcolor.quantize_u8(x)))
    rgb = np.random.default_rng(1).uniform(0, 4, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tcolor.reinhard_tonemap(torch.as_tensor(rgb)).numpy(),
        np.asarray(jcolor.reinhard_tonemap(rgb)), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Geometry front-end
# ---------------------------------------------------------------------------

def test_vertex_stage_matches_jax(scene):
    """World / clip / normal per vertex within 4e-6 of the row magnitude
    (|M| |p|): a few f32 ulps, the FMA-vs-separate-rounding difference."""
    from lsr_tpu.raster.setup import vertex_stage as jvs

    from lsr_tpu_torch.raster.setup import vertex_stage as tvs

    geom, objects, _, _, cam, _ = scene["j"]
    tg, to, _, _, tcam, _ = scene["t"]
    jw, jc, jn = (np.asarray(a) for a in jvs(
        geom.positions, geom.normals, geom.uvs, geom.vtx_obj, objects.model,
        objects.normal_mat, cam.viewproj))
    tw, tc, tn = tvs(tg.positions, tg.normals, tg.uvs, tg.vtx_obj, to.model,
                     to.normal_mat, tcam.viewproj)
    scale_w = np.abs(np.asarray(objects.model)).max() \
        * (np.abs(np.asarray(geom.positions)).max() + 1.0)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=4e-6 * scale_w)
    scale_c = np.abs(np.asarray(cam.viewproj)).max() * np.abs(jw).max() * 4
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=4e-6 * scale_c)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=1e-6)


def test_build_setup_bit_exact_on_same_corners(scene):
    """Given lsr_tpu's own vertex-stage outputs, near-clip assembly and
    build_setup reproduce coef, iw, ziw, bbox and valid bit for bit (the
    stated bound is 1e-6 relative; they are in fact exact)."""
    from lsr_tpu.raster.setup import (
        assemble_and_clip, build_setup, vertex_stage)

    from lsr_tpu_torch.raster import setup as ts

    geom, objects, _, _, cam, _ = scene["j"]
    jw, jc, jn = vertex_stage(geom.positions, geom.normals, geom.uvs,
                              geom.vtx_obj, objects.model, objects.normal_mat,
                              cam.viewproj)
    clip_t, attrs, valid, obj2 = assemble_and_clip(
        jc, jw, jn, geom.uvs, geom.indices, geom.tri_obj)
    js = build_setup(clip_t, attrs, valid, obj2, W, H)

    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    tclip, tattrs, tvalid, tobj = ts.assemble_and_clip(
        T(jc), T(jw), T(jn), T(geom.uvs), T(geom.indices).long(),
        T(geom.tri_obj).long())
    np.testing.assert_array_equal(tclip.numpy(), np.asarray(clip_t))
    for k in ("wp", "uv"):
        np.testing.assert_array_equal(tattrs[k].numpy(), np.asarray(attrs[k]))
    # Re-normalized corner normals: XLA:CPU fuses the squared norm into
    # FMAs, so unit normals may differ by 2 ulp.
    np.testing.assert_allclose(tattrs["normal"].numpy(),
                               np.asarray(attrs["normal"]), rtol=0,
                               atol=2.4e-7)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    tsu = ts.build_setup(tclip, tattrs, tvalid, tobj, W, H)
    for f in ("coef", "iw", "ziw"):
        a, b = np.asarray(getattr(js, f)), getattr(tsu, f).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("bbox", "valid", "obj_id"):
        np.testing.assert_array_equal(getattr(tsu, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_scene_setup_matches_jax(scene, setups):
    """End to end from the same scene: bbox and valid exact; 1/w and z/w
    within 2e-5 relative (near-cancelling dot products in the clip w);
    edge functions through the raster tests."""
    from lsr_tpu_torch.raster.setup import scene_setup

    js, _ = setups
    tg, to, _, _, tcam, _ = scene["t"]
    ts = scene_setup(tg.positions, tg.normals, tg.uvs, tg.indices, tg.vtx_obj,
                     tg.tri_obj, to.model, to.normal_mat, tcam.viewproj, W, H,
                     obj_visible=to.visible)
    np.testing.assert_array_equal(ts.bbox.numpy(), np.asarray(js.bbox))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    v = np.asarray(js.valid)
    for f in ("iw", "ziw"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[v],
                                   np.asarray(getattr(js, f))[v], rtol=2e-5,
                                   atol=1e-7, err_msg=f)


# ---------------------------------------------------------------------------
# Direct rasterizer (plain path of kernel B1)
# ---------------------------------------------------------------------------

def _raster_compare(jd, jt, td, tt, depth_tol):
    jd, jt = np.asarray(jd), np.asarray(jt)
    td, tt = td.numpy(), tt.numpy()
    same = jt == tt
    covered = max(int((jt >= 0).sum()), 1)
    mism = int((~same).sum())
    assert mism <= 0.002 * covered, (mism, covered)
    err = np.abs(jd - td)[same].max()
    assert err <= depth_tol, err
    return mism, err


@pytest.mark.parametrize("sort,mode,track", [
    (True, "viewz", True), (False, "viewz", True), (True, "viewz", False),
    (False, "ndc01", True)])
def test_rasterize_direct_matches_jax(scene, setups, sort, mode, track):
    """Same TriSetup into both rasterize_direct's: depth01 within 2e-5 (the
    FMA difference in A*x + B*y + C), tids equal on >= 99.8% of covered
    pixels (edge / z-tie pixels only), max supers per tile equal."""
    from lsr_tpu.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ
    from lsr_tpu.raster.tiled import rasterize_direct as jrd

    from lsr_tpu_torch.raster.tiled import rasterize_direct as trd

    js, tsu = setups
    cam, tcam = scene["j"][4], scene["t"][4]
    dm = DEPTH_VIEWZ if mode == "viewz" else DEPTH_NDC01
    jd, jt, jm = jrd(js, W, H, cam.zn, cam.zf, depth_mode=dm,
                     track_ids=track, spatial_sort=sort)
    td, tt, tm = trd(tsu, W, H, tcam.zn, tcam.zf, depth_mode=dm,
                     track_ids=track, spatial_sort=sort)
    assert int(jm) == int(tm)
    if not track:
        assert (tt.numpy() == -1).all() and (np.asarray(jt) == -1).all()
        jt = np.where(np.asarray(jd) < 1.0, 0, -1)
        tt = torch.where(td < 1.0, 0, -1)
    _raster_compare(jd, jt, td, tt, depth_tol=2e-5)


def test_rasterize_brute_matches_jax_brute(scene, setups):
    """The anchors: rasterize_brute on both sides, same tolerances."""
    from lsr_tpu.raster.brute import rasterize_brute as jrb

    from lsr_tpu_torch.raster.brute import rasterize_brute as trb

    js, tsu = setups
    cam, tcam = scene["j"][4], scene["t"][4]
    jd, jt = jrb(js, W, H, cam.zn, cam.zf)
    td, tt = trb(tsu, W, H, tcam.zn, tcam.zf)
    _raster_compare(jd, jt, td, tt, depth_tol=2e-5)


def test_super_lists_and_sort_match_jax(setups):
    """Spatial-sort order, chunk bboxes and per-tile super lists are the
    same integers on both sides (the port sizes lists by the super count
    instead of lsr_tpu's SMEM clamp, so only the first `count` entries of a
    row are compared)."""
    from lsr_tpu.raster import tiled as jtl

    from lsr_tpu_torch.raster import tiled as ttl

    js, tsu = setups
    n = tsu.coef.shape[0]
    for sort in (False, True):
        rec, ss, n_pad = ttl.pack_direct_records(tsu, sort)
        if sort:
            bb = np.asarray(js.bbox)
            key = ((bb[:, 1] + bb[:, 3]) // 2 // 128) * (1 << 15) \
                + (bb[:, 0] + bb[:, 2]) // 2 // 128
            key = np.where(np.asarray(js.valid), key, 1 << 29)
            order = np.asarray(jnp.argsort(jnp.asarray(key)))
            np.testing.assert_array_equal(rec[:n, 15].numpy(), np.where(
                np.asarray(js.valid)[order], order, -1).astype(np.float32))
            import jax

            jsorted = jax.tree_util.tree_map(lambda x: x[order], js)
        else:
            jsorted = js
        jcb = np.asarray(jtl._chunk_bboxes(jsorted, n_pad, 16))
        tcb = ttl._chunk_bboxes(ss, n_pad, 16)
        np.testing.assert_array_equal(tcb.numpy(), jcb)
        tiles_x, tiles_y = -(-W // 128), -(-H // 128)
        jl, jc, jmx = jtl._super_lists(jnp.asarray(jcb), 16, tiles_x, tiles_y,
                                       128, 128, n_pad // 256, 0.0)
        tl, tc, tmx = ttl._super_lists(tcb, 16, tiles_x, tiles_y, 128, 128)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert int(tmx) == int(jmx)
        for row, c in enumerate(np.asarray(jc)):
            np.testing.assert_array_equal(tl.numpy()[row, :c],
                                          np.asarray(jl)[row, :c])


# ---------------------------------------------------------------------------
# Package boundaries
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    """lsr_tpu_torch imports torch and numpy only: every module of the
    package (found by walking it, the demos included) is imported in a
    fresh interpreter, and then neither jax nor lsr_tpu is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lsr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    lsr_tpu_torch.__path__, 'lsr_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'lsr_tpu_torch.demos.hello_water' in names, names\n"
        "assert 'lsr_tpu_torch.frame' in names, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lsr_tpu' or m.startswith('lsr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr
    assert int(res.stdout.split()[1]) >= 80


def test_library_does_not_import_the_demos():
    """No module of lsr_tpu_torch outside lsr_tpu_torch/demos/ imports
    lsr_tpu_torch.demos (lsr_tpu's layering rule, tests/test_layering.py:
    the library never depends on its demos)."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "lsr_tpu_torch"
    offenders, n_files = [], 0
    for path in root.rglob("*.py"):
        if "demos" in path.relative_to(root).parts:
            continue
        n_files += 1
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            if any(n == "lsr_tpu_torch.demos"
                   or n.startswith("lsr_tpu_torch.demos.") for n in names):
                offenders.append(str(path))
    assert n_files > 60 and not offenders, offenders


def test_kernel_wrappers_do_not_fall_back(setups):
    """A wrapper runs its plain version only for CPU tensors: any other
    device launches the kernel or raises (here a meta tensor raises), the
    screen-band branch (B1b) too."""
    from lsr_tpu_torch.raster.setup import TriSetup
    from lsr_tpu_torch.raster.tiled import rasterize_direct

    _, tsu = setups
    meta = TriSetup(**{f.name: getattr(tsu, f.name).to("meta")
                       for f in __import__("dataclasses").fields(TriSetup)})
    with pytest.raises(ValueError, match="unsupported device"):
        rasterize_direct(meta, W, H, 0.1, 100.0)
    with pytest.raises(ValueError, match="unsupported device"):
        rasterize_direct(meta, W, H // 2, 0.1, 100.0, y_offset=H // 2,
                         full_height=H)


def test_kernel_resources_reads_the_ptxas_log():
    """kernel_resources: registers, spills and static shared memory per
    entry function from an `nvcc -Xptxas -v` log, grouped by source."""
    from lsr_tpu_torch.utils.cuda_build import kernel_resources

    log = """== a.cu
ptxas info    : 24 bytes gmem
ptxas info    : Compiling entry function '_Z1aILi8EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi8EEvPf
    56 bytes stack frame, 24 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 56 bytes cumulative stack size, 1024 bytes smem
ptxas info    : Compiling entry function '_Z1aILi16EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi16EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
== b.cu
ptxas info    : Compiling entry function 'k' for 'sm_90a'
ptxas info    : Function properties for k
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers
"""
    assert kernel_resources(log) == {
        "a.cu": [{"fn": "_Z1aILi8EEvPf", "registers": 64, "spill_bytes": 84,
                  "stack_bytes": 56, "smem_bytes": 1024},
                 {"fn": "_Z1aILi16EEvPf", "registers": 80, "spill_bytes": 0,
                  "stack_bytes": 0, "smem_bytes": 0}],
        "b.cu": [{"fn": "k", "registers": 20, "spill_bytes": 0,
                  "stack_bytes": 0, "smem_bytes": 0}]}
    assert kernel_resources("") == {}
