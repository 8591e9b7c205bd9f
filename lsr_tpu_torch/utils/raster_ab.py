"""Time the raster kernels B1, B3 and B4 of this tree against another
tree's and against patched variants, on the card, in one process.

This tree's kernels read their z params from device memory (`const float*
zparams`, raster/brute.zparams, loaded once by each thread); an older tree
(--parent DIR: its csrc/, say the parent commit unpacked with `git
archive` into a git-ignored directory) took them as two launch floats,
which live in the constant bank and hold no register.  The variants patch
this tree's csrc/ (in copies under build/, git-ignored): the pair re-read
from global memory where a pixel evaluates a triangle (an `asm volatile`
`ld.global.nc`, which the compiler may not hoist), or from shared memory
(loaded once a block, read volatile where used).  Every library gets the same inputs: the flagship
scene's camera setup at 1920x1080 (B1 spatially sorted, view-z depth with
ids, and unsorted), its 2048^2 sun map (B1, NDC01 depth only), and the
high-poly scene's compact setup at 1920x1080 (B3 at 64x128 tiles, chunk
16, fitted cap; B4 at 128x128, sub_h 32); each output must equal the
shipped library's bit for bit.

    python -m lsr_tpu_torch.utils.raster_ab [--parent DIR]

Prints the card, each library's registers / spilled bytes per raster
kernel (`-Xptxas -v`) and, per input, each library's kernel ms (CUDA
events, 30 launches) over rounds in alternating order, with the median.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess

import torch

from lsr_tpu_torch.utils import cuda_build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
RASTERS = ("direct_raster.cu", "tiled_raster.cu", "chunklist_raster.cu")

# The launchers' C signatures when (zn, inv_range) were launch floats.
FLOAT_SIGNATURES = {
    "lsr_direct_raster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _F, _F, _F, _I, _I, _I, _I, _I, _P),
    "lsr_tiled_raster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _F, _F, _I, _F, _I, _P),
    "lsr_chunklist_raster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _F, _F, _I, _F, _I, _I,
                             _P),
}

# The walk takes a pointer to the pair in place of its two values: the
# kernels pass it on, resolve_entry reads it where a pixel evaluates.
_LOAD = ("  // The z params are data (lsr_tpu's z_ref): one broadcast load a "
         "warp.\n  const float zn = __ldg(zparams), inv_range = "
         "__ldg(zparams + 1);\n")
_WALK = "block_walk.cuh"


def _pointer_walk(read):
    """The (file, old, new) replacements that pass the pair's address down
    the walk; `read` is the C++ that loads zn and inv_range from zp."""
    return [
        (_WALK, "int depth_mode, float zn,\n                                 "
                "             float inv_range, float& d,",
         "int depth_mode, const float* zp,\n                                "
         "              float& d,"),
        (_WALK, "  float z01;\n  if (p.live\n      && tri_depth(",
         "  float z01;\n" + read + "  if (p.live\n      && tri_depth("),
        (_WALK, "int depth_mode, float zn, float inv_range, float& d, int& t) "
                "{",
         "int depth_mode, const float* zp, float& d, int& t) {"),
        (_WALK, "p, depth_mode, zn,\n                                   "
                "inv_range, d, t);",
         "p, depth_mode, zp, d, t);"),
    ]


def _kernels_pass(ptr):
    """The kernels hand `ptr` (an expression) to the walk in place of the
    loaded pair."""
    return [
        ("direct_raster.cu", _LOAD, ""),
        ("direct_raster.cu", "depth_mode, zn, inv_range, d, t);",
         f"depth_mode, {ptr}, d, t);"),
        ("tiled_raster.cu", _LOAD, ""),
        ("tiled_raster.cu", "depth_mode, zn,\n                              "
                            "  inv_range, d, t);",
         f"depth_mode, {ptr}, d, t);"),
        ("chunklist_raster.cu", _LOAD, ""),
        ("chunklist_raster.cu", "depth_mode, zn, inv_range, d, t);",
         f"depth_mode, {ptr}, d, t);"),
    ]


_READ_GLOBAL = (
    "  float zn, inv_range;\n"
    "  asm volatile(\"{ .reg .u64 g; cvta.to.global.u64 g, %2;\"\n"
    "               \" ld.global.nc.v2.f32 {%0, %1}, [g]; }\"\n"
    "               : \"=f\"(zn), \"=f\"(inv_range) : \"l\"(zp));\n")
_READ_SHARED = (
    "  const float zn = ((volatile const float*)zp)[0];\n"
    "  const float inv_range = ((volatile const float*)zp)[1];\n")
# Loaded into shared memory once a block; the walk's first barrier comes
# before any pixel evaluates.
_SHARED_LOAD = ("  __shared__ float zs[2];\n"
                "  if (threadIdx.x < 2) zs[threadIdx.x] = zparams[threadIdx.x];"
                "\n")

# name -> (file, old, new) replacements of csrc/.  The first is the
# shipped library.
VARIANTS = {
    "shipped: the pair loaded once a thread": [],
    "the pair re-read from global memory where used": (
        _pointer_walk(_READ_GLOBAL) + _kernels_pass("zparams")),
    "the pair in shared memory, re-read where used": (
        _pointer_walk(_READ_SHARED) + _kernels_pass("zs")
        + [(f, "  // The block lies inside one tile", _SHARED_LOAD
            + "  // The block lies inside one tile")
           for f in ("tiled_raster.cu", "chunklist_raster.cu")]
        + [("direct_raster.cu", "  const int bx = blockIdx.x * lsr::kBlock,",
            _SHARED_LOAD + "  const int bx = blockIdx.x * lsr::kBlock,")]),
}


def _build(tag, src_dir, patches):
    d = os.path.join(os.path.dirname(cuda_build.BUILD_DIR),
                     f"raster_ab_{tag}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    for name, old, new in patches:
        p = os.path.join(d, name)
        with open(p) as f:
            src = f.read()
        if old not in src:
            raise RuntimeError(f"raster_ab: {old!r} not in {name}")
        with open(p, "w") as f:
            f.write(src.replace(old, new, 1))
    keep = cuda_build.CSRC
    cuda_build.CSRC, cuda_build._lib = d, None
    try:
        lib = cuda_build.load_kernels()
    finally:
        cuda_build.CSRC, cuda_build._lib = keep, None
    res = cuda_build.kernel_resources(cuda_build.build_info["log"])
    return lib, {src: [(r["registers"], r["spill_bytes"]) for r in fns]
                 for src, fns in res.items() if src in RASTERS}


def _ms(fn, iters=30):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _inputs(dev):
    """{name: (launcher name, build(z, stream) -> argument list, outputs,
    (zn, zf))} on the flagship and high-poly scenes; z is the pair's
    launch arguments."""
    from lsr_tpu_torch.camera.light_camera import build_dir_light_camera
    from lsr_tpu_torch.core.util import cdiv
    from lsr_tpu_torch.frame import build_flagship_scene, flagship_camera
    from lsr_tpu_torch.highpoly import (
        build_highpoly_scene, compact_setup, highpoly_camera)
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.setup import (
        CULL_NONE, DEPTH_NDC01, DEPTH_VIEWZ, scene_setup, scene_setup_depth)
    from lsr_tpu_torch.scene.scene import shadow_caster_aabb

    w, h, s = 1920, 1080, 2048
    geom, objects, _, ctx = build_flagship_scene(256, 42, device=dev)
    cam, _ = flagship_camera(0, ctx, w, h, device=dev)
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, cam.viewproj, w, h)
    _, _, light_vp = build_dir_light_camera(*shadow_caster_aabb(objects),
                                            ctx.light_dir_ws, s)
    sun = scene_setup_depth(
        geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
        objects.model, light_vp, s, s, cull_mode=CULL_NONE,
        obj_visible=objects.casts_shadow & objects.visible)
    hg, ho, _, hctx = build_highpoly_scene(33, device=dev)
    hcam, _ = highpoly_camera(hctx, w, h, 33, device=dev)
    hsetup, _ = compact_setup(hg, ho, hcam, w, h)

    def targets(ww, hh):
        return (torch.empty((hh, ww), dtype=torch.float32, device=dev),
                torch.empty((hh, ww), dtype=torch.int32, device=dev))

    out = {}

    def b1(name, st, ww, hh, sort, mode, track, zn, zf):
        rec, ss, n_pad = tiled.pack_direct_records(st, sort)
        cbb = tiled._chunk_bboxes(ss, n_pad, 16).contiguous()
        sl, cnt, _ = tiled._super_lists(cbb, 16, cdiv(ww, 128),
                                        cdiv(hh, 128), 128, 128)
        d, t = targets(ww, hh)
        out[name] = ("lsr_direct_raster", lambda z, stream: [
            rec.data_ptr(), cbb.data_ptr(), sl.data_ptr(), cnt.data_ptr(),
            None, None, d.data_ptr(), t.data_ptr(), ww, hh, cdiv(ww, 128),
            sl.shape[1], *z, float(hh - 1), mode, int(track), int(sort), 0,
            0, stream], (d, t) if track else (d,), (zn, zf))

    b1("B1 camera 1080p [sort, view-z, ids]", setup, w, h, True,
       DEPTH_VIEWZ, True, cam.zn, cam.zf)
    b1("B1 camera 1080p [unsorted, view-z, ids]", setup, w, h, False,
       DEPTH_VIEWZ, True, cam.zn, cam.zf)
    b1("B1 sun map 2048^2 [NDC01, depth only]", sun, s, s, False,
       DEPTH_NDC01, False, 0.0, 1.0)

    rec, lists, n_walk, *_ = tiled.tiled_inputs(hsetup, w, h, 64, 128, 1024,
                                                16, fit_cap=True)
    order = tiled.tile_order(n_walk)
    d0, t0 = tiled._targets(None, None, h, w, dev)
    d3, t3 = targets(w, h)
    out["B3 high-poly compact 1080p [64x128, chunk 16]"] = (
        "lsr_tiled_raster", lambda z, stream: [
            rec.data_ptr(), lists.data_ptr(), n_walk.data_ptr(),
            order.data_ptr(), d0.data_ptr(), t0.data_ptr(), d3.data_ptr(),
            t3.data_ptr(), w, h, 128, 64, cdiv(w, 128), cdiv(h, 64),
            lists.shape[1], *z, 0, float(h - 1), DEPTH_VIEWZ, stream],
        (d3, t3), (hcam.zn, hcam.zf))
    rec4, cl, cc, _ = tiled.chunklist_inputs(hsetup, w, h, 128, 128, 16,
                                             None, 32)
    order4 = tiled.tile_order(cc)
    d4, t4 = targets(w, h)
    out["B4 high-poly compact 1080p [128x128, sub_h 32]"] = (
        "lsr_chunklist_raster", lambda z, stream: [
            rec4.data_ptr(), cl.data_ptr(), cc.data_ptr(), order4.data_ptr(),
            d0.data_ptr(), t0.data_ptr(), d4.data_ptr(), t4.data_ptr(), w, h,
            128, 128, cdiv(w, 128), cdiv(h, 128), cl.shape[1], 16, 32, *z, 0,
            float(h - 1), DEPTH_VIEWZ, 1, stream], (d4, t4),
        (hcam.zn, hcam.zf))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another tree's lsr_tpu_torch/csrc, "
                    "whose rasters take (zn, inv_range) as launch floats")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    from lsr_tpu_torch.raster.brute import depth_params, zparams

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    libs, floats = {}, set()
    for i, (name, patches) in enumerate(VARIANTS.items()):
        try:
            libs[name] = _build(i, cuda_build.CSRC, patches)
        except RuntimeError as e:
            if not patches:
                raise
            print(f"# {name}: not built: {e}", flush=True)
    if args.parent:
        name = f"parent ({args.parent}): launch floats"
        lib, res = _build("parent", args.parent, [])
        for fn, sig in FLOAT_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(sig)
        libs[name] = (lib, res)
        floats.add(name)
    for name, (_, res) in libs.items():
        print(f"# {name}: registers / spilled bytes {res}", flush=True)

    stream = torch.cuda.current_stream(dev).cuda_stream
    inputs = _inputs(dev)
    names = list(libs)
    rows = []
    for tag, (fn, build, outs, (zn, zf)) in inputs.items():
        zp = zparams(zn, zf, dev)
        zf_args = depth_params(float(zn), float(zf))

        def launch(name):
            lib = libs[name][0]
            z = zf_args if name in floats else (zp.data_ptr(),)
            err = getattr(lib, fn)(*build(z, stream))
            cuda_build.check_launch(fn, err)

        ref = None
        for name in names:
            launch(name)
            torch.cuda.synchronize()
            got = [o.clone() for o in outs]
            if ref is None:
                ref = got
            elif not all(torch.equal(a, b) for a, b in zip(ref, got)):
                raise RuntimeError(f"raster_ab: {name} differs from the "
                                   f"shipped kernel on {tag}")
        ms = {n: [] for n in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                ms[name].append(_ms(lambda n=name: launch(n)))
        row = {"input": tag, "card": card,
               "median_ms": {n: statistics.median(v) for n, v in ms.items()},
               "ms": {n: [round(x, 5) for x in v] for n, v in ms.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print("# every output bit for bit the shipped kernel's", flush=True)
    return rows


if __name__ == "__main__":
    main()
