#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lsr_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from lsr_tpu_torch/csrc/ (nvcc, at
first use, into build/kernels/), then:

1. B1 (rasterize_direct) at the flagship shapes: the kernel against its
   plain version (rasterize_brute) on the card, in each supported mode.
   Depth must match bit for bit and tids exactly.
2. B2 (shade_fused) at the flagship shapes: the kernel against its plain
   version on the card, pbr_mr and blinn_phong, on the flagship light set and
   on a mixed set with rect and tube lights.  Lit rgb within 1e-4.
3. A small-input reference: the same scene rendered by the plain versions on
   the CPU and by the kernels on the card, at 192x108.
4. The main path: launch counters reset, then the 1920x1080, 256-light
   forward+ frame (make_flagship_frame) along the bench orbit; prints the
   median ms per frame, the launch counts and the frame statistics, and
   writes out/torch_flagship.png.

Then the high-poly path, on the 33x33 sphere field (1,115,136 triangles,
lsr_tpu_torch.highpoly):

5. Extra modes of B3 (rasterize_tiled) and B4 (rasterize_chunklist) at
   480x270 on the compact setup of the same scene: each wrapper against its
   plain version on the same lists, B3 at render_forward's 32x128 / chunk 8,
   B4 in NDC01 depth only and on a y_offset half band.  Depth and tid bit
   for bit.
6. The raster at 1920x1080 on the compact setup: B3 at the pipeline's
   64x128 / chunk 16 with the fitted cap, B3 with a cap below the largest
   bin, and B4 at 128x128 / sub_h 32, each wrapper against its plain version
   on the same lists, bit for bit.  Then B1 (unsorted), B3 and B4 against
   each other: a pixel may differ only where a winner is "stray", a sliver
   triangle whose f32 edge functions cover a pixel outside its bbox, which
   each kernel's culling grain keeps or skips; everywhere else depth and
   tid are equal bit for bit.  Times each kernel alone on prebuilt lists
   and each wrapper (CUDA events).
7. The high-poly forward+ frame (make_highpoly_frame) at 1920x1080, counts
   reset: compact setup -> B3 -> interp -> B2 -> tonemap -> FXAA; no
   triangle may be dropped.  Writes out/torch_highpoly.png.
8. The bench's end-to-end step, compact setup + B4, counts reset: against
   the chunk-list raster of the full setup, coverage and depth equal on
   every pixel but stray sliver ones (as in phase 6).
9. render_forward on the flagship scene (B1 route) and on the high-poly
   scene (B3 route), counts reset before each.

Any failed phase raises, so the script exits non-zero.  Its output ends with
the card's name and power limit, one JSON line of per-kernel results and,
last, {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT = 1920, 1080
N_LIGHTS = 256
SEED = 42
WARMUP, FRAMES = 3, 12
SMALL_W, SMALL_H = 192, 108
B2_TOL = 1e-4
PLAIN_W, PLAIN_H = 480, 270        # B3 / B4 against their plain versions
HP_GRID = 33
HP_WARMUP, HP_FRAMES = 2, 5


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters):
    """Mean device ms of fn() over iters launches (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def b1_phase(setup, cam, dev):
    """Kernel B1 against rasterize_brute on the card.  Returns the result
    entry for the main-path mode (spatial sort, view-z, ids)."""
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ

    modes = [("sort,viewz,ids", True, DEPTH_VIEWZ, True),
             ("unsorted,viewz,ids", False, DEPTH_VIEWZ, True),
             ("sort,viewz,depth-only", True, DEPTH_VIEWZ, False),
             ("unsorted,ndc01,ids", False, DEPTH_NDC01, True)]
    result = None
    for name, sort, mode, track in modes:
        d_k, t_k, max_sup = tiled.rasterize_direct(
            setup, WIDTH, HEIGHT, cam.zn, cam.zf, depth_mode=mode,
            track_ids=track, spatial_sort=sort)
        d_p, t_p = rasterize_brute(setup, WIDTH, HEIGHT, cam.zn, cam.zf,
                                   depth_mode=mode)
        torch.cuda.synchronize()
        err = float((d_k - d_p).abs().max())
        depth_mis = int((d_k != d_p).sum())
        tid_mis = int((t_k != t_p).sum()) if track else 0
        covered = int((t_p >= 0).sum())
        log(f"B1 [{name}]: depth mismatches {depth_mis}, max abs {err}, "
            f"tid mismatches {tid_mis} of {covered} covered, "
            f"max supers/tile {int(max_sup)}")
        check(depth_mis == 0, f"B1 {name}: depth differs from plain")
        check(tid_mis == 0, f"B1 {name}: tids differ from plain")
        if result is None:
            result = {"max_abs_err": err, "max_sup": int(max_sup),
                      "covered": covered}

    # Timing at the main-path mode: the wrapper (list building + kernel),
    # the kernel alone on prebuilt lists, and the plain version.
    run = lambda: tiled.rasterize_direct(  # noqa: E731
        setup, WIDTH, HEIGHT, cam.zn, cam.zf, spatial_sort=True)
    run()
    ms = cuda_ms(run, 20)
    rec, ss, n_pad = tiled.pack_direct_records(setup, True)
    cbb = tiled._chunk_bboxes(ss, n_pad, 16)
    sl, cnt, _ = tiled._super_lists(cbb, 16, -(-WIDTH // 128),
                                    -(-HEIGHT // 128), 128, 128)
    d0 = torch.ones((HEIGHT, WIDTH), dtype=torch.float32, device=dev)
    t0 = torch.full((HEIGHT, WIDTH), -1, dtype=torch.int32, device=dev)
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kern = lambda: tiled._direct_launch(  # noqa: E731
        lib, rec, cbb, sl, cnt, d0, t0, WIDTH, HEIGHT, cam.zn, cam.zf, 0,
        True, True, stream)
    kern()
    kernel_ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(lambda: rasterize_brute(setup, WIDTH, HEIGHT, cam.zn,
                                               cam.zf), 2)
    log(f"B1 time: wrapper {ms:.3f} ms, kernel alone {kernel_ms:.3f} ms, "
        f"plain (rasterize_brute) {plain_ms:.3f} ms")
    result.update(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms)
    return result


def mixed_lights(dev, n=64, seed=7):
    """Point / spot / rect / tube lights with mixed attenuation (seeded)."""
    from lsr_tpu_torch.lighting.light_types import LightSetBuilder

    rng = np.random.default_rng(seed)
    b = LightSetBuilder()
    for i in range(n):
        p = tuple(rng.uniform([-7, 0.2, -7], [7, 2.5, 7]).tolist())
        c = tuple(rng.uniform(0.2, 1.0, 3).tolist())
        k = i % 4
        if k == 0:
            b.spot(p, (0, -1, 0), color=c, intensity=2.0, range=3.5)
        elif k == 1:
            b.point(p, color=c, intensity=1.5, range=2.5,
                    atten_model=i % 3, atten_power=1.0 + 0.5 * (i % 2))
        elif k == 2:
            b.rect_area(p, (0, -1, 0), color=c, intensity=1.5, range=3.0)
        else:
            b.tube_area(p, axis=(1, 0, 0), color=c, intensity=1.5, range=3.0)
    return b.build(dev)


def b2_phase(gb, ctx_t, lights, cam, dev):
    """Kernel B2 against shade_fused_plain on the card."""
    from lsr_tpu_torch.lighting import shade_kernel as sk
    from lsr_tpu_torch.lighting.light_culling import (
        tile_depth_ranges_from_buffer)
    from lsr_tpu_torch.shading.common import (
        gather_materials, sample_texture_bilinear)
    from lsr_tpu_torch.shading.models import _norm
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    base, metal, rough, _, _, tex_id = gather_materials(
        ctx_t.materials, gb.obj_id, mat_rec=gb.mat)
    albedo = torch.clamp(base * sample_texture_bilinear(
        ctx_t.textures, tex_id, gb.uv, quads=ctx_t.texture_quads), min=0.0)
    tdr = tile_depth_ranges_from_buffer(gb.depth01, cam.zn, cam.zf, WIDTH,
                                        HEIGHT, 128, tile_h=64)

    def args(light_set, model):
        return (gb.world_pos, _norm(gb.normal_ws), gb.covered, albedo,
                metal[..., 0], rough[..., 0], torch.ones_like(gb.depth01),
                ctx_t.camera_pos, ctx_t.light_dir_ws,
                ctx_t.light_color * ctx_t.light_intensity, light_set,
                cam.view, cam.proj, WIDTH, HEIGHT, 64, 128, 256, 8, tdr, model)

    worst = 0.0
    for lname, light_set in (("flagship", lights), ("mixed", mixed_lights(dev))):
        for model in sk.SUN_MODELS:
            lit_k, stats = sk.shade_fused(*args(light_set, model))
            lit_p, _ = sk.shade_fused_plain(*args(light_set, model))
            torch.cuda.synchronize()
            err = float((lit_k - lit_p).abs().max())
            finite = bool(torch.isfinite(lit_k).all())
            log(f"B2 [{lname}, {model}]: max abs {err:.3g} (tol {B2_TOL}), "
                f"max |lit| {float(lit_p.abs().max()):.4g}, max lights/bin "
                f"{int(stats['max_count'])}, finite {finite}")
            check(finite and err <= B2_TOL, f"B2 {lname} {model} differs")
            if lname == "flagship" and model == "pbr_mr":
                worst = err

    run = lambda: sk.shade_fused(*args(lights, "pbr_mr"))  # noqa: E731
    ms = cuda_ms(run, 20)
    gbuf, trec, cnts, uni, _, _ = sk._prepare(
        *args(lights, "pbr_mr"), None, None, None, 0)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kern = lambda: sk._shade_launch(  # noqa: E731
        lib, gbuf, trec, cnts, uni, WIDTH, HEIGHT, "pbr_mr", lights.apow1,
        stream)
    kern()
    kernel_ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(lambda: sk.shade_fused_plain(*args(lights, "pbr_mr")),
                       2)
    log(f"B2 time: wrapper {ms:.3f} ms, kernel alone {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return {"max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms}


def small_reference(dev):
    """The same scene through the plain versions on the CPU and through the
    kernels on the card, at a small size.  The two sides build their own
    setups (matmul order differs), so a few edge pixels may pick another
    triangle; FXAA's luma decisions can amplify a 1-LSB tonemap difference,
    so the final LDR is held at 99.5% and the tonemapped LDR at 99.9%."""
    from lsr_tpu_torch.frame import (
        build_flagship_scene, flagship_camera, flagship_stages)
    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.tonemap import tonemap_pass

    out = {}
    for d in ("cpu", dev):
        geom, objects, lights, ctx = build_flagship_scene(N_LIGHTS, SEED,
                                                          device=d)
        cam, ctx_t = flagship_camera(0, ctx, SMALL_W, SMALL_H, device=d)
        st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, SMALL_W,
                             SMALL_H)
        tm = tonemap_pass(st["hdr"])
        out[str(d)] = (st["tid"].cpu(), st["hdr"].cpu(), tm.cpu(),
                       fxaa_pass(tm).cpu())
    (t_c, h_c, m_c, l_c), (t_g, h_g, m_g, l_g) = out["cpu"], out[str(dev)]
    same = t_c == t_g

    def within_1(a, b):
        return float(((a.int() - b.int()).abs().amax(-1) <= 1).float().mean())

    hdr_err = (h_c - h_g).abs().amax(-1)
    tid_mis = float((~same).float().mean())
    hdr_ok = float((hdr_err[same] <= 1e-4).float().mean())
    tm_ok, ldr_ok = within_1(m_c, m_g), within_1(l_c, l_g)
    log(f"small reference {SMALL_W}x{SMALL_H} (CPU plain vs card kernels): "
        f"tid mismatch {tid_mis:.4%}, HDR within 1e-4 on {hdr_ok:.4%} of "
        f"agreeing pixels (max {float(hdr_err[same].max()):.3g}), within "
        f"1 LSB: tonemapped {tm_ok:.4%}, after FXAA {ldr_ok:.4%}")
    check(tid_mis <= 0.005, "small reference: too many tid mismatches")
    check(hdr_ok >= 0.999 and tm_ok >= 0.999 and ldr_ok >= 0.995,
          "small reference differs")


def reset_counts():
    from lsr_tpu_torch.lighting.shade_kernel import shade_fused
    from lsr_tpu_torch.raster import tiled

    for fn in (tiled.rasterize_direct, tiled.rasterize_tiled,
               tiled.rasterize_chunklist, shade_fused):
        fn.launches = 0


def read_counts():
    from lsr_tpu_torch.lighting.shade_kernel import shade_fused
    from lsr_tpu_torch.raster import tiled

    return {"direct_raster": tiled.rasterize_direct.launches,
            "tiled_raster": tiled.rasterize_tiled.launches,
            "chunklist_raster": tiled.rasterize_chunklist.launches,
            "shade_fused": shade_fused.launches}


def targets(w, h, dev):
    from lsr_tpu_torch.raster.tiled import _targets

    return _targets(None, None, h, w, dev)


def stray(tid, bbox):
    """(H, W) bool: the pixel's winner is a triangle whose bbox does not
    hold the pixel.  The f32 edge functions of a sliver triangle can cover
    such pixels; lsr_tpu's kernels, like the port's, evaluate a triangle
    only where their own culling grain lets them, so different raster
    routes keep different ones of these pixels (ROADMAP C8)."""
    h, w = tid.shape
    b = bbox[torch.clamp(tid, min=0).to(torch.int64)]
    x = torch.arange(w, device=tid.device)[None, :]
    y = torch.arange(h, device=tid.device)[:, None]
    inside = ((b[..., 0] <= x) & (x <= b[..., 2]) & (b[..., 1] <= y)
              & (y <= b[..., 3]))
    return (tid >= 0) & ~inside


def same_but_strays(name, d_a, t_a, bbox_a, d_b, t_b, bbox_b, same_ids):
    """Two rasters of the same triangles: every pixel where they differ
    must have a stray winner on one side (see stray); on all other pixels
    coverage (tids when same_ids) and depth must be equal bit for bit."""
    s = stray(t_a, bbox_a) | stray(t_b, bbox_b)
    diff = (t_a != t_b) if same_ids else ((t_a >= 0) != (t_b >= 0))
    diff |= d_a != d_b
    n_diff, n_other = int(diff.sum()), int((diff & ~s).sum())
    log(f"{name}: {n_diff} px differ, all but {n_other} with a stray sliver "
        f"winner ({int(s.sum())} stray px in either); max |depth diff| "
        f"{float((d_a - d_b).abs().max())}, off the stray px "
        f"{float((d_a - d_b).abs()[~s].max())}")
    check(n_other == 0, f"{name}: {n_other} px differ without a stray "
          "winner")
    return n_diff


def _vs_plain(name, kern, plain, track=True):
    """Run a wrapper on the card, then its plain version on the same inputs;
    depth (and tid when tracked) must be equal bit for bit.  Returns (max
    abs depth error, plain ms)."""
    dk, tk, extra = kern()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    dp, tp = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_start) * 1e3
    depth_mis = int((dk != dp).sum())
    tid_mis = int((tk != tp).sum()) if track else 0
    err = float((dk - dp).abs().max())
    log(f"{name} [{extra}]: depth mismatches {depth_mis}, max abs {err}, "
        f"tid mismatches {tid_mis} of {int((tp >= 0).sum())} covered; plain "
        f"{plain_ms:.1f} ms")
    check(depth_mis == 0 and tid_mis == 0, f"{name} differs from plain")
    return err, plain_ms


def _b3_vs_plain(name, setup, w, h, zn, zf, tile_h, chunk, cap, fit_cap,
                 d0, t0):
    from lsr_tpu_torch.raster import tiled

    def kern():
        d, t, max_bin = tiled.rasterize_tiled(
            setup, w, h, zn, zf, tile_h=tile_h, cap=cap, chunk=chunk,
            fit_cap=fit_cap)
        used = tiled.fitted_cap(cap, int(max_bin)) if fit_cap else cap
        return d, t, f"max_bin {int(max_bin)}, cap {used}"

    def plain():
        rec, lists, n_walk, _ = tiled.tiled_inputs(
            setup, w, h, tile_h, 128, cap, chunk, fit_cap=fit_cap)
        return tiled.rasterize_tiled_plain(rec, lists, n_walk, d0, t0, w, h,
                                           zn, zf, tile_h=tile_h, chunk=chunk)

    return _vs_plain(f"B3 {name}", kern, plain)


def _b4_vs_plain(name, setup, w, h, zn, zf, mode, track, y_off, full_h):
    from lsr_tpu_torch.raster import tiled

    hb = h - y_off
    db, tb = targets(w, hb, setup.coef.device)

    def kern():
        d, t, mc = tiled.rasterize_chunklist(
            setup, w, hb, zn, zf, depth_mode=mode, y_offset=y_off,
            full_height=full_h, track_ids=track)
        return d, t, f"max chunks/tile {int(mc)}"

    def plain():
        rec, cl, cc, _ = tiled.chunklist_inputs(setup, w, hb, 128, 128, 16,
                                                None, 32, y_off)
        return tiled.rasterize_chunklist_plain(
            rec, cl, cc, db, tb, w, hb, zn, zf, mode, y_offset=y_off,
            full_height=full_h, track_ids=track)

    return _vs_plain(f"B4 {name}", kern, plain, track)


def b3_b4_small_phase(geom, objects, ctx, dev):
    """B3 and B4 wrappers against their plain versions on the same lists in
    the modes the 1080p main path does not run, at 480x270."""
    from lsr_tpu_torch.highpoly import compact_setup, highpoly_camera
    from lsr_tpu_torch.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ

    w, h = PLAIN_W, PLAIN_H
    cam, _ = highpoly_camera(ctx, w, h, HP_GRID, device=dev)
    setup, cst = compact_setup(geom, objects, cam, w, h)
    check(not bool(cst.overflow), "480x270 compact setup overflowed")
    log(f"B3/B4 vs plain, extra modes at {w}x{h} (the same compact setup "
        f"geometry, {setup.count} rows): n_direct {int(cst.n_direct)}, "
        f"n_clip {int(cst.n_clip)}")
    d0, t0 = targets(w, h, dev)
    _b3_vs_plain("render_forward 32x128 chunk 8", setup, w, h, cam.zn,
                 cam.zf, 32, 8, 1024, True, d0, t0)
    _b4_vs_plain("ndc01, depth only", setup, w, h, cam.zn, cam.zf,
                 DEPTH_NDC01, False, 0, h)
    _b4_vs_plain("viewz, ids, y_offset half band", setup, w, h, cam.zn,
                 cam.zf, DEPTH_VIEWZ, True, h // 2, h)


def raster_1080p_phase(geom, objects, cam, dev):
    """On the 1080p compact setup: B3 and B4 wrappers against their plain
    versions on the same lists at the main path's shapes (and B3 under a
    cap that truncates); B1 (unsorted), B3 and B4 against each other;
    kernel and wrapper times.  Returns {kernel: {max_abs_err, plain_ms, ms,
    kernel_ms}}."""
    from lsr_tpu_torch.highpoly import compact_setup
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.setup import DEPTH_VIEWZ
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    setup, cst = compact_setup(geom, objects, cam, WIDTH, HEIGHT)
    check(not bool(cst.overflow), "1080p compact setup overflowed")
    zn, zf = cam.zn, cam.zf
    d0, t0 = targets(WIDTH, HEIGHT, dev)
    out = {}
    err, plain_ms = _b3_vs_plain("_raster 64x128 chunk 16, fitted cap",
                                 setup, WIDTH, HEIGHT, zn, zf, 64, 16, 1024,
                                 True, d0, t0)
    out["tiled_raster"] = {"max_abs_err": err, "plain_ms": plain_ms}
    _, _, max_bin = tiled.bin_triangles(setup, WIDTH, HEIGHT, 64, 128, 1)
    cap = tiled.fitted_cap(1024, int(max_bin))
    _b3_vs_plain("64x128 chunk 16, cap below max_bin", setup, WIDTH, HEIGHT,
                 zn, zf, 64, 16, cap // 2, False, d0, t0)
    err, plain_ms = _b4_vs_plain("viewz, ids", setup, WIDTH, HEIGHT, zn, zf,
                                 DEPTH_VIEWZ, True, 0, HEIGHT)
    out["chunklist_raster"] = {"max_abs_err": err, "plain_ms": plain_ms}

    # B1, B3 and B4 apply the same first-submitted rule over the same rows,
    # but each evaluates a triangle only where its own culling grain lets
    # it (B1 16x16 blocks, B3 64x128 tiles, B4 tile row bands): they may
    # differ only on stray sliver pixels.
    runs = {
        "direct_raster": lambda: tiled.rasterize_direct(
            setup, WIDTH, HEIGHT, zn, zf),
        "tiled_raster": lambda: tiled.rasterize_tiled(
            setup, WIDTH, HEIGHT, zn, zf, tile_h=64, cap=1024, chunk=16,
            fit_cap=True),
        "chunklist_raster": lambda: tiled.rasterize_chunklist(
            setup, WIDTH, HEIGHT, zn, zf),
    }
    res = {k: fn() for k, fn in runs.items()}
    torch.cuda.synchronize()
    d1, t1, max_sup = res["direct_raster"]
    log(f"cross-kernel 1080p: {int((t1 >= 0).sum())} px covered by B1")
    for k in ("tiled_raster", "chunklist_raster"):
        same_but_strays(f"cross-kernel 1080p, {k} vs direct_raster",
                        res[k][0], res[k][1], setup.bbox, d1, t1, setup.bbox,
                        True)
    max_cnt = int(res["chunklist_raster"][2])
    log(f"1080p compact setup: {setup.count} rows ({int(setup.valid.sum())} "
        f"valid, n_direct {int(cst.n_direct)} / cap {cst.cap_direct}, n_clip "
        f"{int(cst.n_clip)} / cap {cst.cap_clip}); max_bin {int(max_bin)}, "
        f"cap used {cap}, max_chunks_per_tile {max_cnt}, "
        f"max_supers_per_tile {int(max_sup)}")
    del res

    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rec, ss, n_pad = tiled.pack_direct_records(setup, False)
    cbb = tiled._chunk_bboxes(ss, n_pad, 16)
    sl, scnt, _ = tiled._super_lists(cbb, 16, 15, 9, 128, 128)
    _, lists, n_walk, _ = tiled.tiled_inputs(setup, WIDTH, HEIGHT, 64, 128,
                                             1024, 16, fit_cap=True)
    _, cl, cc, _ = tiled.chunklist_inputs(setup, WIDTH, HEIGHT, 128, 128, 16,
                                          None, 32)
    kerns = {
        "direct_raster": lambda: tiled._direct_launch(
            lib, rec, cbb, sl, scnt, d0, t0, WIDTH, HEIGHT, zn, zf, 0, True,
            False, stream),
        "tiled_raster": lambda: tiled._tiled_launch(
            lib, rec, lists, n_walk, d0, t0, WIDTH, HEIGHT, zn, zf, 0, 64,
            128, 0, HEIGHT, stream),
        "chunklist_raster": lambda: tiled._chunklist_launch(
            lib, rec, cl, cc, d0, t0, WIDTH, HEIGHT, zn, zf, 0, 128, 128, 16,
            32, 0, HEIGHT, True, stream),
    }
    for k in runs:
        kerns[k]()
        kernel_ms = cuda_ms(kerns[k], 5)
        runs[k]()
        ms = cuda_ms(runs[k], 5)
        out.setdefault(k, {}).update(ms=ms, kernel_ms=kernel_ms)
        log(f"{k} on the 1080p compact setup: wrapper {ms:.3f} ms, kernel "
            f"alone {kernel_ms:.3f} ms")
    return out


def highpoly_frame_phase(geom, objects, lights, ctx, dev):
    """The main path of the high-poly slice; returns (launches, median ms)."""
    from lsr_tpu_torch.highpoly import (
        highpoly_camera, highpoly_frame_params, make_highpoly_frame)
    from lsr_tpu_torch.io.png import write_png

    cam, ctx_t = highpoly_camera(ctx, WIDTH, HEIGHT, HP_GRID, device=dev)
    fp = highpoly_frame_params(WIDTH, HEIGHT)
    frame = make_highpoly_frame(geom, objects, lights, ctx, fp)
    reset_counts()
    ms = []
    for _ in range(HP_WARMUP + HP_FRAMES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ldr, st = frame(cam, ctx_t)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    launches = read_counts()
    rs = st["raster_stats"]
    n_valid = int(rs["tri_after_clip"])
    log(f"high-poly frame {WIDTH}x{HEIGHT}: {HP_FRAMES} frames after "
        f"{HP_WARMUP} warm-up, median {statistics.median(ms[HP_WARMUP:]):.3f} "
        f"ms/frame device events (all {[round(m, 3) for m in ms]}); "
        f"launches {launches}; tri_input {rs['tri_input']}, CompactStats "
        f"n_direct {int(rs['compact_n_direct'])}, n_clip "
        f"{int(rs['compact_n_clip'])}, overflow "
        f"{bool(rs['compact_overflow'])}; compact_fallback "
        f"{rs['compact_fallback']}, raster_max_bin "
        f"{int(rs['raster_max_bin'])}, raster_cap_used "
        f"{rs['raster_cap_used']}, n_valid {n_valid}")
    check(launches["tiled_raster"] > 0 and launches["shade_fused"] > 0,
          f"a kernel of the high-poly path never launched: {launches}")
    check(rs["raster_cap_used"] >= int(rs["raster_max_bin"]),
          "the high-poly frame dropped triangles past the list cap")
    check(not bool(rs["compact_overflow"]) or rs["compact_fallback"],
          "compact overflow left unhandled")
    check(ldr.shape == (HEIGHT, WIDTH, 3) and ldr.dtype == torch.uint8,
          f"bad high-poly frame {tuple(ldr.shape)} {ldr.dtype}")
    lit = float((ldr.int().sum(-1) > 0).float().mean())
    check(n_valid > 0 and lit > 0.5 and bool(torch.isfinite(st["hdr"]).all()),
          "high-poly frame is empty or not finite")
    write_png(os.path.join("out", "torch_highpoly.png"),
              ldr.cpu().numpy()[::-1])
    return launches, statistics.median(ms[HP_WARMUP:])


def e2e_phase(geom, objects, ctx, dev):
    """Compact setup + chunk-list raster (bench_highpoly.py:156-166)."""
    from lsr_tpu_torch.highpoly import e2e_compact_chunklist, highpoly_camera
    from lsr_tpu_torch.raster.setup import scene_setup
    from lsr_tpu_torch.raster.tiled import rasterize_chunklist

    cam, _ = highpoly_camera(ctx, WIDTH, HEIGHT, HP_GRID, device=dev)
    run = lambda: e2e_compact_chunklist(  # noqa: E731
        geom, objects, cam, WIDTH, HEIGHT)
    reset_counts()
    d_e, t_e, max_cnt, setup, cst = run()
    launches = read_counts()
    check(launches["chunklist_raster"] > 0,
          f"the end-to-end step never launched B4: {launches}")
    check(not bool(cst.overflow), "end-to-end compact setup overflowed")
    ms = cuda_ms(run, 5)
    full = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                       geom.vtx_obj, geom.tri_obj, objects.model,
                       objects.normal_mat, cam.viewproj, WIDTH, HEIGHT)
    d_f, t_f, _ = rasterize_chunklist(full, WIDTH, HEIGHT, cam.zn, cam.zf)
    cov_mis = int(((t_e >= 0) != (t_f >= 0)).sum())
    log(f"end to end (compact setup + chunklist) {WIDTH}x{HEIGHT}: "
        f"{ms:.3f} ms (CUDA events, mean of 5); launches {launches}; "
        f"max_chunks_per_tile {int(max_cnt)}, rows {setup.count} vs "
        f"{full.count} full; vs full-setup chunklist: coverage mismatches "
        f"{cov_mis}")
    # The two setups number their rows differently: coverage, not tids.
    same_but_strays("compact vs full setup, chunklist", d_e, t_e,
                    setup.bbox, d_f, t_f, full.bbox, False)
    return launches, ms


def render_forward_phase(dev):
    """render_forward through both raster routes, counts reset before each."""
    from lsr_tpu_torch.frame import build_flagship_scene, flagship_camera
    from lsr_tpu_torch.highpoly import build_highpoly_scene, highpoly_camera
    from lsr_tpu_torch.render import render_forward

    cols = ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")
    for name, scene, camera, kernel in (
            ("flagship", lambda: build_flagship_scene(N_LIGHTS, SEED,
                                                      device=dev),
             lambda ctx: flagship_camera(0, ctx, WIDTH, HEIGHT, device=dev),
             "direct_raster"),
            ("high-poly", lambda: build_highpoly_scene(HP_GRID, device=dev),
             lambda ctx: highpoly_camera(ctx, WIDTH, HEIGHT, HP_GRID,
                                         device=dev),
             "tiled_raster")):
        geom, objects, _, ctx = scene()
        cam, ctx_t = camera(ctx)
        batch = {k: getattr(geom, k) for k in cols}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ldr, gb = render_forward(batch, objects.model, objects.normal_mat,
                                 cam.viewproj, cam.zn, cam.zf, ctx_t, WIDTH,
                                 HEIGHT, model_name="pbr_mr")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        covered = int((gb.tri_id >= 0).sum())
        log(f"render_forward [{name}]: {wall:.1f} ms wall (first call), "
            f"launches {launches}, covered {covered} px")
        check(launches[kernel] > 0, f"render_forward {name} never launched "
              f"{kernel}: {launches}")
        check(ldr.shape == (HEIGHT, WIDTH, 3) and ldr.dtype == torch.uint8
              and covered > 0 and int(ldr.int().sum()) > 0,
              f"render_forward {name}: empty frame")
        del geom, objects, gb, ldr


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    from lsr_tpu_torch.frame import (
        build_flagship_scene, flagship_camera, flagship_stages,
        make_flagship_frame)
    from lsr_tpu_torch.highpoly import build_highpoly_scene, highpoly_camera
    from lsr_tpu_torch.io.png import write_png
    from lsr_tpu_torch.utils.cuda_build import build_info, load_kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    load_kernels()
    log(f"# kernel library {'built' if build_info['built'] else 'reused'} "
        f"in {build_info['seconds']:.1f} s (one nvcc per source, in "
        f"parallel, then a link): {build_info['path']}")
    for line in build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"#   ptxas: {line.strip()}")

    geom, objects, lights, ctx = build_flagship_scene(N_LIGHTS, SEED,
                                                      device=dev)
    frame = make_flagship_frame(geom, objects, lights, ctx, WIDTH, HEIGHT)
    cams = [flagship_camera(i, ctx, WIDTH, HEIGHT, device=dev)
            for i in range(WARMUP + FRAMES)]
    log(f"# scene: {geom.indices.shape[0]} triangles, {lights.count} lights "
        f"(kinds {lights.kinds}, apow1 {lights.apow1}), {WIDTH}x{HEIGHT}")

    cam0, ctx0 = cams[0]
    st = flagship_stages(geom, objects, lights, ctx, cam0, ctx0, WIDTH, HEIGHT)
    check(bool(torch.isfinite(st["hdr"]).all()), "frame 0 HDR not finite")
    b1 = b1_phase(st["setup"], cam0, dev)
    b2 = b2_phase(st["gb"], ctx0, lights, cam0, dev)
    small_reference(dev)

    # Main path: counts from zero, a few frames through the entry point.
    reset_counts()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in cams]
    wall = []
    torch.cuda.synchronize()
    for (cam, ctx_i), (e0, e1) in zip(cams, ev):
        t0 = time.perf_counter()
        e0.record()
        out = frame(cam, ctx_i)
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    # The same frames again without a sync between them (the bench's
    # async-dispatch throughput).
    t0 = time.perf_counter()
    for cam, ctx_i in cams[WARMUP:]:
        out = frame(cam, ctx_i)
    torch.cuda.synchronize()
    pipelined = (time.perf_counter() - t0) * 1e3 / FRAMES
    launches = read_counts()
    ms = [e0.elapsed_time(e1) for e0, e1 in ev][WARMUP:]
    ldr, n_valid, max_sup, max_lights, overflow = out
    check(launches["direct_raster"] > 0 and launches["shade_fused"] > 0,
          f"a kernel of the main path never launched: {launches}")
    check(ldr.shape == (HEIGHT, WIDTH, 3) and ldr.dtype == torch.uint8,
          f"bad frame {tuple(ldr.shape)} {ldr.dtype}")
    lit_frac = float((ldr.int().sum(-1) > 0).float().mean())
    check(int(n_valid) > 0 and lit_frac > 0.5, "frame is empty")
    log(f"main path: {FRAMES} frames after {WARMUP} warm-up, median "
        f"{statistics.median(ms):.3f} ms/frame device events "
        f"(min {min(ms):.3f}, max {max(ms):.3f}), median wall "
        f"{statistics.median(wall[WARMUP:]):.3f} ms, pipelined "
        f"{pipelined:.3f} ms/frame; launches {launches}; "
        f"n_valid {int(n_valid)}, max_sup {int(max_sup)}, "
        f"max_lights_per_bin {int(max_lights)}, overflow_bins "
        f"{int(overflow)}")
    os.makedirs("out", exist_ok=True)
    write_png(os.path.join("out", "torch_flagship.png"),
              ldr.cpu().numpy()[::-1])   # canvas row 0 is the bottom row
    del geom, objects, frame, st, out, ldr

    # The high-poly path.
    t_scene = time.perf_counter()
    hp_geom, hp_objects, hp_lights, hp_ctx = build_highpoly_scene(
        HP_GRID, device=dev)
    log(f"# high-poly scene: {hp_geom.indices.shape[0]} triangles, "
        f"{hp_objects.model.shape[0]} objects, built in "
        f"{time.perf_counter() - t_scene:.1f} s")
    b3_b4_small_phase(hp_geom, hp_objects, hp_ctx, dev)
    hp_cam, _ = highpoly_camera(hp_ctx, WIDTH, HEIGHT, HP_GRID, device=dev)
    r1080 = raster_1080p_phase(hp_geom, hp_objects, hp_cam, dev)
    hp_launches, hp_ms = highpoly_frame_phase(hp_geom, hp_objects, hp_lights,
                                              hp_ctx, dev)
    e2e_launches, e2e_ms = e2e_phase(hp_geom, hp_objects, hp_ctx, dev)
    del hp_geom, hp_objects
    render_forward_phase(dev)
    log(f"summary: flagship frame {statistics.median(ms):.3f} ms, high-poly "
        f"frame {hp_ms:.3f} ms, end to end compact + chunklist {e2e_ms:.3f} "
        f"ms ({card})")

    at_1080p = f"{WIDTH}x{HEIGHT} high-poly compact setup"
    kernels = [
        {"name": "direct_raster", "route": "cuda",
         "source": "lsr_tpu_torch/csrc/direct_raster.cu",
         "replaces": "lsr_tpu/raster/tiled.py:289",
         "launches": launches["direct_raster"],
         "max_abs_err": b1["max_abs_err"], "ms": b1["ms"],
         "plain_ms": b1["plain_ms"]},
        {"name": "shade_fused", "route": "cuda",
         "source": "lsr_tpu_torch/csrc/shade_fused.cu",
         "replaces": "lsr_tpu/lighting/shade_kernel.py:40",
         "launches": launches["shade_fused"],
         "max_abs_err": b2["max_abs_err"], "ms": b2["ms"],
         "plain_ms": b2["plain_ms"]},
        {"name": "tiled_raster", "route": "cuda",
         "source": "lsr_tpu_torch/csrc/tiled_raster.cu",
         "replaces": "lsr_tpu/raster/tiled.py:125",
         "launches": hp_launches["tiled_raster"],
         "max_abs_err": r1080["tiled_raster"]["max_abs_err"],
         "ms": r1080["tiled_raster"]["ms"],
         "kernel_ms": r1080["tiled_raster"]["kernel_ms"],
         "plain_ms": r1080["tiled_raster"]["plain_ms"], "at": at_1080p},
        {"name": "chunklist_raster", "route": "cuda",
         "source": "lsr_tpu_torch/csrc/chunklist_raster.cu",
         "replaces": "lsr_tpu/raster/tiled.py:697",
         "launches": e2e_launches["chunklist_raster"],
         "max_abs_err": r1080["chunklist_raster"]["max_abs_err"],
         "ms": r1080["chunklist_raster"]["ms"],
         "kernel_ms": r1080["chunklist_raster"]["kernel_ms"],
         "plain_ms": r1080["chunklist_raster"]["plain_ms"], "at": at_1080p},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
