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
    from lsr_tpu_torch.io.png import write_png
    from lsr_tpu_torch.lighting.shade_kernel import shade_fused
    from lsr_tpu_torch.raster.tiled import rasterize_direct
    from lsr_tpu_torch.utils.cuda_build import build_info, load_kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    load_kernels()
    log(f"# kernels built in {build_info['seconds']:.1f} s: {build_info['path']}")
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
    rasterize_direct.launches = 0
    shade_fused.launches = 0
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
    launches = {"direct_raster": rasterize_direct.launches,
                "shade_fused": shade_fused.launches}
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
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
