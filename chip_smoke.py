#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lsr_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --phase30    # phase 30 alone, after the build
    python3 chip_smoke.py --phase31    # phase 31 alone, after the build
    python3 chip_smoke.py --phase32    # phase 32 alone, after the build
    python3 chip_smoke.py --phase33    # phase 33 alone, after the build
    python3 chip_smoke.py --phase34    # phase 34 alone, after the build
    python3 chip_smoke.py --phase35    # phases 34 and 35, after the build
    python3 chip_smoke.py --phase36    # phase 36 alone, after the build

It builds the hand-written CUDA kernels from lsr_tpu_torch/csrc/ (nvcc, at
first use, into build/kernels/), then:

1. B1 (rasterize_direct) at the flagship shapes: the kernel against its
   plain version (rasterize_brute) on the card, in each supported mode and
   over given targets.  Depth must match bit for bit and tids exactly.
   Counts what its walk tests before and after the per-triangle cull.
2. B2 (shade_fused) at the flagship shapes: the kernel against its plain
   version on the card, pbr_mr and blinn_phong, on the flagship light set and
   on a mixed set with rect and tube lights.  Lit rgb within 1e-4.  Counts
   what its light walk meets and what the box test and the vote leave.
3. A small-input reference: the same scene with a 256^2 ESM sun map,
   rendered by the plain versions on the CPU and by the kernels on the card,
   at 192x108 (the cut frame: no cull, no local atlas).
4. The main path: bench.py's whole flagship frame (make_flagship_frame:
   per-frame cull of objects and lights, the 8-spot + 2-point local shadow
   atlas, the sun map, raster, forward+ with local-shadow planes, tonemap,
   FXAA) as one program, jit(make_flagship_frame(...)) as bench.py:344
   jits it (utils.jit: the first frame warms up, the second is captured
   into a CUDA graph, later frames replay it), at 1920x1080 with 256
   lights along the bench orbit, counts reset
   before each configuration: (a) bench.py's ESM default (sun 1024^2, spot
   slots 512^2, cube faces 256^2, planes and sun visibility at half
   resolution), B2 route, "map" atlas, writing out/torch_flagship.png; (b)
   the same with the "packed" atlas; (c) the ESM default on the resolve
   route (out/torch_flagship_resolve.png); (d) the exact-PCF control (2048^2
   / 1024^2 / 512^2, full resolution), B2 route.  Median device-event and
   wall ms per frame, pipelined ms, the launches checked exactly (B1 3 + 20
   a frame under "map", 3 + 2 under "packed", one B2 or B5), the visible
   objects and lights per frame.

31. One-program frames (right after phase 4): each path through
    lsr_tpu_torch.utils.jit, the port's jax.jit, captured once into a CUDA
    graph and replayed, against its eager frame.  bench.py's whole frame in
    the four configurations of phase 4 (the staged orbit's camera 0 warms
    up, then captures; four later cameras replay); cameras with another
    zn / zf (data: they replay the same graph); execute_jitted on the five
    presets, forward_plus+full and forward_classic+ssao at 1280x720 and
    Config #5 at 800x600 (frames 0 and 1 warm up two keys, frame 2
    captures; TAA's history flows through the graph's inputs) against
    execute on the same states; a function that reads a tensor on the host
    must fail to capture.  Per path: each replay's launches equal the eager
    frame's, its outputs equal the eager frame's bit for bit (or lie within
    the eager frame's spread against itself), one capture; replay and
    eager ms by CUDA events [min, max], pipelined ms, capture ms, the
    graph's memory, torch.profiler's device busy share of one replay and of
    one eager frame.  `python3 chip_smoke.py --phase31` runs it alone.

Then the high-poly path, on the 33x33 sphere field (1,115,136 triangles,
lsr_tpu_torch.highpoly):

5. Extra modes of B3 (rasterize_tiled) and B4 (rasterize_chunklist) at
   480x270 on the compact setup of the same scene: each wrapper against its
   plain version on the same lists, B3 at render_forward's 32x128 / chunk 8,
   B4 in NDC01 depth only, on a y_offset half band, and at 32x128 tiles with
   8-row bands, chunks of 8 and a worklist cap that truncates.  Depth and
   tid bit for bit.
6. The raster at 1920x1080 on the compact setup: B3 at the pipeline's
   64x128 / chunk 16 with the fitted cap, B3 with a cap below the largest
   bin, and B4 at 128x128 / sub_h 32, each wrapper against its plain version
   on the same lists, bit for bit.  Then B1 (unsorted), B3 and B4 against
   each other: a pixel may differ only where a winner is "stray", a sliver
   triangle whose f32 edge functions cover a pixel outside its bbox, which
   each kernel's culling grain keeps or skips; everywhere else depth and
   tid are equal bit for bit.  Times each kernel alone on prebuilt lists
   and each wrapper (CUDA events).  Counts, from the lists and the plain
   model of the kernels' block cull run on the card, what B3 and B4 walk:
   the (triangle, pixel) pairs of the design without the cull, the pairs
   left after it, the pairs inside valid bboxes, the entries per tile and
   the survivors per 16x16 block.
7. The high-poly forward+ frame (make_highpoly_frame) at 1920x1080, counts
   reset: compact setup -> B3 -> interp -> B2 -> tonemap -> FXAA; no
   triangle may be dropped.  Writes out/torch_highpoly.png.
8. The bench's end-to-end step, compact setup + B4, counts reset: against
   the chunk-list raster of the full setup, coverage and depth equal on
   every pixel but stray sliver ones (as in phase 6).
9. render_forward on the flagship scene (B1 route) and on the high-poly
   scene (B3 route), counts reset before each.
32. The high-poly route as one program (right after phase 14's high-poly
    part): render_forward at 1920x1080 on B1 (flagship scene, staged orbit
    cameras) and on B3 (the high-poly scene), make_highpoly_frame and
    e2e_compact_chunklist, each through utils.capacity's checked wrapper
    (capacities known before the frame in place of the eager route's
    mid-frame host reads; the first call sizes them), captured once into
    a CUDA graph and replayed at the bench view turned by 0.03-0.09 rad,
    with phase 31's checks and numbers: launches exact (B3 one a
    high-poly frame, B4 one a step, B2 one, B1 one), every replay bit for
    bit its eager frame at the same capacities, one capture a capacity
    set.  The overflow drill: a camera whose largest bin exceeds the
    captured list width sets the flag; the frame is redone eagerly, equal
    to the eager fitted frame bit for bit, the stale graph released and a
    recapture follows.  The C23 drill: ten (zn, zf) pairs through
    render_forward, data to one graph: one capture, no eviction, every
    frame bit for bit its eager frame.  The bound drill: ten target widths
    (still keys) through render_forward: never more than
    utils.jit.MAX_GRAPHS graphs, the evictions counted, the memory
    returned on release.  `python3 chip_smoke.py --phase32` runs it
    alone.

Then the slice of the sun shadow, B5 and B6, on the flagship scene:

10. The 2048^2 sun map: B1 in NDC01 depth-only mode against rasterize_brute
    on the card, bit for bit, with the counts of its walk; then phase 3's
    ESM soft map and sun visibility, card against CPU, on the same map and
    receivers.
11. B5 (resolve_fused) at 1920x1080: the kernel against resolve_fused_plain
    on the card, pbr_mr and blinn_phong, flagship and mixed lights, 8- and
    16-light chunks; HDR within 1e-4, and how many values differ at all.
    Counts the (pixel, light) pairs its walk meets, the binned and the live
    ones, the lights a vote per warp rectangle, pixel row or block would
    keep, and the pairs left after the box test and the vote.
12. B6 (accumulate_lights) at 1920x1080 on the flagship G-buffer, 64x128
    and 16x128 tiles: the kernel against its plain version; diffuse and
    specular within 1e-4.  Then its entry point once, counts reset; each
    configuration's kernel time and the counts of its light walk.
13. The cut resolve frame (no cull, no atlas, 2048^2 ESM sun map) at
    1920x1080, counts reset: two direct_raster launches and one
    resolve_fused launch per frame, median and pipelined ms per frame, and
    its HDR against the B2 route's on the same camera (lsr_tpu's bar: mean
    |dHDR| < 5e-3, < 1% of pixels over 0.05).

Then the whole frame's kernel branches:

15. The atlas on the card against the plain versions, bit for bit, in the
    ESM default: B1 on the 320x180 occluders (view-z, depth only), on the
    busiest spot slot and cube face (NDC01), B1a (band_h) on both stacks
    (and against one launch a slot); kernel F1 (the "map" atlas's front
    end) against its plain version on both stacks, bit for bit, and its ms;
    the "packed" atlas against the "map" atlas, whole-table equal, for both
    filters at their sizes.
16. B2a and B5a (local-shadow planes) against their plain versions at
    1920x1080 with the ESM default frame's real planes, within 1e-4, and
    each kernel's time with and without the planes, in one call, with the
    counts of B2's light walk on that frame.
17. The card against the CPU on the whole frame: the grid-2 scene, 32
    lights, 192x108, ESM default with a 256^2 sun map and 128^2 slots and
    faces, cull and atlas, both routes, under phase 3's contract.

Then kernel B2's clustered branch and the render-path presets:

18. B2b (shade_fused with clustered slices) against its plain version at
    1920x1080 on the flagship ESM default frame (cull, atlas, its planes):
    16 log-Z slices, cap 256, planeless and with the planes, pbr_mr and
    blinn_phong, within 1e-4; the kernel's time with and without planes
    beside the tiled planeless B2 launch on the same G-buffer, and the
    counts of its slice walk (listed pairs, pairs after the box test and
    the vote, live pairs).
19. The render-path presets (forward_classic, forward_plus, deferred,
    tiled_deferred, clustered_forward) through
    render_paths.build_preset_pipelines at 1280x720, PCF (sun 2048^2, spot
    slots 1024^2, cube faces 512^2), each a main path of its own, counts
    reset before it: median ms per frame by CUDA events with [min, max],
    pipelined ms, exactly 3 + 20 B1 launches, F1 once a stack and one B2
    a frame, and execute_segmented's per-pass device ms; F1 against its
    plain version on the scene's 1024^2 and 512^2 stacks; the contact sheet
    out/torch_render_paths.png.
20. B2b against its plain version on clustered_forward's own launch at
    1280x720 (with its local-shadow planes), timed and counted as in 18.
21. Phase I's backend parity: each preset at 320x180 (slots 256^2, faces
    128^2), B1 against rasterize_brute for the camera, three frames: depth
    and tid equal off stray pixels (C8), LDR within 1 LSB on >= 99.9%.
22. The card against the CPU through the pipeline: each preset at 192x108
    (sun 256^2, slots and faces 128^2, 8 slices) under phase 3's contract.

Then lsr_tpu's compositions (each a main path of its own, counts reset):

23. Phase F's compositions at 1280x720 on the presets' workload (PCF, sun
    2048^2, slots 1024^2, faces 512^2): forward_plus under the "full" post
    stack (light shafts, motion blur, bloom, depth of field, TAA, FXAA) and
    forward_classic+ssao (lit by the general branch: the shading model and
    accumulate_local_lights), median ms per frame with [min, max],
    pipelined ms and execute_segmented's pass ms; launches exactly 3 + 20
    B1 a frame, one B2 a frame in forward_plus+full and none with SSAO;
    the SSAO composition's LDR differs from forward_classic's; B2 against
    its plain version on forward_plus+full's own launch.
24. Config #5 (lsr_tpu_torch.full_pipeline) at 800x600 with TAA on: the
    IBL baked on the card, then frames of the still camera with TAA's
    history carried: 2 B1 and one B2 a frame exactly, the moving object's
    velocity alone non-zero (a still object's is the float32 inverse's
    rounding, under 1e-3 px), pass ms; out/torch_full_pipeline.png; then
    the path's own launches against their plain versions: B2 (tile depth
    range), the 800x600 camera raster (B1 against rasterize_brute off
    stray sliver pixels) and the sun map (likewise).
25. Phase I-posts at 320x180: every preset and the SSAO composition under
    the minimal, default, temporal and full post stacks, the stacks'
    images distinct per path; then the card against the CPU at 192x108
    for forward_plus+full, forward_classic+ssao and Config #5 (phase 3's
    contract on the lighting pass's HDR; the final frame's HDR on >= 99.5%
    of agreeing pixels and its LDR within 1 LSB on >= 99.5%; an SSAO tap
    may flip only where the two sides' depths differ, and the card's SSAO
    on the CPU's depth gives the CPU's mask).

Then kernel B1's screen bands and the multi-device paths
(lsr_tpu_torch.parallel, every rank on this one card):

26. B1b (rasterize_direct with y_offset, full_height) on the flagship
    scene: the 1920x1080 camera view in four bands of 270 rows (y_offset
    0, 270, 540, 810; unsorted as the sharded paths call it, and sorted)
    and the bench's 2048^2 sun map in four bands of 512 rows (NDC01, depth
    only, spatial sort): each band against its plain version
    (rasterize_brute at the band's global rows) and the concatenated bands
    against B1's full-frame launch, depth and tid bit for bit; each band's
    kernel ms (on its own super lists), wrapper and plain ms and bound.
27. The sharded paths at 1920x1088 (four bands of whole 16-row light
    tiles), each the undecorated eager step (Jitted.fn), counts reset
    before each: make_sharded_flagship (2048^2 sun
    map, its other defaults, two cameras of the orbit) on meshes (1, 1),
    (1, 4), (2, 2), the frames of (1, 4) and (2, 2) equal (1, 1)'s bit for
    bit, B1 launches a step exactly 25 / 40 / 52 (of them B1b 0 / 12 / 8);
    make_sharded_render on (2, 2), each camera equal to render_band of the
    whole frame bit for bit; make_light_sharded_forward on (sp 2, lp 2)
    and (sp 1, lp 4) within 1 LSB of (1, 1) on under 2% of values;
    make_pipelined_render over 4 cameras, output i bit for bit camera
    i - 1's render_band.  Median ms a step of each mesh by CUDA events
    (its ranks run one after another on the card).  About 20-25 s for 26-27.
33. Right after 27: the same seven sharded configurations as one program
    each (parallel.sharding returns utils.jit.jit(step) on a one-device
    mesh, as lsr_tpu returns jax.jit(step)): warmed up and captured at
    cameras (0, 2), replayed at three later camera sets, every call bit
    for bit the undecorated eager step, B1 and B1b launches exact, one
    capture a step; replay and eager ms by CUDA events [min, max],
    pipelined ms, busy ms and kernels of one profiled replay, capture ms,
    graph MiB.  Then zn / zf as device data: ten (zn, zf) pairs through
    render_forward on B1, bench.py's whole ESM frame and the sharded
    flagship on (1, 4), one capture and no eviction each, every frame bit
    for bit its eager frame; B1 (four modes, given targets, B1a, B1b
    bands), B3 and B4 reading their z params from device memory against
    their plain versions bit for bit at three pairs, zn 0.25 / zf 40
    among them.  `python3 chip_smoke.py --phase33` runs it alone.
34. The planes' crop cascade (right after phase 33): kernels V1
    (lighting/vis_kernel.vis_windows, csrc/vis_footprint.cu: each plane's
    window and run flag) and V2 (vis_planes, csrc/vis_planes.cu: the
    planes inside their windows) for flagship (a) (ESM, planes at half
    resolution) and (d) (PCF, full), default cascade, 1920x1080: at every
    camera of the staged orbit V1's windows equal its plain version's
    exactly, the level each plane picks as a histogram; at camera 0 V2
    against its plain version (bit for bit, or within 1e-6 with the op
    named and the values that differ counted), kernel / wrapper / plain
    ms and bounds; the planes alone captured into a graph on the plain
    route (torch ops, run by this phase only) and on V1 + V2, replay ms
    and busy ms; the whole frame through jit on both routes, replay and
    busy ms, V1 / V2's busy ms inside the replay, the replays bit for bit
    between the routes.  Then the drill on the grid-2 scene at 1920x1080
    (a tight spot at level 0, a wide spot on the whole grid, an empty
    footprint, a culled point) under ESM and PCF at vis_scale 1 and 2.
    The main path (phase 4a-d) launches V1 and V2 once a frame, checked.
    V2 writes the full-resolution planes (upsampled at vis_scale 2), held
    bit for bit against vis_planes_full_plain (vis_planes_plain, then
    resize_bilinear).  `python3 chip_smoke.py --phase34` runs it alone.
35. Right after 34: V1 as one launch over all planes, V2 writing the
    full-resolution planes, and lsr_tpu's f32 PCF tap tables
    (shadow_sample.TAPS_U16 False).  One V1 and one V2 launch a frame on
    phases 4a-d, replays included (alone: the four configurations jitted
    over four cameras), and no resize_bilinear on the planes path; V1
    exactly and V2 bit for bit against their plain versions at (d) on f32
    tables (kernel, wrapper and plain ms, bounds; the frame's HDR finite)
    and in the drill's PCF cases on f32 tables at vis_scale 1 and 2; a
    summary of phase 34's V1 / V2 ms, the planes captured alone and the
    (a) / (d) replays.  `python3 chip_smoke.py --phase35` runs phases 34
    and 35.
36. Right after 35: kernel G1 (lighting/light_runtime
    .accumulate_local_lights, csrc/local_lights.cu), the general lighting
    branch's binned local-light sum, on the forward_classic+ssao
    composition's own call at 1280x720 with 384 lights (the paths_720p
    deployment: 3,600 lists of 128 slots, the local-shadow planes): G1
    bit for bit its plain version (accumulate_local_lights_plain) on those
    lists and on the same lights binned per cluster (16 slices), one
    launch each; forward_plus's general branch, tiled and clustered, on
    the same G-buffer, HDR bit for bit with the plain version in G1's
    place; kernel, wrapper and plain ms, the pairs G1 evaluates and its
    bound.  G1's launches are checked wherever phases count launches: one
    a forward_classic+ssao frame (phases 23, 29, 31), one a camera band
    of the sharded flagship and one a rank of the light-sharded forward
    (phases 27, 29, 33), none elsewhere.  `python3 chip_smoke.py
    --phase36` runs it alone.

Every launch check reads the counters utils.jit.launch_counters lists
(read_counts), so a kernel listed there is held to 0 launches wherever a
check does not name it; a counter read apart is also named in APART.

28. lsr_tpu's demo entry points through lsr_tpu_torch.demos (the UV-sphere
    stand-in for the monkey), each at its own size, counts reset before
    each: hello_blinn_phong, hello_shading_models, hello_water,
    hello_shadows, hello_ibl_skybox, hello_light_types, hello_local_shadows
    ("map" and "packed" atlas), hello_normal_mapping, hello_shaders.  The
    launches of B1 / B1a / B2 / B3 checked exactly against the count read
    from the demos' code; out/torch_hello_*.png and the covered pixels; ms
    per frame (CUDA events, median of 3 after 1 warm-up, [min, max]); B1
    on hello_water's mirrored CULL_FRONT view against rasterize_brute
    (equal off stray sliver pixels, C8, counted), B3 on hello_shadows'
    800x600 camera setup against its plain version bit for bit, B2 on each
    demo's own lighting call (IBL and env probes; surface maps; area
    lights; the local-shadow planes) within 1e-4; then each demo at
    160x120 on the CPU and on the card under phase 3's contract.
29. lsr_tpu's remaining entry points: the 2D and debug rasters
    (lsr_tpu_torch.raster.lines / wireframe / primitives2d / debug_draw,
    hello_wireframe at 600x600, hello_pixel_primitives' sheet, 4,096
    overlapping lines and 512 world segments over a 1080p canvas) on the
    card against the CPU bit for bit, each run twice on the card;
    hello_full_pipeline at 800x600, hello_rendering_paths at 480x270 (six
    compositions, 72 frames) and hello_parallelization at 256x128 (8
    ranks on this card), counts reset before each, the launches of B1 /
    B1b / B2 checked exactly against the count read from their code
    (rest_expected), ms per frame, each card against CPU at a small size
    under phase 3's contract; then lsr_tpu_torch.run_phases (Phase I at
    320x180 on both raster routes, I-posts, Phase F at 1280x720 on
    forward_plus, deferred and forward_plus+full, a 5 s Phase G), its rows
    under chiprun_out/run_phases/, read back and checked: no failed soak
    cycle, four distinct images for each path's four post stacks.
30. lsr_tpu's last modules: kernel S1 (the engine synth's sample scan,
    audio/engine_synth.synthesize) on hello_engine_synth's whole voice (6 s
    at 48 kHz, 288,000 samples) against its plain version on the host CPU,
    which a process of its own runs from the start of the script beside
    the card's phases (one thread), within 5e-7 (the two sides' sine and
    tanh); S1 against its plain version on the card bit for bit on short
    clips of the drive cycle: the starter (4,800 samples at 48 kHz), its
    first 3.2 s at 2 kHz (6,400 samples, past the catch at 1 s and the
    first upshift's burst at 2.6 s), 1, 255, 257 and 769 samples at 48 kHz
    (either side of S1's chunks of 256) and 3 s at 1 kHz (S1's later
    chunks there wrap phases with floorf); hello_engine_synth's main()
    (counts reset: exactly one S1 launch; out/torch_hello_engine_synth.wav
    and _spectrum.png), S1 timed by CUDA events (median of 3 after 1), the
    voice finite with peak <= 1, lsr_tpu's fundamental check at 1800 and
    3600 rpm on the card; then a 192 x 192 UV sphere (73,728 triangles)
    written as OBJ, PLY, STL, glTF and GLB, each loaded by io/mesh_loader
    (host ms; OBJ through the native loader built with g++) and rendered
    by render_forward at 1920x1080, counts reset: one B1 launch a frame,
    tids equal across the formats bit for bit, frames equal where the
    normals and UVs are; the OBJ's frame
    card against CPU at 192x108; the orbit bot's reducers (the app layer)
    for 120 frames on the host, every 30th rig the camera of a render
    (one B1 launch each), the rig path lsr_tpu's (ORBIT_PATH).

14. Where the time goes (last): for the cut frame on both routes, the
    high-poly frame and the end-to-end step, each stage alone on the
    previous stage's outputs (host enqueue ms, device ms by CUDA events),
    then whole frames: median ms by CUDA events, and torch.profiler's
    device busy ms and kernel launches per frame; then the whole frame's
    own stages (cull, atlas by both strategies, planes, its sun map) and
    its breakdown on both routes in the ESM default.  (The high-poly part
    runs after phase 8, while its scene is on the card.)

Each phase that measures a kernel logs its entry of the final kernels line
as it ends ("# kernels entry [...]"), so a cut run keeps its numbers.

Every kernel's bound is renderbench.kernels.bounds.bound_ms: the larger of
the bytes it must move over 3.35 TB/s and the f32 operations this run's
data needs over 67 TFLOP/s (the H100 SXM's published peaks; the peaks and
the operation counts RASTER_OPS, LIGHT_OPS and SUN_OPS are that module's,
the benchmark's), counted from the inputs of this run: a raster
does RASTER_OPS per (triangle, pixel) pair inside a valid triangle's bbox,
a light loop LIGHT_OPS per live (covered pixel, binned light) pair (in
range, inside the cone, facing the light: light_walk.walk_counts'
pairs_live; any other pair's term is +0 and needs no operation), plus the
per-pixel work of the sun term and, for B5, interpolation and ambient.
A local-shadow plane is read once for each live pair of a shadowed light.
The bytes count each input the work needs once and each output once.  A
raster's outputs, depth and tid, count once as written; the cleared
targets a walk starts from are constants the work does not need, so they
are not counted as inputs (B1 reads none unless the caller gives them).
The build's `ptxas -v` lines give each kernel's registers, spilled bytes
and static shared memory, logged and kept in the kernels line.

Any failed phase raises, so the script exits non-zero.  Its output ends with
the card's name and power limit, one JSON line of per-kernel results and,
last, {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from renderbench.kernels.bounds import LIGHT_OPS, RASTER_OPS, SUN_OPS, bound_ms

WIDTH, HEIGHT = 1920, 1080
N_LIGHTS = 256
SEED = 42
WARMUP, FRAMES = 3, 12
SMALL_W, SMALL_H = 192, 108
B2_TOL = 1e-4
PLAIN_W, PLAIN_H = 480, 270        # B3 / B4 against their plain versions
HP_GRID = 33
HP_WARMUP, HP_FRAMES = 2, 5
SHADOW = 2048                      # the bench's sun map
SMALL_S = 256                      # the sun map of the CPU reference
ESM_TOL = 1.3e-3                   # one soft-map quantum: exp(80/65535) - 1
RES_FRAMES = 8                     # resolve frames after warm-up
CUT = dict(with_cull=False, with_local=False)   # the cut frame
WHOLE_FRAMES = 6                   # whole frames after warm-up, per config
SMALL_LIGHTS = 32                  # lights of the small whole-frame check
SMALL_LOCAL = 128                  # its spot slots and cube faces

# B5's work beyond the light loop and the sun for the bounds (f32
# operations, sqrt / division / powf / cosf counted as one each).
RESOLVE_OPS = 100   # B5's interpolation, normal and fake-IBL ambient


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def resources_of(src):
    """The build's `ptxas -v` lines of one source: registers, spilled bytes
    and shared memory of each kernel in it."""
    from lsr_tpu_torch.utils.cuda_build import build_info, kernel_resources

    return kernel_resources(build_info["log"]).get(src, [])


def bound(n_bytes, n_ops):
    """{bound_ms, bound_by, bytes, ops}: the least time the card could take
    (bytes over peak bandwidth or operations over the f32 peak)."""
    return {"bound_ms": bound_ms(n_bytes, n_ops),
            "bound_by": ("bytes" if bound_ms(n_bytes, 0) >= bound_ms(0, n_ops)
                         else "operations"),
            "bytes": int(n_bytes), "ops": int(n_ops)}


def raster_pairs(setup, y0=0, rows=None):
    """(triangle, pixel) pairs inside the bboxes of the valid triangles;
    given rows, only those in rows [y0, y0 + rows)."""
    b = setup.bbox[setup.valid].to(torch.int64)
    lo, hi = b[:, 1], b[:, 3]
    if rows is not None:
        lo, hi = torch.clamp(lo, min=y0), torch.clamp(hi, max=y0 + rows - 1)
    return int(((b[:, 2] - b[:, 0] + 1) * torch.clamp(hi - lo + 1, min=0))
               .sum())


def direct_read_bytes(rec, chunk_bb, lists, counts):
    """What a B1 launch must read: its live super-list entries and its
    tiles' counts, the chunk boxes of each distinct listed super and the
    records of the valid rows in those supers.  Unlisted supers (outside
    the view, a slot's padding) and invalid rows need no read."""
    from lsr_tpu_torch.raster import tiled

    live = torch.arange(lists.shape[1], device=lists.device)[None] \
        < counts[:, None]
    sup = torch.unique(lists[live]).to(torch.int64)
    rows = int((rec.reshape(-1, tiled._SUPER, rec.shape[1])[sup, :, 15] >= 0)
               .sum())
    boxes = sup.numel() * (tiled._SUPER // tiled._CHUNK)
    return (4 * int(live.sum()) + 4 * counts.numel()
            + boxes * chunk_bb.shape[1] * chunk_bb.element_size()
            + rows * rec.shape[1] * rec.element_size())


def walk_stats(name, rec, lists, n, width, height, tile_h, pairs_needed,
               chunk=None, sub_h=None, chunk_bb=None):
    """Log and return what a raster walks on one setup, from the lists
    themselves and the plain model of the kernels' cull
    (tiled.walk_survivors) on the card's tensors.  lists (tiles, cap), n
    (tiles,) entries walked per tile.  chunk=None: B3's row lists; with
    chunk, B4's worklists of packed entries (id << 5 | band_start << 2 |
    band_count - 1, bands of sub_h rows); with chunk_bb, B1's super lists
    (tile_h 128).  pairs_tested: the (triangle, pixel) pairs of the design
    before the per-triangle cull: every listed triangle at every pixel of
    its tile (B4: of its band rows; B1: the 16 triangles of every chunk
    whose bbox meets a 16x16 block, at its 256 pixels); pairs_needed: the
    pairs inside valid bboxes; per 16x16 block the survivors of the first
    cull level, which the block queues, and per 8x4 warp rectangle those of
    both levels, which its 32 pixels evaluate; read_bytes (B3 / B4): what
    the walk must read, each listed entry and each distinct listed record
    once."""
    from lsr_tpu_torch.raster import tiled

    per_block, per_warp = tiled.walk_survivors(
        rec, lists, n, width, height, tile_h, 128, chunk, sub_h,
        chunk_bb=chunk_bb)
    n64 = n.to(torch.int64)
    out = {}
    if chunk_bb is not None:
        hits = tiled.direct_chunk_hits(chunk_bb, lists, n, width, height)
        pairs_tested = hits.sum() * 16 * 256
        # Every block of a tile tests the 16 chunk bboxes of each listed
        # super.
        out.update(chunk_tests_per_block_mean=float(
            n.to(torch.float64).mean()) * 16,
            chunk_tests_per_block_max=int(n64.max()) * 16,
            chunk_hits_per_block_mean=float(hits.to(torch.float64).mean()),
            chunk_hits_per_block_max=int(hits.max()))
    elif chunk is None:
        pairs_tested = n64.sum() * tile_h * 128
    else:
        live = torch.arange(lists.shape[1], device=n.device)[None] \
            < n64[:, None]
        band_rows = (((lists.to(torch.int64) & 3) + 1) * sub_h * live).sum()
        pairs_tested = band_rows * 128 * chunk
    nf = n.to(torch.float64)
    out.update({
        "pairs_tested": int(pairs_tested), "pairs_needed": pairs_needed,
        "pairs_after_block_cull": int(per_block.sum()) * 256,
        "pairs_after_warp_cull": int(per_warp.sum()) * 32,
        "list_sum": int(n64.sum()), "list_mean": float(nf.mean()),
        "list_max": int(n64.max()),
        "survivors_per_block_mean": float(per_block.to(torch.float64).mean()),
        "survivors_per_block_max": int(per_block.max()),
        "survivors_per_warp_mean": float(per_warp.to(torch.float64).mean()),
        "survivors_per_warp_max": int(per_warp.max())})
    if chunk_bb is None:
        rows = tiled.listed_rows(lists, n, chunk)
        # entries (4 B each), records (64 B a row), counts (i32) and the
        # tile order (i64) per tile.
        out.update(listed_rows=rows, read_bytes=4 * int(n64.sum()) + 64 * rows
                   + 12 * n.numel())
    log(f"{name} walk at {width}x{height}: {out}")
    return out


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

    # Given targets are read: a second draw over a mid-depth plane that
    # carries ids of its own.
    d_in = torch.full((HEIGHT, WIDTH), 0.25, dtype=torch.float32, device=dev)
    t_in = torch.full((HEIGHT, WIDTH), 1 << 20, dtype=torch.int32, device=dev)
    d_k, t_k, _ = tiled.rasterize_direct(setup, WIDTH, HEIGHT, cam.zn, cam.zf,
                                         depth_init=d_in, tid_init=t_in,
                                         spatial_sort=True)
    d_p, t_p = rasterize_brute(setup, WIDTH, HEIGHT, cam.zn, cam.zf,
                               depth_init=d_in, tid_init=t_in)
    torch.cuda.synchronize()
    won = int((t_p != t_in).sum())
    log(f"B1 [sort,viewz,ids, given targets]: depth mismatches "
        f"{int((d_k != d_p).sum())}, tid mismatches {int((t_k != t_p).sum())}"
        f", {won} px won against the plane")
    check(bool((d_k == d_p).all() and (t_k == t_p).all()) and 0 < won
          < result["covered"], "B1 with given targets differs from plain")

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
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # As the frame calls it: no targets given, none read.
    kern = lambda: tiled._direct_launch(  # noqa: E731
        lib, rec, cbb, sl, cnt, None, None, WIDTH, HEIGHT, cam.zn, cam.zf, 0,
        True, True, stream)
    kern()
    kernel_ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(lambda: rasterize_brute(setup, WIDTH, HEIGHT, cam.zn,
                                               cam.zf), 2)
    n_pairs = raster_pairs(setup)
    b = bound(direct_read_bytes(rec, cbb, sl, cnt) + 8 * WIDTH * HEIGHT,
              n_pairs * RASTER_OPS)
    log(f"B1 time: wrapper {ms:.3f} ms, kernel alone {kernel_ms:.3f} ms, "
        f"plain (rasterize_brute) {plain_ms:.3f} ms; bound {b}")
    result.update(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, **b,
                  **walk_stats("B1 (camera view)", rec, sl, cnt, WIDTH,
                               HEIGHT, 128, n_pairs, chunk_bb=cbb))
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
    from lsr_tpu_torch.lighting.light_walk import gbuf_walk_counts
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
    gbuf, trec, cnts, uni = sk._prepare(
        *args(lights, "pbr_mr"), None, None, None, 0)[:4]
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kern = lambda: sk._shade_launch(  # noqa: E731
        lib, gbuf, trec, cnts, uni, WIDTH, HEIGHT, "pbr_mr", lights.apow1,
        stream)
    kern()
    kernel_ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(lambda: sk.shade_fused_plain(*args(lights, "pbr_mr")),
                       2)
    n_cov = int(gb.covered.sum())
    walk = gbuf_walk_counts(gbuf, trec, cnts, 64, 128, 8, lights.kinds)
    b = bound(nbytes(gbuf[:13], trec, cnts, uni) + 12 * WIDTH * HEIGHT,
              walk["pairs_live"] * LIGHT_OPS + n_cov * SUN_OPS)
    log(f"B2 time: wrapper {ms:.3f} ms, kernel alone {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms; bound {b}; registers / spilled bytes "
        f"{resources_of('shade_fused.cu')}")
    log(f"B2 light walk at {WIDTH}x{HEIGHT} (64x128 tiles, chunk 8): {walk}")
    return {"max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, **b, **walk}


def small_reference(dev):
    """The same scene, with a SMALL_S^2 ESM sun map, through the plain
    versions on the CPU and through the kernels on the card, at a small
    size.  The two sides build their own camera setups (matmul order
    differs), so a few edge pixels may pick another triangle; FXAA's luma
    decisions can amplify a 1-LSB tonemap difference, so the final LDR is
    held at 99.5% and the tonemapped LDR at 99.9%.  Returns both sides'
    stages for phase 10."""
    from lsr_tpu_torch.frame import (
        build_flagship_scene, flagship_camera, flagship_stages)
    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.tonemap import tonemap_pass

    out, stages = {}, {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        geom, objects, lights, ctx = build_flagship_scene(N_LIGHTS, SEED,
                                                          device=d)
        cam, ctx_t = flagship_camera(0, ctx, SMALL_W, SMALL_H, device=d)
        st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, SMALL_W,
                             SMALL_H, shadow_size=SMALL_S, **CUT)
        tm = tonemap_pass(st["hdr"])
        out[str(d)] = (st["tid"].cpu(), st["hdr"].cpu(), tm.cpu(),
                       fxaa_pass(tm).cpu())
        stages[str(d)] = (st, ctx_t)
        log(f"small reference on {d}: {time.perf_counter() - t0:.1f} s")
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
    return stages["cpu"], stages[str(dev)]


# Counters the launch checks of whole frames leave out and read where they
# check them: B1b's bands (a share of rasterize_direct's launches; phases
# 27, 29, 31 and 33), V1 / V2 (phases 4, 34 and 35), S1 (phase 30).
APART = ("rasterize_direct.band_launches", "vis_windows.launches",
         "vis_planes.launches", "synthesize.launches")


def counts():
    """{"<wrapper>.<attribute>": launches since reset_counts()} of every
    kernel wrapper utils.jit.launch_counters lists, by the names
    renderbench prints."""
    from lsr_tpu_torch.utils.jit import launch_counters

    return {f"{owner.__name__}.{attr}": getattr(owner, attr)
            for owner, attr in launch_counters()}


def reset_counts():
    from lsr_tpu_torch.utils.jit import launch_counters

    for owner, attr in launch_counters():
        setattr(owner, attr, 0)


def read_counts():
    """counts() but APART: what a launch check holds exactly, every kernel
    not named in it at 0."""
    return {k: v for k, v in counts().items() if k not in APART}


def read_vis_counts():
    c = counts()
    return {k: c[f"{k}.launches"] for k in ("vis_windows", "vis_planes")}


def expected(launches):
    """read_counts()'s counters, each 0 but those in launches {counter:
    count}."""
    return {**dict.fromkeys(read_counts(), 0), **launches}


def f1_per_frame(spot_ids, point_ids, packed=False):
    """F1's launches in one atlas render: one a non-empty stack under
    "map", none under "packed" or "hybrid"."""
    return 0 if packed else int(bool(spot_ids)) + int(bool(point_ids))


def pipeline_expected(fp, ssao):
    """One frame's launches of a pass pipeline with frame params fp: B1 on
    the occluders, the sun map, the camera and every atlas slot, F1 once a
    stack, B2 (G1 instead under SSAO, the general branch)."""
    lp = fp.pass_params.local_shadow
    return expected({
        "rasterize_direct.launches": (3 + len(lp.spot_ids)
                                      + 6 * len(lp.point_ids)),
        "shade_fused.launches": 0 if ssao else 1,
        "accumulate_local_lights.launches": int(ssao),
        "slot_inputs.launches": f1_per_frame(lp.spot_ids, lp.point_ids)})


def targets(w, h, dev):
    from lsr_tpu_torch.raster.tiled import _targets

    return _targets(None, None, h, w, dev)


def stray(tid, bbox, y0=0):
    """(H, W) bool: the pixel's winner is a triangle whose bbox does not
    hold the pixel (tid's row 0 the frame's row y0).  The f32 edge functions of a sliver triangle can cover
    such pixels; lsr_tpu's kernels, like the port's, evaluate a triangle
    only where their own culling grain lets them, so different raster
    routes keep different ones of these pixels (ROADMAP C8)."""
    h, w = tid.shape
    b = bbox[torch.clamp(tid, min=0).to(torch.int64)]
    x = torch.arange(w, device=tid.device)[None, :]
    y = torch.arange(y0, y0 + h, device=tid.device)[:, None]
    inside = ((b[..., 0] <= x) & (x <= b[..., 2]) & (b[..., 1] <= y)
              & (y <= b[..., 3]))
    return (tid >= 0) & ~inside


def same_but_strays(name, d_a, t_a, bbox_a, d_b, t_b, bbox_b, same_ids,
                    y0=0):
    """Two rasters of the same triangles (rows from the frame's row y0):
    every pixel where they differ must have a stray winner on one side
    (see stray); on all other pixels coverage (tids when same_ids) and
    depth must be equal bit for bit."""
    s = stray(t_a, bbox_a, y0) | stray(t_b, bbox_b, y0)
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
        d, t, max_bin, _, _ = tiled.rasterize_tiled(
            setup, w, h, zn, zf, tile_h=tile_h, cap=cap, chunk=chunk,
            fit_cap=fit_cap)
        used = tiled.fitted_cap(cap, int(max_bin)) if fit_cap else cap
        return d, t, f"max_bin {int(max_bin)}, cap {used}"

    def plain():
        rec, lists, n_walk, *_ = tiled.tiled_inputs(
            setup, w, h, tile_h, 128, cap, chunk, fit_cap=fit_cap)
        return tiled.rasterize_tiled_plain(rec, lists, n_walk, d0, t0, w, h,
                                           zn, zf, tile_h=tile_h, chunk=chunk)

    return _vs_plain(f"B3 {name}", kern, plain)


def _b4_vs_plain(name, setup, w, h, zn, zf, mode, track, y_off, full_h,
                 tile_h=128, chunk=16, ccap=None, sub_h=32):
    from lsr_tpu_torch.raster import tiled

    hb = h - y_off
    db, tb = targets(w, hb, setup.coef.device)

    def kern():
        d, t, mc = tiled.rasterize_chunklist(
            setup, w, hb, zn, zf, depth_mode=mode, tile_h=tile_h, chunk=chunk,
            ccap=ccap, sub_h=sub_h, y_offset=y_off, full_height=full_h,
            track_ids=track)
        return d, t, f"max chunks/tile {int(mc)}"

    def plain():
        rec, cl, cc, _ = tiled.chunklist_inputs(setup, w, hb, tile_h, 128,
                                                chunk, ccap, sub_h, y_off)
        return tiled.rasterize_chunklist_plain(
            rec, cl, cc, db, tb, w, hb, zn, zf, mode, tile_h, 128, chunk,
            sub_h, y_off, full_h, track)

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
    _b4_vs_plain("32x128 tiles, sub_h 8, chunk 8, ccap 8192 (truncating)",
                 setup, w, h, cam.zn, cam.zf, DEPTH_VIEWZ, True, 0, h,
                 tile_h=32, chunk=8, ccap=8192, sub_h=8)


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
    max_bin = tiled.bin_triangles(setup, WIDTH, HEIGHT, 64, 128, 1)[2]
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
    _, lists, n_walk, *_ = tiled.tiled_inputs(setup, WIDTH, HEIGHT, 64, 128,
                                              1024, 16, fit_cap=True)
    _, cl, cc, _ = tiled.chunklist_inputs(setup, WIDTH, HEIGHT, 128, 128, 16,
                                          None, 32)
    # The tile orders are sorted once here, so that kernel_ms is the launch
    # alone as for the other kernels; the wrappers' ms includes the sort.
    order3, order4 = tiled.tile_order(n_walk), tiled.tile_order(cc)
    kerns = {
        "direct_raster": lambda: tiled._direct_launch(
            lib, rec, cbb, sl, scnt, None, None, WIDTH, HEIGHT, zn, zf, 0,
            True, False, stream),
        "tiled_raster": lambda: tiled._tiled_launch(
            lib, rec, lists, n_walk, d0, t0, WIDTH, HEIGHT, zn, zf, 0, 64,
            128, 0, HEIGHT, stream, order3),
        "chunklist_raster": lambda: tiled._chunklist_launch(
            lib, rec, cl, cc, d0, t0, WIDTH, HEIGHT, zn, zf, 0, 128, 128, 16,
            32, 0, HEIGHT, True, stream, order4),
    }
    n_pairs = raster_pairs(setup)
    out["tiled_raster"].update(walk_stats(
        "B3 (compact setup)", rec, lists, n_walk, WIDTH, HEIGHT, 64, n_pairs))
    out["chunklist_raster"].update(walk_stats(
        "B4 (compact setup)", rec, cl, cc, WIDTH, HEIGHT, 128, n_pairs, 16,
        32))
    ops = n_pairs * RASTER_OPS
    targets_bytes = 8 * WIDTH * HEIGHT       # depth and tid, written once
    # The bytes this run's lists name (each listed entry and each distinct
    # listed record once), not the padded list arrays.
    bounds = {"direct_raster": bound(direct_read_bytes(rec, cbb, sl, scnt)
                                     + targets_bytes, ops)}
    for k in ("tiled_raster", "chunklist_raster"):
        bounds[k] = bound(out[k].pop("read_bytes") + targets_bytes, ops)
    log(f"tile order alone (torch.argsort, inside the B3 / B4 wrappers): "
        f"{cuda_ms(lambda: tiled.tile_order(n_walk), 20):.4f} ms")
    for k in runs:
        kerns[k]()
        kernel_ms = cuda_ms(kerns[k], 20)
        runs[k]()
        ms = cuda_ms(runs[k], 5)
        out.setdefault(k, {}).update(ms=ms, kernel_ms=kernel_ms, **bounds[k])
        log(f"{k} on the 1080p compact setup: wrapper {ms:.3f} ms, kernel "
            f"alone {kernel_ms:.3f} ms; bound {bounds[k]}")
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
        (ldr, st), _ = frame.fn(cam, ctx_t, None)     # the eager route
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
    check(launches["rasterize_tiled.launches"] > 0
          and launches["shade_fused.launches"] > 0,
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
    """Compact setup + chunk-list raster (bench_highpoly.py:156-166), the
    eager step (phase 32 runs it as one program)."""
    from lsr_tpu_torch.highpoly import _e2e_step, highpoly_camera
    from lsr_tpu_torch.raster.setup import scene_setup
    from lsr_tpu_torch.raster.tiled import rasterize_chunklist

    cam, _ = highpoly_camera(ctx, WIDTH, HEIGHT, HP_GRID, device=dev)
    run = lambda: _e2e_step(  # noqa: E731
        geom, objects, cam, WIDTH, HEIGHT, None)[0]
    reset_counts()
    d_e, t_e, max_cnt, setup, cst = run()
    launches = read_counts()
    check(launches["rasterize_chunklist.launches"] > 0,
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
             "rasterize_direct.launches"),
            ("high-poly", lambda: build_highpoly_scene(HP_GRID, device=dev),
             lambda ctx: highpoly_camera(ctx, WIDTH, HEIGHT, HP_GRID,
                                         device=dev),
             "rasterize_tiled.launches")):
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
        check(launches[kernel] == 1, f"render_forward {name} launched "
              f"{kernel} other than once (a redone frame launches twice): "
              f"{launches}")
        check(ldr.shape == (HEIGHT, WIDTH, 3) and ldr.dtype == torch.uint8
              and covered > 0 and int(ldr.int().sum()) > 0,
              f"render_forward {name}: empty frame")
        del geom, objects, gb, ldr


def sun_map_phase(geom, objects, ctx, cpu_side, card_side, dev):
    """Phase 10.  The bench's 2048^2 sun map: B1 (NDC01, depth only,
    128x128 tiles, spatial sort) against rasterize_brute on the card, bit
    for bit.  Then phase 3's small scene: the card's sun map against the
    CPU's (equal: the light camera and depth-only setup are elementwise),
    its ESM soft map within one q16 quantum, and the sun visibility of the
    card's context against the CPU's on the same receivers within ESM_TOL.
    Returns the sun map's B1 result entry."""
    from lsr_tpu_torch.lighting.shadow_sample import (
        make_shadow_context, shadow_visibility_dir)
    from lsr_tpu_torch.passes.shadow import render_shadow_map, shadow_map_setup
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.setup import DEPTH_NDC01

    setup, light_vp = shadow_map_setup(geom, objects, ctx.light_dir_ws,
                                       SHADOW)
    run = lambda: tiled.rasterize_direct(  # noqa: E731
        setup, SHADOW, SHADOW, 0.0, 1.0, depth_mode=DEPTH_NDC01,
        track_ids=False, tile_h=128, tile_w=128, spatial_sort=True)
    d_k, _, max_sup = run()
    d_m, vp_m = render_shadow_map(geom, objects, ctx.light_dir_ws, SHADOW)
    t0 = time.perf_counter()
    d_p, _ = rasterize_brute(setup, SHADOW, SHADOW, 0.0, 1.0,
                             depth_mode=DEPTH_NDC01)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mis = int((d_k != d_p).sum())
    covered = int((d_p < 1.0).sum())
    log(f"sun map {SHADOW}^2 (B1 NDC01 depth only): {mis} depth mismatches "
        f"against rasterize_brute of {covered} covered texels, "
        f"render_shadow_map equal {bool((d_m == d_k).all())}, light "
        f"view-projection equal {bool((vp_m == light_vp).all())}, max "
        f"supers/tile {int(max_sup)}; plain {plain_ms:.1f} ms")
    check(mis == 0 and covered > 0, "sun map differs from rasterize_brute")
    check(bool((d_m == d_k).all()), "render_shadow_map differs")
    ms = cuda_ms(run, 10)
    rec, ss, n_pad = tiled.pack_direct_records(setup, True, 128, 128)
    cbb = tiled._chunk_bboxes(ss, n_pad, 16)
    sl, cnt, _ = tiled._super_lists(cbb, 16, SHADOW // 128, SHADOW // 128,
                                    128, 128)
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kern = lambda: tiled._direct_launch(  # noqa: E731
        lib, rec, cbb, sl, cnt, None, None, SHADOW, SHADOW, 0.0, 1.0,
        DEPTH_NDC01, False, True, stream)
    kern()
    kernel_ms = cuda_ms(kern, 10)
    n_pairs = raster_pairs(setup)
    b = bound(direct_read_bytes(rec, cbb, sl, cnt) + 4 * SHADOW * SHADOW,
              n_pairs * RASTER_OPS)
    log(f"sun map B1 time: wrapper {ms:.3f} ms, kernel alone "
        f"{kernel_ms:.3f} ms; bound {b}")
    walk = walk_stats("B1 (sun map)", rec, sl, cnt, SHADOW, SHADOW, 128,
                      n_pairs, chunk_bb=cbb)

    # Phase 3's scene: the card's sun map, soft map and visibility against
    # the CPU's.
    (st_c, ctx_c), (st_g, _) = cpu_side, card_side
    same_map = bool((st_g["sun_depth"].cpu() == st_c["sun_depth"]).all())
    same_vp = bool((st_g["light_viewproj"].cpu()
                    == st_c["light_viewproj"]).all())
    sc_c = make_shadow_context(st_c["sun_depth"], st_c["light_viewproj"],
                               pcf_radius=2, filter_mode="esm")
    sc_g = make_shadow_context(st_g["sun_depth"], st_g["light_viewproj"],
                               pcf_radius=2, filter_mode="esm")
    dq = (sc_g.taps_q16.cpu().to(torch.int64)
          - sc_c.taps_q16.to(torch.int64)).abs()
    gb = st_c["gb"]
    l_dir = -ctx_c.light_dir_ws / torch.linalg.norm(ctx_c.light_dir_ws)
    ndl = torch.clamp((gb.normal_ws * l_dir).sum(-1), min=0.0)
    v_c = shadow_visibility_dir(sc_c, gb.world_pos, ndl)
    v_g = shadow_visibility_dir(sc_g, gb.world_pos.to(dev),
                                ndl.to(dev)).cpu()
    err = float((v_g - v_c).abs().max())
    shadowed = int(((v_c < 1.0) & gb.covered).sum())
    log(f"sun map {SMALL_S}^2 at {SMALL_W}x{SMALL_H}, card vs CPU: map equal "
        f"{same_map}, light view-projection equal {same_vp}; ESM soft map "
        f"q16 equal on {float((dq == 0).float().mean()):.4%} of texels, max "
        f"{int(dq.max())} quantum; visibility max abs {err:.3g} (tol "
        f"{ESM_TOL}) over {shadowed} shadowed covered px")
    check(same_map and same_vp, "the card's sun map differs from the CPU's")
    check(int(dq.max()) <= 1 and err <= ESM_TOL and shadowed > 0,
          "ESM soft map / visibility: card differs from CPU")
    return {"max_abs_err": float((d_k - d_p).abs().max()), "ms": ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, **b, **walk}


def b5_phase(st, ctx_t, lights, cam, dev):
    """Phase 11.  B5 against resolve_fused_plain on the card at 1080p, on
    the flagship frame's visibility buffer, ESM sun visibility and texture
    albedo (resolve_inputs)."""
    from lsr_tpu_torch.lighting import resolve_kernel as rk
    from lsr_tpu_torch.lighting.shade_kernel import (
        SUN_MODELS, bin_light_records)
    from lsr_tpu_torch.passes.forward_plus import resolve_inputs
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    table, vis, tex, _ = resolve_inputs(
        st["setup"], st["depth"], st["tid"],
        dataclasses.replace(ctx_t, shadow=st["shadow"]), cam.view, cam.proj,
        cam.zn, cam.zf, WIDTH, HEIGHT)
    rad = ctx_t.light_color * ctx_t.light_intensity
    bg = (0.04, 0.06, 0.1)

    def args(light_set, model, chunk=8):
        return (table, st["tid"], vis, tex, ctx_t.camera_pos,
                ctx_t.light_dir_ws, rad, bg, light_set, cam.view, cam.proj,
                WIDTH, HEIGHT, 64, 128, 256, chunk, None, model, "lanes")

    # Chunk 8 is the resolve route's; 16 (the public default) is a kernel
    # variant of its own (a 16-light staging and tree sum).
    worst, values_differing = 0.0, 0
    for lname, light_set in (("flagship", lights), ("mixed", mixed_lights(dev))):
        for model in SUN_MODELS:
            for chunk in (8, 16):
                h_k, stats = rk.resolve_fused(*args(light_set, model, chunk))
                h_p, _ = rk.resolve_fused_plain(*args(light_set, model, chunk))
                torch.cuda.synchronize()
                err = float((h_k - h_p).abs().max())
                n_diff = int((h_k.view(torch.int32)
                              != h_p.view(torch.int32)).sum())
                finite = bool(torch.isfinite(h_k).all())
                log(f"B5 [{lname}, {model}, chunk {chunk}]: max abs {err:.3g} "
                    f"(tol {B2_TOL}), {n_diff} values not bit for bit, max "
                    f"|hdr| {float(h_p.abs().max()):.4g}, max lights/bin "
                    f"{int(stats['max_count'])}, finite {finite}")
                check(finite and err <= B2_TOL,
                      f"B5 {lname} {model} chunk {chunk} differs")
                worst = max(worst, err)
                values_differing += n_diff

    ms = cuda_ms(lambda: rk.resolve_fused(*args(lights, "pbr_mr")), 20)
    trec, cnts, _ = bin_light_records(lights, cam.view, cam.proj, WIDTH,
                                      HEIGHT, 64, 128, 256, None)
    uni = rk._uniforms(ctx_t.camera_pos, ctx_t.light_dir_ws, rad, bg, dev)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kern = lambda: rk._resolve_launch(  # noqa: E731
        lib, table, st["tid"], vis, tex, trec, cnts, uni, WIDTH, HEIGHT, 64,
        128, 8, "pbr_mr", stream)
    kern()
    kernel_ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(lambda: rk.resolve_fused_plain(
        *args(lights, "pbr_mr")), 2)
    covered = st["tid"] >= 0
    n_cov = int(covered.sum())
    n_rows = int(torch.unique(st["tid"][covered]).numel())
    walk = rk.walk_counts(table, st["tid"], tex, trec, cnts, WIDTH, HEIGHT,
                          64, 128, 8, lights.kinds)
    # The kernel reads 31 lanes of each visible triangle's record; per
    # pixel its tid, visibility and albedo; it writes 12 bytes a pixel.
    b = bound(n_rows * 31 * 4 + WIDTH * HEIGHT * (4 + 4 + 12 + 12)
              + nbytes(trec, cnts, uni),
              walk["pairs_live"] * LIGHT_OPS
              + n_cov * (SUN_OPS + RESOLVE_OPS))
    log(f"B5 time: wrapper {ms:.3f} ms, kernel alone {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms; bound {b}; registers / spilled bytes "
        f"{resources_of('resolve_fused.cu')}")
    log(f"B5 light walk at {WIDTH}x{HEIGHT} (64x128 tiles, chunk 8): {walk}")
    return {"max_abs_err": worst, "values_not_bit_equal": values_differing,
            "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, **b,
            **walk}


def b6_phase(gb, ctx_t, lights, cam, dev):
    """Phase 12.  B6 against accumulate_lights_plain on the card at 1080p
    on the flagship G-buffer, at 64x128 (cap 256, chunk 16) and 16x128
    (cap 64, chunk 8); then its entry point once with counts reset; the
    kernel's time and the counts of its light walk in both configurations.
    Returns (result entry, launches)."""
    from lsr_tpu_torch.lighting import fplus_kernel as fk
    from lsr_tpu_torch.lighting.light_walk import gbuf_walk_counts
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    def args(tile_h, cap, chunk, light_set=lights):
        return (gb.world_pos, gb.normal_ws, gb.covered, ctx_t.camera_pos,
                light_set, cam.view, cam.proj, WIDTH, HEIGHT, tile_h, 128,
                cap, chunk)

    worst = 0.0
    for tile_h, cap, chunk in ((64, 256, 16), (16, 64, 8)):
        for lname, light_set in (("flagship", lights),
                                 ("mixed", mixed_lights(dev))):
            d_k, s_k, stats = fk.accumulate_lights(
                *args(tile_h, cap, chunk, light_set))
            d_p, s_p, _ = fk.accumulate_lights_plain(
                *args(tile_h, cap, chunk, light_set))
            torch.cuda.synchronize()
            err = max(float((d_k - d_p).abs().max()),
                      float((s_k - s_p).abs().max()))
            log(f"B6 [{tile_h}x128, cap {cap}, chunk {chunk}, {lname}]: "
                f"max abs {err:.3g} (tol {B2_TOL}), max diffuse "
                f"{float(d_p.max()):.4g}, max lights/bin "
                f"{int(stats['max_count'])}")
            check(bool(torch.isfinite(d_k).all() and torch.isfinite(s_k).all())
                  and err <= B2_TOL, f"B6 {tile_h}x128 {lname} differs")
            worst = max(worst, err)

    reset_counts()
    fk.accumulate_lights(*args(64, 256, 16))
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["accumulate_lights.launches"] == 1,
          f"accumulate_lights did not launch B6: {launches}")
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for tile_h, cap, chunk in ((64, 256, 16), (16, 64, 8)):
        a = args(tile_h, cap, chunk)
        ms = cuda_ms(lambda: fk.accumulate_lights(*a), 20)
        gbuf, trec, cnts, uni, _, _ = fk._prepare(*a, None)

        def kern():
            return fk._accumulate_launch(lib, gbuf, trec, cnts, uni, WIDTH,
                                         HEIGHT, tile_h, 128, chunk, stream)

        kern()
        kernel_ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(lambda: fk.accumulate_lights_plain(*a), 2)
        walk = gbuf_walk_counts(gbuf, trec, cnts, tile_h, 128, chunk,
                                lights.kinds)
        b = bound(nbytes(gbuf[:7], trec, cnts, uni) + 24 * WIDTH * HEIGHT,
                  walk["pairs_live"] * LIGHT_OPS)
        log(f"B6 time ({tile_h}x128, chunk {chunk}): wrapper {ms:.3f} ms, "
            f"kernel alone {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
            f"{b}; registers / spilled bytes "
            f"{resources_of('fplus_accumulate.cu')}")
        log(f"B6 light walk at {WIDTH}x{HEIGHT} ({tile_h}x128 tiles, chunk "
            f"{chunk}): {walk}")
        res[f"{tile_h}x128"] = {"ms": ms, "kernel_ms": kernel_ms,
                                "plain_ms": plain_ms, **b, **walk}
    return {"max_abs_err": worst, **res["64x128"],
            "tile_16x128": res["16x128"]}, launches


def resolve_frame_phase(geom, objects, lights, ctx, cams, dev):
    """Phase 13.  The resolve route's frame at 1080p, counts reset: two
    direct_raster launches and one resolve_fused launch per frame; median
    and pipelined ms; its HDR against the B2 route's on the first camera.
    Returns (launches, median ms, pipelined ms)."""
    from lsr_tpu_torch.frame import flagship_stages, make_flagship_frame
    from lsr_tpu_torch.io.png import write_png

    frame = make_flagship_frame(geom, objects, lights, ctx, WIDTH, HEIGHT,
                                use_resolve=True, **CUT)
    cams = cams[:WARMUP + RES_FRAMES]
    reset_counts()
    ms = []
    for cam, ctx_i in cams:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = frame(cam, ctx_i)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    t0 = time.perf_counter()
    for cam, ctx_i in cams[WARMUP:]:
        out = frame(cam, ctx_i)
    torch.cuda.synchronize()
    pipelined = (time.perf_counter() - t0) * 1e3 / RES_FRAMES
    launches = read_counts()
    n_frames = len(cams) + RES_FRAMES
    check(launches["rasterize_direct.launches"] == 2 * n_frames
          and launches["resolve_fused.launches"] == n_frames
          and launches["shade_fused.launches"] == 0,
          f"resolve frame launches {launches} for {n_frames} frames")
    ldr = out[0]
    check(ldr.shape == (HEIGHT, WIDTH, 3) and ldr.dtype == torch.uint8
          and float((ldr.int().sum(-1) > 0).float().mean()) > 0.5,
          "resolve frame is empty")
    write_png(os.path.join("out", "torch_flagship_resolve.png"),
              ldr.cpu().numpy()[::-1])
    med = statistics.median(ms[WARMUP:])
    log(f"resolve frame {WIDTH}x{HEIGHT}: {RES_FRAMES} frames after {WARMUP} "
        f"warm-up, median {med:.3f} ms/frame device events (all "
        f"{[round(m, 3) for m in ms]}), pipelined {pipelined:.3f} ms/frame; "
        f"launches {launches} over {n_frames} frames")

    cam, ctx_i = cams[0]
    h_r = flagship_stages(geom, objects, lights, ctx, cam, ctx_i, WIDTH,
                          HEIGHT, use_resolve=True, **CUT)["hdr"]
    h_b = flagship_stages(geom, objects, lights, ctx, cam, ctx_i, WIDTH,
                          HEIGHT, **CUT)["hdr"]
    d = (h_r - h_b).abs()
    mean, over = float(d.mean()), float((d.amax(-1) > 0.05).float().mean())
    log(f"resolve vs B2 route, same camera: mean |dHDR| {mean:.3g} (< 5e-3), "
        f"pixels over 0.05 {over:.4%} (< 1%), finite "
        f"{bool(torch.isfinite(h_r).all())}")
    check(bool(torch.isfinite(h_r).all()) and mean < 5e-3 and over < 0.01,
          "resolve route differs from the B2 route")
    return launches, med, pipelined


def entry_log(tag, res):
    """Log a phase's entry of the final kernels line as the phase ends, so
    a cut or failed run still leaves its numbers."""
    keep = {k: v for k, v in res.items()
            if isinstance(v, (int, float, str, bool, dict, list))}
    log(f"# kernels entry [{tag}]: {json.dumps(keep)}")


def _b1_depth_entry(name, setup, w, h, zn, zf, mode, run, plain, dev,
                    band_h=0):
    """Kernel B1 in a depth-only mode against its plain version on the card,
    bit for bit, and its times: the wrapper (run), the kernel alone on
    prebuilt lists, the plain version; its bound."""
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    d_k = run()
    t0 = time.perf_counter()
    d_p = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mis = int((d_k != d_p).sum())
    covered = int((d_p < 1.0).sum())
    check(mis == 0 and covered > 0,
          f"{name}: {mis} depth mismatches against the plain version")
    ms = cuda_ms(run, 10)
    rec, ss, n_pad = tiled.pack_direct_records(setup, False)
    cbb = tiled._chunk_bboxes(ss, n_pad, 16)
    sl, cnt, _ = tiled._super_lists(cbb, 16, -(-w // 128), -(-h // 128), 128,
                                    128)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kern = lambda: tiled._direct_launch(  # noqa: E731
        lib, rec, cbb, sl, cnt, None, None, w, h, zn, zf, mode, False, False,
        stream, band_h)
    kern()
    kernel_ms = cuda_ms(kern, 10)
    b = bound(direct_read_bytes(rec, cbb, sl, cnt) + 4 * w * h,
              raster_pairs(setup) * RASTER_OPS)
    res = {"max_abs_err": float((d_k - d_p).abs().max()), "ms": ms,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "covered": covered,
           **b}
    log(f"{name} {w}x{h}: {mis} depth mismatches against the plain version "
        f"of {covered} covered texels; wrapper {ms:.3f} ms, kernel alone "
        f"{kernel_ms:.3f} ms, plain {plain_ms:.1f} ms; bound {b}")
    return res


def f1_entry(geom, objects, vps, size, sm, tag, enabled=None):
    """Kernel F1 (raster/slot_setup.slot_inputs) on one stack (slot_enabled
    `enabled`) against its plain version on the card, bit for bit
    (records, chunk boxes, super lists, counts), with both times and F1's
    byte bound (the records, chunk boxes and lists written)."""
    from lsr_tpu_torch.raster import slot_setup

    args = (geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
            objects.model, vps, size, sm, enabled)
    got = slot_setup.slot_inputs(*args)
    want = slot_setup.slot_inputs_plain(*args)
    torch.cuda.synchronize()
    for name in ("rec", "chunk_bb", "lists", "counts"):
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b), f"F1 {tag} stack: {name} differs from "
                                 f"slot_inputs_plain")
    ms = cuda_ms(lambda: slot_setup.slot_inputs(*args), 20)
    plain_ms = cuda_ms(lambda: slot_setup.slot_inputs_plain(*args), 3)
    b = bound(nbytes(got.rec, got.chunk_bb, got.lists, got.counts), 0)
    log(f"F1 {tag} stack ({vps.shape[0]} slots of {size}^2, "
        f"{geom.indices.shape[0]} triangles): bit for bit its plain version; "
        f"{ms:.4f} ms (plain {plain_ms:.2f} ms), {b['bytes'] / 1e6:.1f} MB "
        f"written, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": 0.0, "ms": ms, "kernel_ms": None,
            "plain_ms": plain_ms, **b, "slots": vps.shape[0], "size": size,
            "triangles": geom.indices.shape[0]}


def atlas_phase(geom, objects, lights, cam, casters, dev):
    """Phase 15.  The atlas's kernel launches against their plain versions
    on the card, bit for bit, in bench.py's ESM default (spot slots 512^2,
    cube faces 256^2): B1 on the 320x180 occluders (view-z, depth only,
    partial tiles in both axes), on one spot slot and one cube face (NDC01),
    and B1a (band_h) on both stacks against rasterize_direct's plain
    version and against one launch a slot; F1, the "map" route's front
    end, against its plain version on both stacks (f1_entry; phase 19 holds
    it on the render-path scene at 1024^2 / 512^2).  Then the "packed"
    atlas against the "map" atlas, whole-table equal, for both filters at
    their sizes.  Returns the entries {occluder, slot, band_h}."""
    from lsr_tpu_torch.frame import bench_config
    from lsr_tpu_torch.geometry.volumes import frustum_cull_objects
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.setup import (
        CULL_BACK, CULL_NONE, DEPTH_NDC01, DEPTH_VIEWZ, scene_setup_depth,
        scene_setup_slots_depth)
    from lsr_tpu_torch.scene.scene import object_world_aabbs

    wmin, wmax = object_world_aabbs(objects)
    vis = objects.visible & frustum_cull_objects(cam.viewproj, wmin, wmax)
    occ_setup = scene_setup_depth(
        geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
        objects.model, cam.viewproj, 320, 180, cull_mode=CULL_BACK,
        obj_visible=vis)
    out = {"occluder": _b1_depth_entry(
        "B1 occluder (view-z, depth only)", occ_setup, 320, 180, cam.zn,
        cam.zf, DEPTH_VIEWZ,
        lambda: tiled.rasterize_direct(occ_setup, 320, 180, cam.zn, cam.zf,
                                       track_ids=False)[0],
        lambda: rasterize_brute(occ_setup, 320, 180, cam.zn, cam.zf)[0], dev)}

    cfg = bench_config("esm", WIDTH, HEIGHT)
    plan = ls.plan_slot_stacks(lights, *casters)
    cm = objects.casts_shadow & objects.visible
    stacks = ((plan[5], cfg["local_map"]), (plan[6], cfg["local_point"]))
    for tag, (vps, size) in zip(("spot slot", "cube face"), stacks):
        # The slot of the stack with the most casters in its frustum.
        s = int((cm[None] & frustum_cull_objects(vps, wmin, wmax)).sum(1)
                .argmax())
        sm = cm & frustum_cull_objects(vps[s], wmin, wmax)
        su = scene_setup_depth(geom.positions, geom.indices, geom.vtx_obj,
                               geom.tri_obj, objects.model, vps[s], size,
                               size, cull_mode=CULL_NONE, obj_visible=sm)
        out[tag] = _b1_depth_entry(
            f"B1 {tag} {s} (NDC01, depth only)", su, size, size, 0.0, 1.0,
            DEPTH_NDC01,
            lambda su=su, size=size: tiled.rasterize_direct(
                su, size, size, 0.0, 1.0, depth_mode=DEPTH_NDC01,
                track_ids=False)[0],
            lambda su=su, size=size: rasterize_brute(
                su, size, size, 0.0, 1.0, depth_mode=DEPTH_NDC01)[0], dev)
    out["slot"] = out.pop("spot slot")
    out["slot"]["cube_face"] = out.pop("cube face")

    for tag, (vps, size) in zip(("spot", "point"), stacks):
        n = vps.shape[0]
        sm = cm[None] & frustum_cull_objects(vps, wmin, wmax)
        st = ls._stack_slot_setups(scene_setup_slots_depth(
            geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
            objects.model, vps, size, cull_mode=CULL_NONE,
            obj_visible_slots=sm), size)
        d0, t0 = targets(size, n * size, dev)
        res = _b1_depth_entry(
            f"B1a {tag} stack ({n} slots of {size} rows)", st, size,
            n * size, 0.0, 1.0, DEPTH_NDC01,
            lambda st=st, size=size, n=n: tiled.rasterize_direct(
                st, size, n * size, 0.0, 1.0, depth_mode=DEPTH_NDC01,
                track_ids=False, band_h=size)[0],
            lambda st=st, size=size, n=n, d0=d0, t0=t0: tiled._banded_brute(
                st, size, n * size, size, 0.0, 1.0, d0, t0, DEPTH_NDC01)[0],
            dev, band_h=size)
        res["f1"] = f1_entry(geom, objects, vps, size, sm, tag)
        alone = ls.render_slot_depths(geom, objects, vps, size, cm, None,
                                      False).reshape(n * size, size)
        packed = ls.render_slot_depths(geom, objects, vps, size, cm, None,
                                       True).reshape(n * size, size)
        torch.cuda.synchronize()
        check(bool((alone == packed).all()),
              f"B1a {tag} stack differs from one launch a slot")
        map_ms = cuda_ms(lambda vps=vps, size=size: ls.render_slot_depths(
            geom, objects, vps, size, cm, None, False), 3)
        packed_ms = cuda_ms(lambda vps=vps, size=size: ls.render_slot_depths(
            geom, objects, vps, size, cm, None, True), 3)
        res.update(map_ms=map_ms, packed_ms=packed_ms, slots=n, size=size)
        log(f"B1a {tag} stack equals {n} launches of one slot; the stack's "
            f"rasters: one a slot {map_ms:.3f} ms, packed {packed_ms:.3f} ms "
            f"(setups included)")
        out.setdefault("band_h", {})[tag] = res

    for filt in ("esm", "pcf"):
        c = bench_config(filt, WIDTH, HEIGHT)
        kw = dict(map_size=c["local_map"], point_size=c["local_point"],
                  pcf_radius=2, filter_mode=filt)
        a = ls.render_local_shadow_maps(geom, objects, lights, *casters, **kw)
        b = ls.render_local_shadow_maps(geom, objects, lights, *casters,
                                        atlas_packed=True, **kw)
        same = bool(torch.equal(a.spot_taps, b.spot_taps)
                    and torch.equal(a.point_taps, b.point_taps))
        log(f"atlas [{filt}, spots {c['local_map']}^2, faces "
            f"{c['local_point']}^2]: packed tables equal the map tables "
            f"{same}")
        check(same, f"packed atlas differs from the map atlas ({filt})")
    return out


def planes_phase(geom, objects, lights, ctx, cam, ctx_t, casters, dev):
    """Phase 16.  B2a and B5a (local-shadow planes) against their plain
    versions on the card at 1920x1080 with the frame's real planes and
    lights (bench.py's ESM default, light cull included), within B2_TOL;
    each kernel's time with the planes beside the planeless launch of the
    same inputs, in one call.  Returns {"b2": entry, "b5": entry}."""
    from lsr_tpu_torch.frame import bench_config, flagship_stages
    from lsr_tpu_torch.lighting import resolve_kernel as rk
    from lsr_tpu_torch.lighting import shade_kernel as sk
    from lsr_tpu_torch.lighting.light_culling import (
        tile_depth_ranges_from_buffer)
    from lsr_tpu_torch.lighting.light_walk import gbuf_walk_counts
    from lsr_tpu_torch.passes.forward_plus import resolve_inputs
    from lsr_tpu_torch.shading.common import (
        gather_materials, sample_texture_bilinear)
    from lsr_tpu_torch.shading.models import _norm
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    cfg = bench_config("esm", WIDTH, HEIGHT)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rad = ctx_t.light_color * ctx_t.light_intensity
    out = {}

    st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, WIDTH, HEIGHT,
                         casters=casters, **cfg)
    lf = dataclasses.replace(lights, enabled=st["light_enabled"])
    local, gb = st["local"], st["gb"]
    base, metal, rough, _, _, tex_id = gather_materials(
        ctx_t.materials, gb.obj_id, mat_rec=gb.mat)
    albedo = torch.clamp(base * sample_texture_bilinear(
        ctx_t.textures, tex_id, gb.uv, quads=ctx_t.texture_quads), min=0.0)
    tdr = tile_depth_ranges_from_buffer(gb.depth01, cam.zn, cam.zf, WIDTH,
                                        HEIGHT, 128, tile_h=64)
    a = (gb.world_pos, _norm(gb.normal_ws), gb.covered, albedo, metal[..., 0],
         rough[..., 0], st["sun_vis"], ctx_t.camera_pos, ctx_t.light_dir_ws,
         rad, lf, cam.view, cam.proj, WIDTH, HEIGHT, 64, 128, 256, 8, tdr,
         "pbr_mr", st["local_vis"], local.light_shadow_index)
    lit_k, _ = sk.shade_fused(*a)
    lit_p, _ = sk.shade_fused_plain(*a)
    lit_0, _ = sk.shade_fused(*(a[:21] + (None, None)))
    torch.cuda.synchronize()
    err = float((lit_k - lit_p).abs().max())
    moved = float((lit_k - lit_0).abs().max())
    check(bool(torch.isfinite(lit_k).all()) and err <= B2_TOL and moved > 0,
          f"B2a differs from its plain version ({err})")
    gbuf, trec, cnts, uni, _, _, planes = sk._prepare(*a, None, 0)
    planes = planes.contiguous()
    _, trec0, _, _, _, _, _ = sk._prepare(*(a[:21] + (None, None)), None, 0)
    k_ms = cuda_ms(lambda: sk._shade_launch(
        lib, gbuf, trec, cnts, uni, WIDTH, HEIGHT, "pbr_mr", lf.apow1, stream,
        planes), 20)
    k0_ms = cuda_ms(lambda: sk._shade_launch(
        lib, gbuf, trec0, cnts, uni, WIDTH, HEIGHT, "pbr_mr", lf.apow1,
        stream), 20)
    ms = cuda_ms(lambda: sk.shade_fused(*a), 10)
    plain_ms = cuda_ms(lambda: sk.shade_fused_plain(*a), 2)
    n_cov = int(gb.covered.sum())
    k = planes.shape[0] - 1
    walk = gbuf_walk_counts(gbuf, trec, cnts, 64, 128, 8, lf.kinds,
                            n_shadowed=k)
    # Planes: one texel for each live pair of a shadowed light.
    b = bound(nbytes(gbuf[:13], trec, cnts, uni) + 12 * WIDTH * HEIGHT
              + 4 * walk["pairs_live_shadowed"],
              walk["pairs_live"] * LIGHT_OPS + n_cov * SUN_OPS)
    out["b2"] = {"max_abs_err": err, "ms": ms, "kernel_ms": k_ms,
                 "kernel_ms_planeless": k0_ms, "plain_ms": plain_ms,
                 "planes_change": moved, "planes": k + 1, **b, **walk}
    log(f"B2a (planes, ESM default frame, {k} shadowed planes): max abs "
        f"{err:.3g} (tol {B2_TOL}), the planes move lit by up to {moved:.3g}; "
        f"kernel {k_ms:.3f} ms with planes, {k0_ms:.3f} ms planeless, "
        f"wrapper {ms:.3f} ms, plain {plain_ms:.1f} ms; bound {b}; light "
        f"walk {walk}")

    st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, WIDTH, HEIGHT,
                         use_resolve=True, casters=casters, **cfg)
    local = st["local"]
    ctx_sh = dataclasses.replace(ctx_t, shadow=st["shadow"])
    table, vis, tex, planes = resolve_inputs(
        st["setup"], st["depth"], st["tid"], ctx_sh, cam.view, cam.proj,
        cam.zn, cam.zf, WIDTH, HEIGHT, cfg["sun_vis_scale"], local)
    bg = (0.04, 0.06, 0.1)
    a = (table, st["tid"], vis, tex, ctx_t.camera_pos, ctx_t.light_dir_ws,
         rad, bg, lf, cam.view, cam.proj, WIDTH, HEIGHT, 64, 128, 256, 8,
         None, "pbr_mr", "lanes", planes, local.light_shadow_index)
    h_k, _ = rk.resolve_fused(*a)
    h_p, _ = rk.resolve_fused_plain(*a)
    h_0, _ = rk.resolve_fused(*(a[:20] + (None, None)))
    torch.cuda.synchronize()
    err = float((h_k - h_p).abs().max())
    moved = float((h_k - h_0).abs().max())
    check(bool(torch.isfinite(h_k).all()) and err <= B2_TOL and moved > 0,
          f"B5a differs from its plain version ({err})")
    uni = rk._uniforms(ctx_t.camera_pos, ctx_t.light_dir_ws, rad, bg, dev)
    trec, cnts, _ = rk._bin(lf, cam.view, cam.proj, WIDTH, HEIGHT, 64, 128,
                            256, None, planes, local.light_shadow_index)
    trec0, _, _ = rk._bin(lf, cam.view, cam.proj, WIDTH, HEIGHT, 64, 128, 256,
                          None, None, None)
    planes = planes.contiguous()
    k_ms = cuda_ms(lambda: rk._resolve_launch(
        lib, table, st["tid"], vis, tex, trec, cnts, uni, WIDTH, HEIGHT, 64,
        128, 8, "pbr_mr", stream, planes), 20)
    k0_ms = cuda_ms(lambda: rk._resolve_launch(
        lib, table, st["tid"], vis, tex, trec0, cnts, uni, WIDTH, HEIGHT, 64,
        128, 8, "pbr_mr", stream), 20)
    ms = cuda_ms(lambda: rk.resolve_fused(*a), 10)
    plain_ms = cuda_ms(lambda: rk.resolve_fused_plain(*a), 2)
    covered = st["tid"] >= 0
    n_cov = int(covered.sum())
    n_rows = int(torch.unique(st["tid"][covered]).numel())
    k = planes.shape[0] - 1
    walk = rk.walk_counts(table, st["tid"], tex, trec, cnts, WIDTH, HEIGHT,
                          64, 128, 8, lf.kinds, n_shadowed=k)
    b = bound(n_rows * 31 * 4 + WIDTH * HEIGHT * (4 + 4 + 12 + 12)
              + nbytes(trec, cnts, uni) + 4 * walk["pairs_live_shadowed"],
              walk["pairs_live"] * LIGHT_OPS
              + n_cov * (SUN_OPS + RESOLVE_OPS))
    out["b5"] = {"max_abs_err": err, "ms": ms, "kernel_ms": k_ms,
                 "kernel_ms_planeless": k0_ms, "plain_ms": plain_ms,
                 "planes_change": moved, "planes": k + 1, **b,
                 "pairs_live": walk["pairs_live"],
                 "pairs_live_shadowed": walk["pairs_live_shadowed"]}
    log(f"B5a (planes, ESM default frame, {k} shadowed planes): max abs "
        f"{err:.3g} (tol {B2_TOL}), the planes move HDR by up to {moved:.3g}; "
        f"kernel {k_ms:.3f} ms with planes, {k0_ms:.3f} ms planeless, "
        f"wrapper {ms:.3f} ms, plain {plain_ms:.1f} ms; bound {b}; light "
        f"walk {walk}")
    return out


def small_whole_phase(dev):
    """Phase 17.  The card against the CPU on the whole frame: the grid-2
    scene with SMALL_LIGHTS lights at SMALL_W x SMALL_H, bench.py's ESM
    default with a 256^2 sun map and SMALL_LOCAL^2 spot slots and cube
    faces, cull and atlas, on both routes; plain versions on the CPU,
    kernels on the card.  C1's frame contract (as phase 3): tids on >=
    99.5% of covered pixels, HDR within 1e-4 on >= 99.9% of agreeing
    pixels, tonemapped LDR within 1 LSB on >= 99.9%, after FXAA on >=
    99.5%; the cull masks equal."""
    from lsr_tpu_torch.frame import (
        bench_config, build_flagship_scene, flagship_camera, flagship_stages)
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.tonemap import tonemap_pass

    cfg = bench_config("esm", SMALL_W, SMALL_H)
    cfg.update(shadow_size=SMALL_S, local_map=SMALL_LOCAL,
               local_point=SMALL_LOCAL)
    sides = {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        geom, objects, lights, ctx = build_flagship_scene(
            SMALL_LIGHTS, SEED, grid=2, device=d)
        cam, ctx_t = flagship_camera(0, ctx, SMALL_W, SMALL_H, device=d)
        casters = plan_shadow_casters(lights)
        for route in (False, True):
            st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t,
                                 SMALL_W, SMALL_H, use_resolve=route,
                                 casters=casters, **cfg)
            tm = tonemap_pass(st["hdr"])
            sides[(str(d), route)] = (
                st["tid"].cpu(), st["hdr"].cpu(), tm.cpu(),
                fxaa_pass(tm).cpu(), st["obj_visible"].cpu(),
                st["light_enabled"].cpu())
        log(f"small whole frame on {d}: {time.perf_counter() - t0:.1f} s "
            f"(both routes)")
    for route in (False, True):
        (t_c, h_c, m_c, l_c, o_c, e_c) = sides[("cpu", route)]
        (t_g, h_g, m_g, l_g, o_g, e_g) = sides[(str(dev), route)]
        same = t_c == t_g
        tid_mis = float((~same).float().mean())
        hdr_err = (h_c - h_g).abs().amax(-1)
        hdr_ok = float((hdr_err[same] <= 1e-4).float().mean())

        def within_1(a, b):
            return float(((a.int() - b.int()).abs().amax(-1) <= 1)
                         .float().mean())

        tm_ok, ldr_ok = within_1(m_c, m_g), within_1(l_c, l_g)
        name = "resolve" if route else "b2"
        log(f"small whole frame [{name}] {SMALL_W}x{SMALL_H} (CPU plain vs "
            f"card kernels): tid mismatch {tid_mis:.4%}, HDR within 1e-4 on "
            f"{hdr_ok:.4%} of agreeing pixels (max "
            f"{float(hdr_err[same].max()):.3g}), within 1 LSB: tonemapped "
            f"{tm_ok:.4%}, after FXAA {ldr_ok:.4%}; cull masks equal "
            f"{bool(torch.equal(o_c, o_g) and torch.equal(e_c, e_g))}")
        check(torch.equal(o_c, o_g) and torch.equal(e_c, e_g),
              f"small whole frame [{name}]: the cull differs")
        check(tid_mis <= 0.005 and hdr_ok >= 0.999 and tm_ok >= 0.999
              and ldr_ok >= 0.995, f"small whole frame [{name}] differs")


def whole_frame_phase(name, geom, objects, lights, ctx, cams, dev, route,
                      b1_per_frame, png=None, **cfg):
    """Phases 4a-4d.  bench.py's whole frame, jit(make_flagship_frame(...))
    as bench.py jits it (a captured CUDA graph from the second frame on),
    counts reset: WARMUP + WHOLE_FRAMES frames along the orbit (device
    events and wall clock), the same frames again without a sync between
    them (pipelined), then exactly b1_per_frame B1 launches and one B2 (or
    B5) per frame, no G1 (the fused branch has no general-branch sum), F1
    once a stack under the "map" atlas; the visible objects and lights per
    frame (cull_frame again, after the counts are read).  Returns the
    result."""
    from lsr_tpu_torch.frame import cull_frame, make_flagship_frame
    from lsr_tpu_torch.io.png import write_png
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu_torch.utils.jit import jit

    # jit(frame), as bench.py:344 jits it: the first camera warms up, the
    # second captures, later ones replay.
    frame = jit(make_flagship_frame(geom, objects, lights, ctx, WIDTH,
                                    HEIGHT, use_resolve=route, **cfg))
    cams = cams[:WARMUP + WHOLE_FRAMES]
    reset_counts()
    ms, wall = [], []
    for cam, ctx_i in cams:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = frame(cam, ctx_i)
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ms.append(e0.elapsed_time(e1))
    t0 = time.perf_counter()
    for cam, ctx_i in cams[WARMUP:]:
        out = frame(cam, ctx_i)
    torch.cuda.synchronize()
    pipelined = (time.perf_counter() - t0) * 1e3 / WHOLE_FRAMES
    launches = read_counts()
    vis = read_vis_counts()
    n = len(cams) + WHOLE_FRAMES
    light_k = "resolve_fused.launches" if route else "shade_fused.launches"
    other_k = "shade_fused.launches" if route else "resolve_fused.launches"
    f1 = f1_per_frame(*plan_shadow_casters(lights),
                      cfg.get("atlas_packed", False))
    check(launches["rasterize_direct.launches"] == b1_per_frame * n
          and launches[light_k] == n and launches[other_k] == 0
          and launches["accumulate_local_lights.launches"] == 0
          and launches["slot_inputs.launches"] == f1 * n,
          f"{name}: launches {launches} for {n} frames (expected "
          f"{b1_per_frame} B1, {f1} F1 and one {light_k} a frame, no G1)")
    check(vis == {"vis_windows": n, "vis_planes": n},
          f"{name}: V1 / V2 launches {vis} for {n} frames (one each a "
          f"frame expected)")
    ldr = out[0]
    check(ldr.shape == (HEIGHT, WIDTH, 3) and ldr.dtype == torch.uint8
          and float((ldr.int().sum(-1) > 0).float().mean()) > 0.5,
          f"{name}: the frame is empty")
    if png:
        os.makedirs("out", exist_ok=True)
        write_png(os.path.join("out", png), ldr.cpu().numpy()[::-1])
    seen = [cull_frame(geom, objects, lights, cam)[:2] for cam, _ in cams]
    objs = [int(o.visible.sum()) for o, _ in seen]
    lits = [int(lt.enabled.sum()) for _, lt in seen]
    res = {"ms": statistics.median(ms[WARMUP:]),
           "wall_ms": statistics.median(wall[WARMUP:]),
           "pipelined_ms": pipelined, "frames": n,
           "b1_per_frame": b1_per_frame, "launches": launches,
           "vis_launches": vis, "objects_visible": objs,
           "lights_enabled": lits,
           "frame_ms_all": [round(m, 3) for m in ms]}
    log(f"{name} {WIDTH}x{HEIGHT}: {WHOLE_FRAMES} frames after {WARMUP} "
        f"warm-up, median {res['ms']:.3f} ms/frame device events (min "
        f"{min(ms[WARMUP:]):.3f}, max {max(ms[WARMUP:]):.3f}), median wall "
        f"{res['wall_ms']:.3f} ms, pipelined {pipelined:.3f} ms/frame; "
        f"launches {launches}, V1 / V2 {vis} over {n} frames; visible "
        f"objects per frame "
        f"{objs}, lights {lits} of {lights.count}")
    return res


# ---------------------------------------------------------------------------
# Kernel B2's clustered branch and the render-path presets (phases 18-22)
# ---------------------------------------------------------------------------

RP_W, RP_H = 1280, 720             # Phase F's resolution
RP_WARMUP, RP_FRAMES = 2, 5        # frames per preset (Phase F)
PHASE_I_W, PHASE_I_H = 320, 180    # Phase I's backend parity
CLUSTER_SLICES = 16
PRESETS = ("forward_classic", "forward_plus", "deferred", "tiled_deferred",
           "clustered_forward")


class shade_calls:
    """Context manager recording the arguments of every shade_fused call of
    the fused forward+ lighting (passes.forward_plus) while it is open, in
    shade_fused's parameter order: .calls [list of 27 arguments]."""

    def __enter__(self):
        import inspect

        from lsr_tpu_torch.passes import forward_plus as fpm

        self._mod, self._orig, self.calls = fpm, fpm.shade_fused, []
        sig = inspect.signature(self._orig)

        def record(*a, **k):
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            self.calls.append(list(bound.arguments.values()))
            return self._orig(*a, **k)

        fpm.shade_fused = record
        return self

    def __exit__(self, *exc):
        self._mod.shade_fused = self._orig


class module_calls:
    """Context manager recording every call of module.<name> while it is
    open: .calls [(its arguments by name, defaults filled in; its
    result)].  A module without the name records nothing."""

    def __init__(self, module, name):
        self._mod, self._name, self.calls = module, name, []

    def __enter__(self):
        import inspect

        self._orig = getattr(self._mod, self._name, None)
        if self._orig is None:
            return self
        sig = inspect.signature(self._orig)

        def record(*a, **k):
            out = self._orig(*a, **k)
            args = sig.bind(*a, **k)
            args.apply_defaults()
            self.calls.append((dict(args.arguments), out))
            return out

        setattr(self._mod, self._name, record)
        return self

    def __exit__(self, *exc):
        if self._orig is not None:
            setattr(self._mod, self._name, self._orig)


def listed_record_bytes(counts, cap):
    """The records a binned light walk must read: its listed entries (32
    f32 each) and its counts (i32); the zero slots past a count are not
    read."""
    return int(torch.clamp(counts.to(torch.int64), max=cap).sum()) * 128 \
        + 4 * counts.numel()


def b2b_check(tag, full, depth01, dev, models=("pbr_mr", "blinn_phong"),
              timed=True):
    """Kernel B2 (B2b when the call has clustered slices) against
    shade_fused_plain on the card for one call's arguments (full: the 27
    arguments of shade_fused), each sun model, within B2_TOL.  With timed,
    also the kernel alone on its prepared inputs (with the call's planes
    and without), the tiled planeless B2 launch on the same G-buffer
    (lsr_tpu's tiled_depth_range binning from depth01), the wrapper, the
    plain version, the slice walk's counts and the bound.  Returns the
    entry."""
    from lsr_tpu_torch.lighting import shade_kernel as sk
    from lsr_tpu_torch.lighting.light_culling import (
        tile_depth_ranges_from_buffer)
    from lsr_tpu_torch.lighting.light_walk import gbuf_walk_counts
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    a = list(full)
    kind = "B2b" if a[24] else "B2"
    worst = 0.0
    for model in models:
        a[20] = model
        lit_k, stats = sk.shade_fused(*a)
        lit_p, _ = sk.shade_fused_plain(*a)
        torch.cuda.synchronize()
        err = float((lit_k - lit_p).abs().max())
        finite = bool(torch.isfinite(lit_k).all())
        log(f"{kind} [{tag}, {model}]: max abs {err:.3g} (tol {B2_TOL}), "
            f"max |lit| {float(lit_p.abs().max()):.4g}, max lights/list "
            f"{int(stats['max_count'])}, finite {finite}")
        check(finite and err <= B2_TOL, f"{kind} {tag} {model} differs")
        worst = max(worst, err)
    if not timed:
        return {"max_abs_err": worst}
    a[20] = "pbr_mr"
    width, height, lights, slices = a[13], a[14], a[10], a[24]
    gbuf, trec, cnts, uni, _, _, planes = sk._prepare(*a)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(rec, p, sl, g=gbuf, c=cnts):
        return lambda: sk._shade_launch(lib, g, rec, c, uni, width, height,
                                        "pbr_mr", lights.apow1, stream, p,
                                        sl)

    planes = None if planes is None else planes.contiguous()
    launch(trec, planes, slices)()
    kernel_ms = cuda_ms(launch(trec, planes, slices), 20)
    kernel_ms_planeless = kernel_ms
    if planes is not None:
        _, trec0, _, _, _, _, _ = sk._prepare(*(a[:21] + [None, None]
                                                + a[23:]))
        kernel_ms_planeless = cuda_ms(launch(trec0, None, slices), 20)
    tdr = tile_depth_ranges_from_buffer(depth01, a[25], a[26], width, height,
                                        128, tile_h=64)
    gbuf_t, trec_t, cnts_t = sk._prepare(*(a[:19] + [tdr, "pbr_mr", None,
                                                     None, None, 0]))[:3]
    tiled_ms = cuda_ms(launch(trec_t, None, 0, gbuf_t, cnts_t), 20)
    ms = cuda_ms(lambda: sk.shade_fused(*a), 10)
    plain_ms = cuda_ms(lambda: sk.shade_fused_plain(*a), 2)
    n_shadowed = 0 if planes is None else planes.shape[0] - 1
    walk = gbuf_walk_counts(gbuf, trec, cnts, 64, 128, 8, lights.kinds,
                            n_shadowed=n_shadowed, slices=slices)
    n_cov = int((gbuf[6] > 0).sum())
    cap = trec.shape[1] // slices
    # Bytes: 13 G-buffer planes and the slice plane, the listed records and
    # the counts, the uniforms, the output, one plane texel per live pair
    # of a shadowed light.
    b = bound(nbytes(gbuf[:14], uni) + listed_record_bytes(cnts, cap)
              + 12 * width * height + 4 * walk["pairs_live_shadowed"],
              walk["pairs_live"] * LIGHT_OPS + n_cov * SUN_OPS)
    res = {"max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms,
           "kernel_ms_planeless": kernel_ms_planeless,
           "tiled_kernel_ms_planeless": tiled_ms, "plain_ms": plain_ms,
           "slices": slices, "cap": cap, "planes": n_shadowed + 1
           if planes is not None else 0,
           "slices_in_use": int(torch.unique(gbuf[13][gbuf[6] > 0]).numel()),
           "clusters_listed": int((cnts > 0).sum()),
           "records_listed": int(torch.clamp(cnts, max=cap).sum()),
           "record_table_bytes": nbytes(trec), **b,
           **{k: walk[k] for k in ("pairs_walked", "pairs_binned",
                                   "pairs_live", "pairs_live_shadowed",
                                   "pairs_after_warp_box",
                                   "pairs_after_box_and_vote")}}
    log(f"B2b [{tag}] {width}x{height}, {slices} slices, cap {cap}: kernel "
        f"{kernel_ms:.3f} ms ({kernel_ms_planeless:.3f} planeless), tiled "
        f"B2 planeless on the same G-buffer {tiled_ms:.3f} ms, wrapper "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms; bound {b}; slice walk "
        f"{walk}; registers / spilled bytes "
        f"{resources_of('shade_fused.cu')}")
    return res


def b2b_phase(geom, objects, lights, ctx, cam, ctx_t, casters, dev):
    """Phase 18.  Kernel B2b (clustered slices) against its plain version on
    the card at 1920x1080 on the flagship scene's ESM default frame (cull,
    atlas, its real planes): 16 slices, cap 256, planeless and with the
    planes, pbr_mr and blinn_phong; its times beside the tiled planeless B2
    launch on the same G-buffer, and the counts of the slice walk."""
    from lsr_tpu_torch.frame import bench_config, flagship_stages
    from lsr_tpu_torch.lighting.light_culling import (
        view_depth_to_cluster_slice)
    from lsr_tpu_torch.shading.common import (
        gather_materials, sample_texture_bilinear)
    from lsr_tpu_torch.shading.models import _norm

    st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, WIDTH,
                         HEIGHT, casters=casters,
                         **bench_config("esm", WIDTH, HEIGHT))
    gb = st["gb"]
    base, metal, rough, _, _, tex_id = gather_materials(
        ctx_t.materials, gb.obj_id, mat_rec=gb.mat)
    albedo = torch.clamp(base * sample_texture_bilinear(
        ctx_t.textures, tex_id, gb.uv, quads=ctx_t.texture_quads), min=0.0)
    zn_t, zf_t = cam.zn, cam.zf
    sp = view_depth_to_cluster_slice(zn_t + gb.depth01 * (zf_t - zn_t),
                                     cam.zn, cam.zf, CLUSTER_SLICES)
    full = [gb.world_pos, _norm(gb.normal_ws), gb.covered, albedo,
            metal[..., 0], rough[..., 0], st["sun_vis"], ctx_t.camera_pos,
            ctx_t.light_dir_ws, ctx_t.light_color * ctx_t.light_intensity,
            dataclasses.replace(lights, enabled=st["light_enabled"]),
            cam.view, cam.proj, WIDTH, HEIGHT, 64, 128, 256, 8, None,
            "pbr_mr", None, None, sp, CLUSTER_SLICES, cam.zn, cam.zf]
    b2b_check("flagship ESM frame, planeless", full, gb.depth01, dev,
              timed=False)
    full[21:23] = [st["local_vis"], st["local"].light_shadow_index]
    return b2b_check("flagship ESM frame, planes", full, gb.depth01, dev)


def _contact_sheet(frames, cols=3):
    """(H, W, 3) uint8 frames at half size in a grid of `cols` columns, the
    empty cells black; row 0 of the result is the top row."""
    small = [f[::2, ::2].cpu() for f in frames]
    h, w = small[0].shape[:2]
    rows = -(-len(small) // cols)
    sheet = torch.zeros((rows * h, cols * w, 3), dtype=torch.uint8)
    for k, f in enumerate(small):
        r, c = divmod(k, cols)
        # The frames' row 0 is the bottom row (as out/torch_flagship.png).
        sheet[r * h:(r + 1) * h, c * w:(c + 1) * w] = f.flip(0)
    return sheet.numpy()


def _frames(fn, n, warmup, pipelined=True):
    """fn(i) for i < n, each bracketed by CUDA events, then (pipelined)
    frames warmup..n again with one sync at the end.  Returns (device ms
    per frame, pipelined ms per frame or None, the outputs of the first
    pass)."""
    ms, outs = [], []
    for i in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs.append(fn(i))
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    if not pipelined:
        return ms, None, outs
    t0 = time.perf_counter()
    for i in range(warmup, n):
        fn(i)
    torch.cuda.synchronize()
    return ms, (time.perf_counter() - t0) * 1e3 / (n - warmup), outs


def _timing(ms, pipelined, warmup, nf, b1_per_frame, launches, pass_ms):
    return {"ms": statistics.median(ms[warmup:]), "ms_min": min(ms[warmup:]),
            "ms_max": max(ms[warmup:]), "pipelined_ms": pipelined,
            "frames": nf, "b1_per_frame": b1_per_frame, "launches": launches,
            "pass_ms": {k: round(v, 3) for k, v in pass_ms.items()},
            "frame_ms_all": [round(m, 3) for m in ms]}


def _path_run(kind, name, fn, pipe, fp, state_fn, b2_per_frame,
              g1_per_frame=0):
    """One render path at Phase F's resolution, a main path of its own:
    counts reset just before and read just after RP_WARMUP + RP_FRAMES
    frames by CUDA events and the same frames pipelined; exactly 3 + one
    per atlas slot B1 launches a frame (the occluders, the sun map, the
    camera and every slot: a slot of a light the cull disabled is launched
    with its setup masked), F1 once a stack, b2_per_frame B2 and
    g1_per_frame G1 launches, nothing else;
    then execute_segmented's per-pass device ms of frame 0.  Returns the
    result."""
    from lsr_tpu_torch.pipeline.executor import RenderContext

    lp = fp.pass_params.local_shadow
    b1_per_frame = 3 + len(lp.spot_ids) + 6 * len(lp.point_ids)
    n = RP_WARMUP + RP_FRAMES
    nf = n + RP_FRAMES
    for i in range(n):
        state_fn(i)                   # the orbit's cameras, built once
    pipe.reset_history()
    reset_counts()
    ms, pipelined, outs = _frames(fn, n, RP_WARMUP)
    launches = read_counts()
    want = expected({
        "rasterize_direct.launches": b1_per_frame * nf,
        "shade_fused.launches": b2_per_frame * nf,
        "accumulate_local_lights.launches": g1_per_frame * nf,
        "slot_inputs.launches": f1_per_frame(lp.spot_ids, lp.point_ids) * nf})
    check(launches == want, f"{kind} {name}: launches {launches} for {nf} "
          f"frames, expected {want}")
    ldr = outs[-1]
    check(ldr.shape == (RP_H, RP_W, 3) and ldr.dtype == torch.uint8
          and float((ldr.int().sum(-1) > 0).float().mean()) > 0.5,
          f"{kind} {name}: the frame is empty")
    ctx = RenderContext()
    pipe.reset_history()
    pipe.execute_segmented(ctx, state_fn(0), fp)
    res = _timing(ms, pipelined, RP_WARMUP, nf, b1_per_frame, launches,
                  ctx.debug.pass_ms)
    log(f"{kind} {name} {RP_W}x{RP_H} (PCF, sun "
        f"{fp.pass_params.shadow.map_size}^2, slots {lp.map_size}^2, "
        f"faces {lp.point_size}^2): {RP_FRAMES} frames after {RP_WARMUP} "
        f"warm-up, median {res['ms']:.3f} ms/frame [min {res['ms_min']:.3f}, "
        f"max {res['ms_max']:.3f}] device events, pipelined {pipelined:.3f} "
        f"ms/frame; launches {launches} over {nf} frames; execute_segmented "
        f"pass ms {res['pass_ms']}")
    return res


def render_paths_phase(dev):
    """Phases 19-20, the render-path main paths (Phase F of
    scripts/run_phases.py): lsr_tpu's five presets through
    render_paths.build_preset_pipelines at 1280x720 with the exact PCF
    filter (sun 2048^2, spot slots 1024^2, cube faces 512^2), on the card.
    Per preset, counts reset just before and read just after it: RP_WARMUP
    + RP_FRAMES frames along the orbit (CUDA events per frame), the same
    frames again without a sync between them (pipelined); exactly 3 + 20
    B1 launches a frame (the occluders, the sun map, the camera and every
    atlas slot: a slot of a light the cull disabled is launched with its
    setup masked), F1 once a stack and one B2 launch, nothing else.  Then
    execute_segmented's per-pass device ms for frame 0, kernel B2b against
    its plain version on clustered_forward's own launch (phase 20), kernel
    F1 against its plain version on the scene's two stacks (f1_paths), and
    the contact sheet out/torch_render_paths.png.  Returns {preset: result,
    "b2b": B2b's entry, "f1": F1's entries}."""
    from lsr_tpu_torch.io.png import write_png
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.render_paths import build_preset_pipelines

    fns, pipes = build_preset_pipelines(RP_W, RP_H, set(PRESETS), device=dev,
                                        with_pipes=True)
    out, frames = {}, []
    for name in PRESETS:
        pipe, fp, state_fn = pipes[name]
        out[name] = _path_run("preset", name, fns[name], pipe, fp, state_fn,
                              1)
        frames.append(fns[name](0))
    os.makedirs("out", exist_ok=True)
    write_png(os.path.join("out", "torch_render_paths.png"),
              _contact_sheet(frames))
    # The launch's arguments are recorded on execute(), the same frame as
    # execute_jitted's bit for bit (phase 31), whose replays run no Python.
    pipe, fp, state_fn = pipes["clustered_forward"]
    with shade_calls() as sc:
        st = pipe.execute(RenderContext(), state_fn(0), fp)
    check(len(sc.calls) == 1 and sc.calls[0][24] == CLUSTER_SLICES,
          "clustered_forward did not light through B2b")
    out["b2b"] = b2b_check("render-path scene, clustered_forward",
                           sc.calls[0], st["gbuffer"].depth01, dev)
    out["f1"] = f1_paths(pipes["forward_classic"], dev)
    return out


def f1_paths(path, dev):
    """Kernel F1 against its plain version (f1_entry) on the render-path
    scene's two stacks at its atlas sizes, each slot enabled as
    LocalShadowsPass enables it (the light's cull flag).  Returns {stack:
    entry}."""
    from lsr_tpu_torch.core.util import device_const
    from lsr_tpu_torch.geometry.volumes import frustum_cull_objects
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.scene.scene import object_world_aabbs

    _, fp, state_fn = path
    lp = fp.pass_params.local_shadow
    st = state_fn(0)
    geom, objects, lights = st["geom"], st["objects"], st["lights"]
    plan = ls.plan_slot_stacks(lights, lp.spot_ids, lp.point_ids)
    en = lights.enabled[device_const(list(lp.spot_ids) + list(lp.point_ids),
                                     dev, torch.int64)].to(torch.bool)
    n_spot = len(lp.spot_ids)
    wmin, wmax = object_world_aabbs(objects)
    cm = objects.casts_shadow & objects.visible
    out = {}
    for tag, vps, size, e in (
            ("spot", plan[5], lp.map_size, en[:n_spot]),
            ("point", plan[6], lp.point_size,
             en[n_spot:].repeat_interleave(6))):
        sm = cm[None] & frustum_cull_objects(vps, wmin, wmax)
        out[tag] = f1_entry(geom, objects, vps, size, sm,
                            f"render-path {tag}", e)
    return out


def phase_i_phase(dev):
    """Phase 21, Phase I's backend parity on the card: each preset at
    320x180 (spot slots 256^2, cube faces 128^2), the camera through B1
    (use_tiled_raster=True) against rasterize_brute (False), three frames
    each.  Depth and tid equal on every pixel but stray sliver ones (C8),
    LDR within 1 LSB on >= 99.9% of pixels."""
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.render_paths import build_preset_pipelines

    sides = [build_preset_pipelines(
        PHASE_I_W, PHASE_I_H, set(PRESETS), use_tiled=tiled, local_map=256,
        local_point=128, device=dev, with_pipes=True)[1]
        for tiled in (True, False)]
    for name in PRESETS:
        for i in range(3):
            a, b = (pipe.execute_jitted(RenderContext(), state_fn(i), fp)
                    for pipe, fp, state_fn in (s[name] for s in sides))
            same_but_strays(f"phase I {name} frame {i} (B1 vs brute)",
                            a["depth"], a["tid"], a["setup"].bbox,
                            b["depth"], b["tid"], b["setup"].bbox, True)
            lsb = float(((a["ldr"].int() - b["ldr"].int()).abs().amax(-1)
                         <= 1).float().mean())
            check(lsb >= 0.999, f"phase I {name} frame {i}: LDR within 1 "
                  f"LSB on {lsb:.4%}")
        log(f"phase I {name} {PHASE_I_W}x{PHASE_I_H}: 3 frames, LDR within "
            f"1 LSB on {lsb:.4%} (last frame)")


def render_paths_cpu_phase(dev):
    """Phase 22.  The card against the CPU through the pipeline: each preset
    at 192x108 (sun 256^2, spot slots and cube faces 128^2, 8 slices),
    plain versions on the CPU, kernels on the card, under phase 3's
    contract (tids on >= 99.5% of covered pixels, HDR within 1e-4 on >=
    99.9% of agreeing pixels, tonemapped LDR within 1 LSB on >= 99.9%,
    after FXAA on >= 99.5%); the cull masks equal."""
    from lsr_tpu_torch.passes.tonemap import tonemap_pass
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.render_paths import build_preset_pipelines

    sides = {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        pipes = build_preset_pipelines(SMALL_W, SMALL_H, set(PRESETS),
                                       local_map=SMALL_LOCAL,
                                       local_point=SMALL_LOCAL, device=d,
                                       with_pipes=True)[1]
        for name in PRESETS:
            pipe, fp, state_fn = pipes[name]
            fp.pass_params.shadow.map_size = SMALL_S
            fp.technique.cluster_slices = 8
            st = pipe.execute_jitted(RenderContext(), state_fn(0), fp)
            sides[(str(d), name)] = tuple(t.cpu() for t in (
                st["tid"], st["hdr"], tonemap_pass(st["hdr"]), st["ldr"],
                st["view_mask"], st["lights"].enabled))
        log(f"render paths on {d} at {SMALL_W}x{SMALL_H}: "
            f"{time.perf_counter() - t0:.1f} s (five presets)")

    def within_1(a, b):
        return float(((a.int() - b.int()).abs().amax(-1) <= 1)
                     .float().mean())

    for name in PRESETS:
        t_c, h_c, m_c, l_c, o_c, e_c = sides[("cpu", name)]
        t_g, h_g, m_g, l_g, o_g, e_g = sides[(str(dev), name)]
        same = t_c == t_g
        tid_mis = float((~same).float().mean())
        hdr_err = (h_c - h_g).abs().amax(-1)
        hdr_ok = float((hdr_err[same] <= 1e-4).float().mean())
        tm_ok, ldr_ok = within_1(m_c, m_g), within_1(l_c, l_g)
        masks = bool(torch.equal(o_c, o_g) and torch.equal(e_c, e_g))
        log(f"render path [{name}] {SMALL_W}x{SMALL_H} (CPU plain vs card "
            f"kernels): tid mismatch {tid_mis:.4%}, HDR within 1e-4 on "
            f"{hdr_ok:.4%} of agreeing pixels (max "
            f"{float(hdr_err[same].max()):.3g}), within 1 LSB: tonemapped "
            f"{tm_ok:.4%}, after FXAA {ldr_ok:.4%}; cull masks equal "
            f"{masks}")
        check(masks, f"render path [{name}]: the cull differs")
        check(tid_mis <= 0.005 and hdr_ok >= 0.999 and tm_ok >= 0.999
              and ldr_ok >= 0.995, f"render path [{name}] differs")


# ---------------------------------------------------------------------------
# lsr_tpu's compositions: forward_plus+full, forward_classic+ssao, Config #5
# and the post-stack sweep (phases 23-25)
# ---------------------------------------------------------------------------

FULL_W, FULL_H = 800, 600          # Config #5 (demos/hello_full_pipeline.py)
FULL_FRAMES = 5                    # Config #5 frames after warm-up
SWEEP_STACKS = ("minimal", "default", "temporal", "full")
SWEEP_FRAMES = 3                   # frames per path and stack (Phase I-posts)
LIGHTING_PASSES = ("pbr_forward", "pbr_forward_plus", "pbr_forward_clustered",
                   "deferred_lighting", "deferred_lighting_tiled")


def compositions_phase(dev):
    """Phase 23, Phase F's compositions at 1280x720 on the presets' workload
    (PCF, sun 2048^2, spot slots 1024^2, cube faces 512^2, the cull at
    320x180): forward_plus under the "full" post stack (light shafts,
    motion blur, bloom, depth of field, TAA, FXAA; run_phases.py:383-393)
    and the forward_classic+ssao composition, each a main path of its own,
    counts reset just before and read just after it: RP_WARMUP + RP_FRAMES
    frames by CUDA events and the same frames pipelined; exactly 3 + 20 B1
    launches a frame (the post passes and SSAO add none), one B2 a frame in
    forward_plus+full and none in the SSAO composition (its SSAO mask sends
    the lighting down the general branch, as in lsr_tpu, whose local-light
    sum is one G1 launch a frame); execute_segmented's
    per-pass device ms; the SSAO composition's LDR differs from
    forward_classic's (run_phases.py:292-300); kernel B2 against its plain
    version on forward_plus+full's own launch (one more frame, after the
    counts are read), within B2_TOL.  Returns {name: result}."""
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.render_paths import (
        build_forward_plus_full, build_preset_pipelines)

    fns, pipes = build_preset_pipelines(
        RP_W, RP_H, {"forward_classic", "forward_classic+ssao"}, device=dev,
        with_pipes=True)
    more = build_forward_plus_full(RP_W, RP_H, device=dev, with_pipes=True)
    fns.update(more[0])
    pipes.update(more[1])
    out = {}
    for name, b2_per_frame in (("forward_plus+full", 1),
                               ("forward_classic+ssao", 0)):
        pipe, fp, state_fn = pipes[name]
        out[name] = _path_run("composition", name, fns[name], pipe, fp,
                              state_fn, b2_per_frame, 1 - b2_per_frame)
    pipe, fp, state_fn = pipes["forward_plus+full"]
    with shade_calls() as sc:      # on execute(), as in phase 20
        st = pipe.execute(RenderContext(), state_fn(0), fp)
    check(len(sc.calls) == 1, "forward_plus+full did not light through B2")
    out["forward_plus+full"]["b2_max_abs_err"] = b2b_check(
        "forward_plus+full", sc.calls[0], st["gbuffer"].depth01, dev,
        timed=False)["max_abs_err"]
    pipes["forward_classic+ssao"][0].reset_history()
    ssao = fns["forward_classic+ssao"](0)
    classic = fns["forward_classic"](0)
    differ = float((ssao != classic).any(-1).float().mean())
    log(f"composition forward_classic+ssao: LDR differs from "
        f"forward_classic's on {differ:.4%} of pixels (frame 0)")
    check(differ > 0.0, "SSAO does not change the image")
    out["forward_classic+ssao"]["ldr_differs_from_classic"] = differ
    return out


def full_pipeline_phase(dev):
    """Phase 24, Config #5 (demos/hello_full_pipeline.py through
    lsr_tpu_torch.full_pipeline) at 800x600 with TAA on: the IBL baked on
    the card from the procedural sky (timed), then RP_WARMUP + FULL_FRAMES
    frames of the still camera, TAA's history carried by the pipeline,
    counts reset just before: exactly 2 B1 launches a frame (sun map,
    camera) and one B2 (tiled deferred with the tile depth range); the
    moving object's velocity over 0.1 px and every other pixel's under
    1e-3 px (zero but for the float32 inverse of each model); frame
    1 differs from frame 0 (the history); execute_segmented's pass ms; the
    last frame written to out/torch_full_pipeline.png.  Then, after the
    counts are read, the path's own kernel launches against their plain
    versions (config5_kernel_checks)."""
    from lsr_tpu_torch.full_pipeline import (
        MOVING, bake_ibl, build_full_pipeline, full_scene, write_frame_png)
    from lsr_tpu_torch.pipeline.executor import RenderContext

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    ibl = bake_ibl(dev)
    e1.record()
    torch.cuda.synchronize()
    bake = {"ms": e0.elapsed_time(e1),
            "wall_ms": (time.perf_counter() - t0) * 1e3}
    state = full_scene(FULL_W, FULL_H, ibl=ibl, device=dev)
    frame_fn, pipe, fp = build_full_pipeline(FULL_W, FULL_H, taa=True,
                                             state=state, device=dev)
    n = RP_WARMUP + FULL_FRAMES
    nf = n + FULL_FRAMES
    reset_counts()
    ms, pipelined, outs = _frames(frame_fn, n, RP_WARMUP)
    launches = read_counts()
    want = expected({"rasterize_direct.launches": 2 * nf,
                     "shade_fused.launches": nf})
    check(launches == want, f"Config #5: launches {launches} for {nf} "
          f"frames, expected {want}")
    st0, st1 = outs[0], outs[1]
    vel, obj = st0["velocity"], st0["gbuffer"].obj_id
    speed = vel.abs().sum(-1)
    moving = obj == MOVING
    # A still object's prev_model @ inverse(model) is the identity up to
    # the float32 inverse's rounding: its velocity is zero to ~1e-5 px.
    still_max = float(speed[~moving].max())
    check(bool(moving.any()) and float(speed[moving].min()) > 0.1
          and still_max < 1e-3,
          f"Config #5: velocity is not the moving object's alone (moving "
          f"min {float(speed[moving].min()):.3g} px, still max "
          f"{still_max:.3g} px)")
    check(not torch.equal(st0["hdr"], st1["hdr"]),
          "Config #5: TAA's history is not carried")
    ldr = outs[-1]["ldr"]
    check(ldr.shape == (FULL_H, FULL_W, 3) and ldr.dtype == torch.uint8
          and bool(torch.isfinite(outs[-1]["hdr"]).all()),
          "Config #5: bad frame")
    os.makedirs("out", exist_ok=True)
    write_frame_png(os.path.join("out", "torch_full_pipeline.png"), ldr)
    ctx = RenderContext()
    pipe.execute_segmented(ctx, state, fp)
    res = _timing(ms, pipelined, RP_WARMUP, nf, 2, launches,
                  ctx.debug.pass_ms)
    res.update(ibl_bake=bake, moving_px=int(moving.sum()),
               max_speed_px=float(speed.max()), still_max_speed_px=still_max,
               **config5_kernel_checks(pipe, fp, state, dev))
    log(f"Config #5 {FULL_W}x{FULL_H} (TAA on): IBL bake {bake['ms']:.3f} ms "
        f"device ({bake['wall_ms']:.1f} ms wall); {FULL_FRAMES} frames after "
        f"{RP_WARMUP} warm-up, median {res['ms']:.3f} ms/frame [min "
        f"{res['ms_min']:.3f}, max {res['ms_max']:.3f}], pipelined "
        f"{pipelined:.3f} ms/frame; launches {launches} over {nf} frames; "
        f"moving object {res['moving_px']} px, max speed "
        f"{res['max_speed_px']:.3f} px (still pixels at most "
        f"{still_max:.3g} px); execute_segmented pass ms "
        f"{res['pass_ms']}")
    return res


def config5_kernel_checks(pipe, fp, state, dev):
    """Config #5's own kernel launches against their plain versions at
    800x600: one frame's B2 call (the tile depth range) within B2_TOL; its
    camera raster (B1) against the same pipeline's frame with
    use_tiled_raster off (rasterize_brute), as phase 21; its sun map (B1,
    NDC01, spatial sort, fp's map size) against rasterize_brute on the
    same setup, launched once more with ids tracked so that a stray sliver
    winner can be told apart (C8), and the depth-only map the shadow pass
    renders equal to that launch's depth bit for bit.  Returns the
    figures."""
    from lsr_tpu_torch.full_pipeline import build_full_pipeline
    from lsr_tpu_torch.passes.shadow import render_shadow_map, shadow_map_setup
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.setup import DEPTH_NDC01

    with shade_calls() as sc:      # on execute(), as in phase 20
        a = pipe.execute(RenderContext(), state, fp)
    check(len(sc.calls) == 1, "Config #5 did not light through B2")
    b2_err = b2b_check("Config #5, tiled depth range", sc.calls[0],
                       a["gbuffer"].depth01, dev, timed=False)["max_abs_err"]
    _, pipe_b, fp_b = build_full_pipeline(FULL_W, FULL_H, taa=True,
                                          state=state, device=dev)
    fp_b.use_tiled_raster = False
    b = pipe_b.execute_jitted(RenderContext(), state, fp_b)
    cam_px = same_but_strays(
        f"Config #5 camera {FULL_W}x{FULL_H} (B1 vs brute)", a["depth"],
        a["tid"], a["setup"].bbox, b["depth"], b["tid"], b["setup"].bbox,
        True)
    size, geom, objects = (fp.pass_params.shadow.map_size, state["geom"],
                           state["objects"])
    sun = state["shade_ctx"].light_dir_ws
    setup, _ = shadow_map_setup(geom, objects, sun, size)
    d_k, t_k, _ = tiled.rasterize_direct(
        setup, size, size, 0.0, 1.0, depth_mode=DEPTH_NDC01, tile_h=128,
        tile_w=128, spatial_sort=True)
    d_m, _ = render_shadow_map(geom, objects, sun, size)
    d_p, t_p = rasterize_brute(setup, size, size, 0.0, 1.0,
                               depth_mode=DEPTH_NDC01)
    check(torch.equal(d_m, d_k) and bool((t_p >= 0).any()),
          "Config #5: the sun map differs from its launch with ids")
    sun_px = same_but_strays(f"Config #5 sun map {size}^2 (B1 vs brute)",
                             d_k, t_k, setup.bbox, d_p, t_p, setup.bbox, True)
    return {"b2_max_abs_err": b2_err, "b1_camera_px_differ": cam_px,
            "b1_sun_map_px_differ": sun_px}


def post_sweep_phase(dev):
    """Phase 25, Phase I-posts (run_phases.py:334-370) at 320x180 (spot
    slots 256^2, cube faces 128^2): every preset and the SSAO composition
    under each post stack of SWEEP_STACKS, SWEEP_FRAMES frames each; per
    path the stacks' last LDR frames must be distinct images (4 of 4)."""
    import hashlib

    from lsr_tpu_torch.render_paths import (
        POST_STACK_PRESETS, build_preset_pipelines)

    names = PRESETS + ("forward_classic+ssao",)
    hashes = {}
    t0 = time.perf_counter()
    for sname in SWEEP_STACKS:
        fns = build_preset_pipelines(
            PHASE_I_W, PHASE_I_H, set(names), post=POST_STACK_PRESETS[sname],
            local_map=256, local_point=128, device=dev)
        for name in names:
            for i in range(SWEEP_FRAMES):
                ldr = fns[name](i)
            hashes[(name, sname)] = hashlib.sha1(
                ldr.cpu().numpy().tobytes()).hexdigest()
    distinct = {}
    for name in names:
        distinct[name] = len({hashes[(name, s)] for s in SWEEP_STACKS})
        log(f"phase I-posts {name} {PHASE_I_W}x{PHASE_I_H}: "
            f"{distinct[name]}/{len(SWEEP_STACKS)} distinct stack images")
    log(f"phase I-posts: {len(hashes)} paths x stacks in "
        f"{time.perf_counter() - t0:.1f} s")
    check(all(v == len(SWEEP_STACKS) for v in distinct.values()),
          f"post stacks give the same image: {distinct}")
    return distinct


class pass_outputs:
    """Context manager keeping, while it is open, the state that each pass
    of `pipe` whose id is in `pids` returns on the pipeline's own executor:
    .states {pass id: state}."""

    def __init__(self, pipe, pids):
        self._passes = [p for p in pipe.passes if p.pass_id in pids]

    def __enter__(self):
        self.states = {}
        for p in self._passes:
            def record(ctx, state, fp, req, run=p.execute_resolved,
                       pid=p.pass_id):
                self.states[pid] = run(ctx, state, fp, req)
                return self.states[pid]

            p.execute_resolved = record       # the instance's, for now
        return self

    def __exit__(self, *exc):
        for p in self._passes:
            del p.execute_resolved


def ssao_reach(mask, samples=12, radius_px=8.0):
    """(H, W) bool: the pixels whose SSAO (ssao_depth_pass: its taps, each
    an edge-clamped shift, then the 3x3 box that wraps around) reads a
    depth at a pixel of `mask`."""
    from lsr_tpu_torch.passes.post import _shift_clamped
    from lsr_tpu_torch.passes.ssao import tap_offsets

    m = mask.to(torch.float32)
    read = m
    for ox, oy in tap_offsets(samples, radius_px):
        read = torch.maximum(read, _shift_clamped(_shift_clamped(m, oy, 0),
                                                  ox, 1))
    out = torch.zeros_like(read)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = torch.maximum(out, torch.roll(torch.roll(read, dy, dims=0),
                                                dx, dims=1))
    return out > 0


def compositions_cpu_phase(dev):
    """Phase 25 (end).  The card against the CPU at 192x108 (sun 256^2,
    spot slots and cube faces 128^2) for forward_plus+full,
    forward_classic+ssao and Config #5 (TAA on, frame 0), plain versions on
    the CPU, kernels on the card, each frame run by the pipeline's own
    executor (execute_jitted) with the lighting pass's HDR kept: phase 3's
    contract on that HDR (tids on >= 99.5% of covered pixels, HDR within
    1e-4 on >= 99.9% of agreeing pixels, tonemapped LDR within 1 LSB on >=
    99.9%), where a pixel agrees when its tid and its SSAO mask agree; on
    the final frame HDR within 1e-4 on >= 99.5% of agreeing pixels (the
    depth of field and bloom spread a pixel's difference over their
    windows) and the LDR within 1 LSB on >= 99.5% (after FXAA, as phase
    22).  The SSAO mask, whose taps compare depths, may move by a tap
    (over 1e-5) on <= 0.5% of covered pixels, and only where the two
    sides' depth buffers differ: every such pixel must read a differing
    depth (ssao_reach), and the card's SSAO on the CPU's depth must give
    the CPU's mask within 1e-5."""
    from lsr_tpu_torch.full_pipeline import build_full_pipeline, full_scene
    from lsr_tpu_torch.passes.ssao import ssao_depth_pass
    from lsr_tpu_torch.passes.tonemap import tonemap_pass
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.render_paths import (
        build_forward_plus_full, build_preset_pipelines)

    sides = {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        runs = {}
        kw = dict(local_map=SMALL_LOCAL, local_point=SMALL_LOCAL, device=d,
                  with_pipes=True)
        runs.update(build_forward_plus_full(SMALL_W, SMALL_H, **kw)[1])
        runs.update(build_preset_pipelines(
            SMALL_W, SMALL_H, {"forward_classic+ssao"}, **kw)[1])
        runs = {k: (pipe, fp, state_fn(0))
                for k, (pipe, fp, state_fn) in runs.items()}
        state = full_scene(SMALL_W, SMALL_H, device=d)
        _, pipe, fp = build_full_pipeline(SMALL_W, SMALL_H, taa=True,
                                          state=state, device=d)
        runs["config5"] = (pipe, fp, state)
        for name, (pipe, fp, st0) in runs.items():
            fp.pass_params.shadow.map_size = SMALL_S
            pipe.reset_history()
            with pass_outputs(pipe, LIGHTING_PASSES) as po:
                st = pipe.execute_jitted(RenderContext(), st0, fp)
            check(len(po.states) == 1, f"{name}: not one lighting pass")
            lit = next(iter(po.states.values()))["hdr"]
            ao = st.get("ssao_mask")
            sides[(str(d), name)] = tuple(t.cpu() for t in (
                st["tid"], lit, tonemap_pass(lit), st["hdr"], st["ldr"],
                torch.ones_like(lit[..., 0]) if ao is None else ao,
                st["depth"])) + ((st["camera"].zn, st["camera"].zf),)
        log(f"compositions on {d} at {SMALL_W}x{SMALL_H}: "
            f"{time.perf_counter() - t0:.1f} s")

    def within_1(a, b):
        return float(((a.int() - b.int()).abs().amax(-1) <= 1)
                     .float().mean())

    for name in ("forward_plus+full", "forward_classic+ssao", "config5"):
        t_c, lit_c, m_c, h_c, l_c, ao_c, d_c, (zn, zf) = sides[("cpu", name)]
        t_g, lit_g, m_g, h_g, l_g, ao_g, d_g, _ = sides[(str(dev), name)]
        tid_mis = float((t_c != t_g).float().mean())
        ao_flip = (ao_c - ao_g).abs() > 1e-5
        ao_mis = float(ao_flip[t_c >= 0].float().mean())
        d_diff = d_c != d_g
        unread = int((ao_flip & ~ssao_reach(d_diff)).sum())
        ao_x = 0.0                    # the other two paths run no SSAO
        if name == "forward_classic+ssao":
            ao_x = float((ssao_depth_pass(d_c.to(dev), (t_c >= 0).to(dev),
                                          zn, zf).cpu() - ao_c).abs().max())
        same = (t_c == t_g) & ~ao_flip
        lit_err = (lit_c - lit_g).abs().amax(-1)
        lit_ok = float((lit_err[same] <= 1e-4).float().mean())
        hdr_err = (h_c - h_g).abs().amax(-1)
        hdr_ok = float((hdr_err[same] <= 1e-4).float().mean())
        tm_ok, ldr_ok = within_1(m_c, m_g), within_1(l_c, l_g)
        log(f"composition [{name}] {SMALL_W}x{SMALL_H} (CPU plain vs card "
            f"kernels): tid mismatch {tid_mis:.4%}; depth differs on "
            f"{int(d_diff.sum())} px (max {float((d_c - d_g).abs().max()):.3g}"
            f"), an SSAO tap flips on {int(ao_flip.sum())} px "
            f"({ao_mis:.4%} of covered), {unread} of them reading no "
            f"differing depth; the card's SSAO on the CPU's depth within "
            f"{ao_x:.3g} of the CPU's mask; lighting HDR within 1e-4 "
            f"on {lit_ok:.4%} of agreeing pixels (max "
            f"{float(lit_err[same].max()):.3g}), tonemapped within 1 LSB "
            f"{tm_ok:.4%}; final HDR within 1e-4 on {hdr_ok:.4%} (max "
            f"{float(hdr_err[same].max()):.3g}), final LDR within 1 LSB "
            f"{ldr_ok:.4%}")
        check(unread == 0 and ao_x <= 1e-5,
              f"composition [{name}]: the SSAO mask moves where the depth "
              f"does not")
        check(tid_mis <= 0.005 and ao_mis <= 0.005 and lit_ok >= 0.999
              and tm_ok >= 0.999 and hdr_ok >= 0.995 and ldr_ok >= 0.995,
              f"composition [{name}] differs")


# ---------------------------------------------------------------------------
# Kernel B1's screen bands (B1b) and the sharded paths (phases 26-27)
# ---------------------------------------------------------------------------

B1B_BANDS = 4                      # the camera and the sun map in 4 bands
SHARD_W, SHARD_H = 1920, 1088      # 1080 rounded up to 4 bands of whole
                                   # 16-row light tiles (272 = 17 x 16)
SHARD_WARMUP, SHARD_FRAMES = 1, 2  # sharded steps per mesh


def _b1b_band(name, setup, w, rows, zn, zf, y0, full_h, kw, timed,
              out=None, strays=False):
    """One screen band of B1 (rasterize_direct with y_offset, full_height;
    kw: depth_mode, track_ids, spatial_sort): the kernel's depth and tid
    (out: those of a launch already made, else the wrapper's run here)
    against its plain version (rasterize_brute at the band's global rows)
    bit for bit; strays: bit for bit but on the pixels that a stray sliver
    wins on one side (same_but_strays, ROADMAP C8: the plain version has
    no bbox bound, the kernel evaluates a triangle only where its chunk
    boxes let it), the kernel's ids from a launch that tracks them when
    out's did not.  timed: the wrapper's, the kernel's alone (on the band's
    own super lists) and the plain version's ms, and the bound.  Returns
    (row, depth, tid)."""
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    mode, track, sort = kw["depth_mode"], kw["track_ids"], kw["spatial_sort"]
    run = lambda: tiled.rasterize_direct(  # noqa: E731
        setup, w, rows, zn, zf, y_offset=y0, full_height=full_h, **kw)
    d_k, t_k = out if out is not None else run()[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_p, t_p = rasterize_brute(setup, w, rows, zn, zf, depth_mode=mode,
                               y_offset=y0, full_height=full_h)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    where = f"{name} (y_offset {y0}, {rows} rows of {full_h})"
    n_diff = 0
    if strays:
        t_id = t_k
        if not track:
            d_t, t_id, _ = tiled.rasterize_direct(
                setup, w, rows, zn, zf, y_offset=y0, full_height=full_h,
                **dict(kw, track_ids=True))
            check(torch.equal(d_t, d_k), f"{where}: the depth changes "
                  "when ids are tracked")
        n_diff = same_but_strays(f"{where} against the plain version", d_k,
                                 t_id, setup.bbox, d_p, t_p, setup.bbox,
                                 True, y0)
    else:
        d_mis = int((d_k != d_p).sum())
        t_mis = int((t_k != t_p).sum()) if track else 0
        check(d_mis == 0 and t_mis == 0,
              f"{where}: {d_mis} depth and {t_mis} tid mismatches against "
              f"the plain version")
    row = {"y_offset": y0, "rows": rows, "covered": int((d_p < 1.0).sum()),
           "plain_ms": plain_ms, "stray_px": n_diff,
           "max_abs_err": float((d_k - d_p).abs().max())}
    if timed:
        rec, ss, n_pad = tiled.pack_direct_records(setup, sort)
        cbb = tiled._chunk_bboxes(ss, n_pad, 16)
        sl, cnt, _ = tiled._super_lists(cbb, 16, -(-w // 128),
                                        -(-rows // 128), 128, 128, y0)
        stream = torch.cuda.current_stream().cuda_stream
        kern = lambda: tiled._direct_launch(  # noqa: E731
            load_kernels(), rec, cbb, sl, cnt, None, None, w, rows, zn, zf,
            mode, track, sort, stream, 0, y0, full_h)
        kern()
        b = bound(direct_read_bytes(rec, cbb, sl, cnt)
                  + (8 if track else 4) * w * rows,
                  raster_pairs(setup, y0, rows) * RASTER_OPS)
        row.update(ms=cuda_ms(run, 10), kernel_ms=cuda_ms(kern, 10), **b)
    return row, d_k, t_k


def _b1b_bands(name, setup, w, h, zn, zf, mode, track, sort, timed=True):
    """One target of B1 in B1B_BANDS screen bands, each against its plain
    version (_b1b_band), the concatenated bands against B1's full-frame
    launch bit for bit (depth, and tid when tracked).  Returns the summed
    result and the per-band rows."""
    from lsr_tpu_torch.raster import tiled

    band = h // B1B_BANDS
    kw = dict(depth_mode=mode, track_ids=track, spatial_sort=sort)
    d_full, t_full, _ = tiled.rasterize_direct(setup, w, h, zn, zf, **kw)
    rows, ds, ts = [], [], []
    for i in range(B1B_BANDS):
        row, d_k, t_k = _b1b_band(f"{name} band {i}", setup, w, band, zn, zf,
                                  i * band, h, kw, timed)
        rows.append(row)
        ds.append(d_k)
        ts.append(t_k)
    d_cat, t_cat = torch.cat(ds), torch.cat(ts)
    d_mis = int((d_cat != d_full).sum())
    t_mis = int((t_cat != t_full).sum())
    log(f"{name} {w}x{h} in {B1B_BANDS} bands of {band} rows: each band "
        f"equal to its plain version; the bands against the full-frame "
        f"launch: {d_mis} depth, {t_mis} tid mismatches; per band "
        + "; ".join(
            f"y_offset {r['y_offset']}: " + (
                f"kernel {r['kernel_ms']:.4f} ms, wrapper {r['ms']:.3f} ms, "
                f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                if timed else "") + f"plain {r['plain_ms']:.1f} ms"
            for r in rows))
    check(d_mis == 0 and t_mis == 0 and sum(r["covered"] for r in rows),
          f"{name}: the bands differ from the full-frame launch")
    res = {"max_abs_err": max(r["max_abs_err"] for r in rows),
           "plain_ms": sum(r["plain_ms"] for r in rows)}
    if timed:
        res.update(ms=sum(r["ms"] for r in rows),
                   kernel_ms=sum(r["kernel_ms"] for r in rows),
                   **bound(sum(r["bytes"] for r in rows),
                           sum(r["ops"] for r in rows)))
    return res, rows


def b1b_phase(geom, objects, ctx, setup, cam):
    """Phase 26.  Kernel B1's screen-band branch (B1b) on the flagship
    scene: the 1920x1080 camera view (view-z, ids; unsorted as the sharded
    paths call it, and spatially sorted) and the bench's 2048^2 sun map
    (NDC01, depth only, passes/shadow.py's spatial sort), each in four
    bands (camera y_offset 0 / 270 / 540 / 810, none a multiple of the
    16-row block but 0; sun map 0 / 512 / 1024 / 1536).  Phase 27 holds
    the bands that the sharded paths launch (unsorted sun map, culled
    1920x1088 camera) against their plain versions.  Returns the B1b
    result entry (the camera's bands summed) with the per-band rows."""
    from lsr_tpu_torch.passes.shadow import shadow_map_setup
    from lsr_tpu_torch.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ

    t_start = time.perf_counter()
    cam_res, cam_rows = _b1b_bands("B1b camera [unsorted,viewz,ids]", setup,
                                   WIDTH, HEIGHT, cam.zn, cam.zf,
                                   DEPTH_VIEWZ, True, False)
    _b1b_bands("B1b camera [sort,viewz,ids]", setup, WIDTH, HEIGHT, cam.zn,
               cam.zf, DEPTH_VIEWZ, True, True, timed=False)
    sm_setup, _ = shadow_map_setup(geom, objects, ctx.light_dir_ws, SHADOW)
    sun_res, sun_rows = _b1b_bands(
        "B1b sun map [sort,ndc01,depth only]", sm_setup, SHADOW, SHADOW, 0.0,
        1.0, DEPTH_NDC01, False, True)
    log(f"# phase 26 took {time.perf_counter() - t_start:.1f} s")
    return dict(cam_res, bands=cam_rows,
                sun_map=dict(sun_res, bands=sun_rows))


def _same_raster_inputs(a, b):
    keys = ("width", "height", "zn", "zf", "y_offset", "full_height",
            "depth_mode", "track_ids", "spatial_sort")
    return all(a[k] == b[k] for k in keys) and all(
        torch.equal(getattr(a["setup"], f), getattr(b["setup"], f))
        for f in ("coef", "iw", "ziw", "bbox", "valid"))


def check_band_calls(tag, calls):
    """The B1b launches of one sharded step (module_calls of
    parallel.sharding.rasterize_direct), each against B1's
    full-frame launch on its inputs, its rows, bit for bit, and against
    its plain version at its global rows, bit for bit but on stray sliver
    pixels (_b1b_band with strays; the flagship's sun map has one), each
    timed alone.  A launch whose inputs equal an earlier one's (each dp
    slice renders the same sun map, each lp rank the same band) must give
    that one's outputs bit for bit and is checked no further.  Returns the
    step's B1b kernel ms and the launches and stray pixels checked."""
    from lsr_tpu_torch.raster import tiled

    calls = [(a, out) for a, out in calls       # B1b's; a whole frame is B1's
             if a["y_offset"] or a["full_height"] not in (None, a["height"])]
    done, kernel_ms = [], 0.0
    for a, (d, t, _) in calls:
        track, y0, rows = a["track_ids"], a["y_offset"], a["height"]
        twin = next((x for x in done if _same_raster_inputs(x[0], a)), None)
        if twin is not None:
            check(torch.equal(d, twin[1])
                  and (not track or torch.equal(t, twin[2])),
                  f"{tag}: two B1b launches on equal inputs differ")
            kernel_ms += twin[3]["kernel_ms"]
            continue
        kw = {k: a[k] for k in ("depth_mode", "track_ids", "spatial_sort")}
        d_f, t_f, _ = tiled.rasterize_direct(a["setup"], a["width"],
                                             a["full_height"], a["zn"],
                                             a["zf"], **kw)
        check(torch.equal(d, d_f[y0:y0 + rows])
              and (not track or torch.equal(t, t_f[y0:y0 + rows])),
              f"{tag}: the B1b launch at y_offset {y0} differs from B1's "
              f"full-frame launch")
        row, _, _ = _b1b_band(f"{tag} B1b", a["setup"], a["width"], rows,
                              a["zn"], a["zf"], y0, a["full_height"], kw,
                              True, out=(d, t), strays=True)
        done.append((a, d, t, row))
        kernel_ms += row["kernel_ms"]
    rows = [x[3] for x in done]
    log(f"{tag}: the {len(calls)} B1b launches of one step equal B1's "
        f"full-frame launch bit for bit, and the plain version but on "
        f"{sum(r['stray_px'] for r in rows)} stray px; {len(rows)} distinct: "
        + "; ".join(f"{r['rows']} rows at y_offset {r['y_offset']}, "
                    f"{r['covered']} px covered, kernel {r['kernel_ms']:.4f} "
                    f"ms" for r in rows))
    return {"b1b_kernel_ms": kernel_ms, "b1b_checked": len(calls),
            "b1b_distinct": len(rows),
            "b1b_stray_px": sum(r["stray_px"] for r in rows)}


def _sharded_run(tag, ranks, step, args, b1_per_step, band_per_step,
                 g1_per_step=0, f1_per_step=0, n=SHARD_FRAMES):
    """One sharded path, a main path of its own: counts reset, its steps,
    exactly b1_per_step B1 launches a step (band_per_step of them B1b),
    g1_per_step G1 launches (a band's local-light sum), f1_per_step F1
    launches (a rank's slot slices) and no other kernel; the first step's
    B1b launches against their plain versions (check_band_calls); then
    torch.profiler over one more step:
    device busy ms and B1's (B1b's with it) kernel ms.  Returns (output,
    result)."""
    from lsr_tpu_torch.parallel import sharding

    reset_counts()

    # The eager step: a one-device mesh's step is a Jitted (phase 33 runs
    # it as one program); its .fn is the undecorated step.
    step = getattr(step, "fn", step)
    with module_calls(sharding, "rasterize_direct") as rec:
        ms, _, outs = _frames(lambda i: step(*args), SHARD_WARMUP + n,
                              SHARD_WARMUP, pipelined=False)
    launches = read_counts()
    band = counts()["rasterize_direct.band_launches"]
    steps = SHARD_WARMUP + n
    ms = ms[SHARD_WARMUP:]
    want = expected({"rasterize_direct.launches": b1_per_step * steps,
                     "accumulate_local_lights.launches": g1_per_step * steps,
                     "slot_inputs.launches": f1_per_step * steps})
    check(launches == want and band == band_per_step * steps,
          f"{tag}: launches {launches}, B1b {band} over {steps} steps "
          f"(expected {b1_per_step} B1, {band_per_step} of them B1b, "
          f"{g1_per_step} G1 and {f1_per_step} F1 a step)")
    res = {"ms": statistics.median(ms), "ms_all": ms, "ranks": ranks,
           "steps": steps, "b1_per_step": b1_per_step,
           "b1b_per_step": band_per_step,
           "launches": launches["rasterize_direct.launches"],
           "b1b_launches": band, "g1_per_step": g1_per_step,
           "g1_launches": launches["accumulate_local_lights.launches"],
           "f1_per_step": f1_per_step,
           "f1_launches": launches["slot_inputs.launches"]}
    if band_per_step:
        res.update(check_band_calls(
            tag, rec.calls[:len(rec.calls) // steps]))
    prof = _profile_frames(lambda: step(*args), n=1, kernel="direct_raster")
    check(prof["kernel_launches"] == b1_per_step,
          f"{tag}: the profiler saw {prof['kernel_launches']} B1 launches "
          f"in a step, not {b1_per_step}")
    res.update(busy_ms=prof["device_busy_ms"], b1_kernel_ms=prof["kernel_ms"],
               kernels_per_step=prof["kernels_per_frame"])
    log(f"{tag}: {ranks} ranks sharing one card (run one after another), "
        f"median {res['ms']:.3f} ms a step by CUDA events over {n} steps "
        f"after {SHARD_WARMUP} warm-up {[round(m, 3) for m in ms]}; B1 "
        f"{b1_per_step} a step ({band_per_step} B1b) and G1 {g1_per_step}, "
        f"checked exactly; "
        f"torch.profiler over one step: device busy {res['busy_ms']:.3f} ms "
        f"in {res['kernels_per_step']:.0f} kernels, B1 (B1b included) "
        f"{res['b1_kernel_ms']:.3f} ms"
        + (f", B1b alone {res['b1b_kernel_ms']:.3f} ms (its launches "
           f"replayed alone on their inputs, CUDA events)"
           if band_per_step else ""))
    return outs[-1], res


def sharded_phase(geom, objects, lights, ctx, dev):
    """Phase 27.  The sharded paths (lsr_tpu_torch.parallel.sharding) with
    every rank on this card (devices=[cuda:0] * n), each step run eagerly
    (the undecorated step; phase 33 runs them as one program), counts reset
    before each: make_sharded_flagship at 1920x1088, 2048^2 sun map, its other
    defaults (slots 128^2, faces 64^2, cull, pbr_mr), two cameras of the
    orbit, on meshes (1, 1), (1, 4) and (2, 2), the frames of (1, 4) and
    (2, 2) equal to (1, 1)'s bit for bit; make_sharded_render on (2, 2),
    each camera equal to render_band of the whole frame bit for bit;
    make_light_sharded_forward on (sp 2, lp 2) and (sp 1, lp 4) against (1,
    1): at most 1 LSB, on under 2% of pixels; make_pipelined_render over 4
    cameras, output i equal to camera i - 1's render_band bit for bit.
    B1 launches a step are checked exactly (those of B1b too), the B1b
    launches of each path's first step held against B1's full-frame
    launch and the plain version (check_band_calls), and one more step
    profiled (_sharded_run).  Returns the results by path and mesh."""
    from lsr_tpu_torch.core.util import cdiv
    from lsr_tpu_torch.frame import flagship_camera
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu_torch.parallel import sharding as shd

    t_start = time.perf_counter()
    w, h = SHARD_W, SHARD_H
    cams = [flagship_camera(i, ctx, w, h, device=dev) for i in range(4)]
    ctx0 = cams[0][1]
    two = [cams[0][0], cams[2][0]]
    vps = torch.stack([c.viewproj for c in two])
    views = torch.stack([c.view for c in two])
    proj, zn, zf = two[0].proj, two[0].zn, two[0].zf
    sun = ctx.light_dir_ws
    spots, points = plan_shadow_casters(lights)
    n_spot, n_face = len(spots), 6 * len(points)
    ranks = lambda n: [dev] * n  # noqa: E731
    out = {}

    frames = {}
    for dp, sp in ((1, 1), (1, 4), (2, 2)):
        mesh = shd.make_mesh(dp * sp, dp=dp, devices=ranks(dp * sp))
        step = shd.make_sharded_flagship(mesh, geom, objects, ctx0, lights,
                                         w, h, shadow_size=SHADOW)
        # A rank: its slot slices and sun band; a camera's rank: occluders
        # and its band.  B1b: every band of a split frame (sp > 1).
        b1 = (dp * sp * (cdiv(n_spot, sp) + cdiv(n_face, sp) + 1)
              + len(two) * sp * 2)
        b1b = (dp * sp + len(two) * sp) if sp > 1 else 0
        # G1: a camera's band on each of its dp slice's sp ranks.  F1: a
        # rank's slice of each stack.
        frames[(dp, sp)], out[f"flagship_{dp}x{sp}"] = _sharded_run(
            f"sharded flagship (dp {dp}, sp {sp}) {w}x{h}, sun {SHADOW}^2",
            dp * sp, step, (vps, views, proj, zn, zf, sun), b1, b1b,
            len(two) * sp, dp * sp * f1_per_frame(spots, points))
    ref = frames[(1, 1)]
    check(ref.shape == (2, h, w, 3) and float(
        (ref.int().sum(-1) > 0).float().mean()) > 0.5,
        "sharded flagship: the (1, 1) frame is empty")
    for key in ((1, 4), (2, 2)):
        mis = int((frames[key] != ref).any(-1).sum())
        log(f"sharded flagship {key} against (1, 1): {mis} px differ")
        check(mis == 0, f"sharded flagship {key} differs from (1, 1)")

    mesh22 = shd.make_mesh(4, dp=2, devices=ranks(4))
    step = shd.make_sharded_render(mesh22, geom, objects, ctx0, w, h)
    got, out["render_2x2"] = _sharded_run(
        f"sharded render (dp 2, sp 2) {w}x{h}", 4, step, (vps, zn, zf), 4, 4)
    for b, cam in enumerate(two):
        ref_b = shd.render_band(geom, objects, cam.viewproj, zn, zf, ctx0, w,
                                h, h, 0)
        check(bool((got[b] == ref_b).all()) and bool(ref_b.any()),
              f"sharded render camera {b} differs from render_band")

    lp_frames = {}
    for sp, lp in ((1, 1), (2, 2), (1, 4)):
        mesh = shd.make_mesh_lp(sp * lp, sp=sp, lp=lp,
                                devices=ranks(sp * lp))
        step, _ = shd.make_light_sharded_forward(mesh, geom, objects, ctx0,
                                                 lights, w, h)
        lp_frames[(sp, lp)], out[f"light_sharded_{sp}x{lp}"] = _sharded_run(
            f"light-sharded forward (sp {sp}, lp {lp}) {w}x{h}", sp * lp,
            step, (two[0].viewproj, two[0].view, proj, zn, zf), sp * lp,
            sp * lp if sp > 1 else 0, sp * lp)
    for key in ((2, 2), (1, 4)):
        d = (lp_frames[key].int() - lp_frames[(1, 1)].int()).abs()
        share = float((d != 0).float().mean())
        log(f"light-sharded {key} against (1, 1): max {int(d.max())} LSB "
            f"on {share:.4%} of values")
        check(int(d.max()) <= 1 and share < 0.02,
              f"light-sharded {key} beyond 1 LSB / 2%")
        out[f"light_sharded_{key[0]}x{key[1]}"].update(
            max_lsb=int(d.max()), share_off=share)

    mesh_pp = shd.make_mesh_pp(2, devices=ranks(2))
    stream = shd.make_pipelined_render(mesh_pp, geom, objects, ctx0, w, h)
    pvps = torch.stack([c.viewproj for c, _ in cams])
    got, out["pipelined_pp2"] = _sharded_run(
        f"pipelined render (pp 2) {w}x{h}, stream of {len(cams)}", 2,
        stream, (pvps, zn, zf), len(cams), 0)
    out["pipelined_pp2"]["ms_per_frame"] = \
        out["pipelined_pp2"]["ms"] / (len(cams) - 1)
    for i in range(1, len(cams)):
        ref_i = shd.render_band(geom, objects, cams[i - 1][0].viewproj, zn,
                                zf, ctx0, w, h, h, 0)
        check(bool((got[i] == ref_i).all()),
              f"pipelined output {i} differs from camera {i - 1}'s frame")
    log(f"# phase 27 took {time.perf_counter() - t_start:.1f} s")
    return out


def _stage_ms(fn, iters=5):
    """(host enqueue ms, device ms per call) of fn on warm inputs: the median
    wall time of one call, returning before the card is done, and CUDA
    events around iters back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(host), cuda_ms(fn, iters)


def _profile_frames(run, n=3, kernel=None):
    """torch.profiler over n frames, the device's activity alone: device
    busy ms per frame (the sum of its kernels' times), kernel launches per
    frame and the eight largest device consumers; given a kernel name, its
    ms and launches per frame."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    t = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                          getattr(e, "self_cuda_time_total", 0.0))
    top = sorted(cuda, key=t, reverse=True)[:8]
    out = {"device_busy_ms": sum(t(e) for e in cuda) / 1e3 / n,
           "kernels_per_frame": sum(e.count for e in cuda) / n,
           "top": [(e.key[:60], round(t(e) / 1e3 / n, 3)) for e in top]}
    if kernel:
        mine = [e for e in cuda if kernel in e.key]
        out.update(kernel_ms=sum(t(e) for e in mine) / 1e3 / n,
                   kernel_launches=sum(e.count for e in mine) / n)
    return out


def _stage_table(title, stages):
    log(title)
    log("| stage | host enqueue ms | device ms |")
    log("|---|---|---|")
    for name, fn in stages.items():
        host, dev_ms = _stage_ms(fn)
        log(f"| {name} | {host:.3f} | {dev_ms:.3f} |")


def _frame_breakdown(name, run):
    """Median ms of 5 runs by CUDA events after 2 warm-up, and
    torch.profiler's device busy ms and kernel count over 3."""
    ms = []
    for _ in range(7):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    out = {"frame_ms": statistics.median(ms[2:]), **_profile_frames(run)}
    log(f"frame breakdown [{name}]: {json.dumps(out)}")
    check(out["kernels_per_frame"] > 0,
          f"the profiler saw no device kernel in {name}")
    return out


def profile_phase(geom, objects, lights, ctx, cam, ctx_t):
    """Phase 14.  Where the flagship frame's time goes, on both routes: each
    stage alone on the previous stage's outputs (host enqueue and device
    ms), then whole frames (median of 5 by CUDA events after 2 warm-up,
    and torch.profiler over 3).  Returns {route: frame breakdown}."""
    from lsr_tpu_torch.camera.light_camera import build_dir_light_camera
    from lsr_tpu_torch.frame import flagship_stages
    from lsr_tpu_torch.lighting.resolve_kernel import resolve_fused
    from lsr_tpu_torch.lighting.shadow_sample import make_shadow_context
    from lsr_tpu_torch.passes.forward_plus import (
        resolve_inputs, shade_forward_plus)
    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.shadow import render_shadow_map, shadow_map_setup
    from lsr_tpu_torch.passes.tonemap import tonemap_pass
    from lsr_tpu_torch.raster.interp import interpolate_gbuffer
    from lsr_tpu_torch.raster.setup import (
        DEPTH_NDC01, scene_setup, scene_setup_depth)
    from lsr_tpu_torch.raster.tiled import rasterize_direct
    from lsr_tpu_torch.scene.scene import shadow_caster_aabb

    w, h, s = WIDTH, HEIGHT, SHADOW
    depth_s, vp = render_shadow_map(geom, objects, ctx_t.light_dir_ws, s)
    shadow = make_shadow_context(depth_s, vp, filter_mode="esm")
    ctx_sh = dataclasses.replace(ctx_t, shadow=shadow)
    setup = scene_setup(geom.positions, geom.normals, geom.uvs, geom.indices,
                        geom.vtx_obj, geom.tri_obj, objects.model,
                        objects.normal_mat, cam.viewproj, w, h,
                        obj_visible=objects.visible)
    depth, tid, _ = rasterize_direct(setup, w, h, cam.zn, cam.zf,
                                     spatial_sort=True)
    gb = interpolate_gbuffer(setup, depth, tid, materials=ctx.materials,
                             want_face_normal=False)
    hdr, _ = shade_forward_plus(gb, ctx_sh, lights, cam.view, cam.proj,
                                cam.zn, cam.zf, w, h, tile_size=16, cap=128,
                                mode="tiled_depth_range")
    table, vis, tex, _ = resolve_inputs(setup, depth, tid, ctx_sh, cam.view,
                                        cam.proj, cam.zn, cam.zf, w, h)
    ldr = tonemap_pass(hdr)
    sun_setup, _ = shadow_map_setup(geom, objects, ctx_t.light_dir_ws, s)
    stages = {
        "sun map (setup + B1)": lambda: render_shadow_map(
            geom, objects, ctx_t.light_dir_ws, s),
        "  sun: caster AABB + light camera": lambda: build_dir_light_camera(
            *shadow_caster_aabb(objects), ctx_t.light_dir_ws, s, 10.0),
        "  sun: scene_setup_depth": lambda: scene_setup_depth(
            geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
            objects.model, vp, s, s,
            obj_visible=objects.casts_shadow & objects.visible),
        "  sun: rasterize_direct (lists + B1, NDC01)": lambda:
            rasterize_direct(sun_setup, s, s, 0.0, 1.0,
                             depth_mode=DEPTH_NDC01, track_ids=False,
                             spatial_sort=True),
        "shadow context (ESM prefilter, q16)": lambda: make_shadow_context(
            depth_s, vp, filter_mode="esm"),
        "scene_setup": lambda: scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, w, h, obj_visible=objects.visible),
        "rasterize_direct (lists + B1)": lambda: rasterize_direct(
            setup, w, h, cam.zn, cam.zf, spatial_sort=True),
        "B2 route: interpolate_gbuffer": lambda: interpolate_gbuffer(
            setup, depth, tid, materials=ctx.materials,
            want_face_normal=False),
        "B2 route: shade_forward_plus (visibility, binning, B2, ambient)":
            lambda: shade_forward_plus(
                gb, ctx_sh, lights, cam.view, cam.proj, cam.zn, cam.zf, w, h,
                tile_size=16, cap=128, mode="tiled_depth_range"),
        "resolve route: resolve_inputs (records, visibility, texture)":
            lambda: resolve_inputs(setup, depth, tid, ctx_sh, cam.view,
                                   cam.proj, cam.zn, cam.zf, w, h),
        "resolve route: resolve_fused (binning + B5)": lambda: resolve_fused(
            table, tid, vis, tex, ctx_sh.camera_pos, ctx_sh.light_dir_ws,
            ctx_sh.light_color * ctx_sh.light_intensity, (0.04, 0.06, 0.1),
            lights, cam.view, cam.proj, w, h, cap=256, chunk=8),
        "tonemap": lambda: tonemap_pass(hdr),
        "fxaa": lambda: fxaa_pass(ldr),
    }
    _stage_table(f"stage times {w}x{h}, sun map {s}^2 (each stage alone):",
                 stages)

    out = {}
    for route, use_resolve in (("b2", False), ("resolve", True)):
        def run():
            st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, w, h,
                                 use_resolve=use_resolve, shadow_size=s,
                                 **CUT)
            return fxaa_pass(tonemap_pass(st["hdr"]))

        out[route] = _frame_breakdown(f"{route} route", run)
    return out


def esm_profile_phase(geom, objects, lights, ctx, cam, ctx_t, casters):
    """Phase 14, whole-frame part.  bench.py's ESM default: the stages the
    cut frame lacks, each alone on the previous stage's outputs (the cull,
    the atlas by both strategies, the visibility planes, the 1024^2 sun
    map), then whole frames on both routes (median of 5 by CUDA events,
    torch.profiler's device busy time and kernels per frame).  Returns
    {route: breakdown}."""
    from lsr_tpu_torch.frame import bench_config, cull_frame, flagship_stages
    from lsr_tpu_torch.geometry.occlusion import render_occluder_depth
    from lsr_tpu_torch.lighting.local_shadows import (
        local_shadow_vis_planes, render_local_shadow_maps)
    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.shadow import render_shadow_map
    from lsr_tpu_torch.passes.tonemap import tonemap_pass

    cfg = bench_config("esm", WIDTH, HEIGHT)
    st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, WIDTH, HEIGHT,
                         casters=casters, **cfg)
    gb, local = st["gb"], st["local"]
    lf = dataclasses.replace(lights, enabled=st["light_enabled"])
    kw = dict(map_size=cfg["local_map"], point_size=cfg["local_point"],
              pcf_radius=2, vis_scale=cfg["vis_scale"],
              caster_enabled=local.caster_enabled, filter_mode="esm")
    n = gb.normal_ws / torch.clamp(torch.linalg.norm(
        gb.normal_ws, dim=-1, keepdim=True), min=1e-12)
    _stage_table(f"whole-frame stage times {WIDTH}x{HEIGHT}, bench.py's ESM "
                 "default (each stage alone):", {
        "cull (frustum, occluders, HiZ, lights)": lambda: cull_frame(
            geom, objects, lights, cam),
        "  occluder depth (setup + B1, 320x180)": lambda:
            render_occluder_depth(geom, objects, cam.viewproj, cam.zn,
                                  cam.zf),
        "local atlas, map (20 setups + 20 B1, ESM tables)": lambda:
            render_local_shadow_maps(geom, objects, lf, *casters, **kw),
        "local atlas, packed (2 setups + 2 B1a, ESM tables)": lambda:
            render_local_shadow_maps(geom, objects, lf, *casters,
                                     atlas_packed=True, **kw),
        "local planes (11, half resolution, upsampled)": lambda:
            local_shadow_vis_planes(local, gb.world_pos, n),
        f"sun map {cfg['shadow_size']}^2 (setup + B1)": lambda:
            render_shadow_map(geom, objects, ctx_t.light_dir_ws,
                              cfg["shadow_size"]),
    })
    out = {}
    for route, use_resolve in (("esm_b2", False), ("esm_resolve", True)):
        def run():
            s2 = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, WIDTH,
                                 HEIGHT, use_resolve=use_resolve,
                                 casters=casters, **cfg)
            return fxaa_pass(tonemap_pass(s2["hdr"]))

        out[route] = _frame_breakdown(f"{route} whole frame", run)
    return out


def highpoly_profile_phase(geom, objects, lights, ctx, dev):
    """Phase 14, high-poly part.  Where the high-poly frame
    (make_highpoly_frame) and the end-to-end step (compact setup + B4) spend
    their time: each stage alone on the previous stage's outputs, then the
    whole frame and step as in the flagship part.  Returns {"highpoly":
    breakdown, "e2e": breakdown}."""
    from lsr_tpu_torch.highpoly import (
        _e2e_step, compact_setup, highpoly_camera, highpoly_frame_params,
        make_highpoly_frame)
    from lsr_tpu_torch.passes.post import fxaa_pass
    from lsr_tpu_torch.passes.standard_passes import fused_lighting
    from lsr_tpu_torch.passes.tonemap import tonemap_pass
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.interp import interpolate_gbuffer
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    w, h = WIDTH, HEIGHT
    cam, ctx_t = highpoly_camera(ctx, w, h, HP_GRID, device=dev)
    fp = highpoly_frame_params(w, h)
    frame = make_highpoly_frame(geom, objects, lights, ctx, fp).fn
    (_, st), _ = frame(cam, ctx_t, None)     # eager, as every stage here
    setup, depth, tid = st["setup"], st["depth"], st["tid"]
    ldr = tonemap_pass(st["hdr"])
    zn, zf = cam.zn, cam.zf
    d0, t0 = targets(w, h, dev)
    rec, lists, n_walk, *_ = tiled.tiled_inputs(setup, w, h, 64, 128, 1024,
                                                16, fit_cap=True)
    _, cl, cc, _ = tiled.chunklist_inputs(setup, w, h, 128, 128, 16, None, 32)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    shade_in = {k: v for k, v in st.items() if k != "hdr"}
    _stage_table(f"high-poly stage times {w}x{h} (each stage alone):", {
        "compact setup (scene_setup_compact)": lambda: compact_setup(
            geom, objects, cam, w, h),
        "B3 route: rasterize_tiled (binning + tile order + B3)": lambda:
            tiled.rasterize_tiled(setup, w, h, zn, zf, tile_h=64, cap=1024,
                                  chunk=16, fit_cap=True),
        "  binning (records, lists, counts)": lambda: tiled.tiled_inputs(
            setup, w, h, 64, 128, 1024, 16, fit_cap=True),
        "  tile order + B3 launch": lambda: tiled._tiled_launch(
            lib, rec, lists, n_walk, d0, t0, w, h, zn, zf, 0, 64, 128, 0, h,
            stream),
        "interpolate_gbuffer": lambda: interpolate_gbuffer(
            setup, depth, tid, materials=ctx_t.materials),
        "fused_lighting (binning, B2, ambient, background)": lambda:
            fused_lighting(shade_in, fp),
        "tonemap": lambda: tonemap_pass(st["hdr"]),
        "fxaa": lambda: fxaa_pass(ldr),
        "end to end: rasterize_chunklist (worklists + tile order + B4)":
            lambda: tiled.rasterize_chunklist(setup, w, h, zn, zf),
        "  worklists (records, chunk lists, counts)": lambda:
            tiled.chunklist_inputs(setup, w, h, 128, 128, 16, None, 32),
        "  tile order + B4 launch": lambda: tiled._chunklist_launch(
            lib, rec, cl, cc, d0, t0, w, h, zn, zf, 0, 128, 128, 16, 32, 0, h,
            True, stream),
    })
    return {"highpoly": _frame_breakdown("high-poly frame",
                                         lambda: frame(cam, ctx_t, None)),
            "e2e": _frame_breakdown(
                "end-to-end step", lambda: _e2e_step(
                    geom, objects, cam, w, h, None))}


# ---------------------------------------------------------------------------
# Phase 28: lsr_tpu's demo entry points (lsr_tpu_torch.demos)
# ---------------------------------------------------------------------------

# Each demo at its own size (lsr_tpu's demos/hello_*.py), the variant's
# render() keywords, and the cut of the card-against-CPU check at
# DEMO_SMALL (map sizes cut alike on both sides; build_scene keywords).
DEMO_RUNS = (
    ("hello_blinn_phong", (800, 600), {}),
    ("hello_shading_models", (256, 256), {}),
    ("hello_water", (800, 600), {}),
    ("hello_shadows", (800, 600), {}),
    ("hello_ibl_skybox", (800, 600), {}),
    ("hello_light_types", (640, 360), {}),
    ("hello_local_shadows", (640, 480), {}),
    ("hello_local_shadows", (640, 480), {"atlas": "packed"}),
    ("hello_normal_mapping", (800, 600), {}),
    ("hello_shaders", (320, 320), {}),
)
DEMO_SMALL = (160, 120)
DEMO_SMALL_RENDER = {"hello_shadows": {"shadow_size": 256},
                     "hello_local_shadows": {"map_size": 64}}
DEMO_SMALL_SCENE = {"hello_ibl_skybox": {"sky_size": 64}}
DEMO_WARMUP, DEMO_FRAMES = 1, 3


def demo_expected(name, scene, kw):
    """The kernel launches of one render() of a demo, read from its code:
    B1 for each camera, occluder, sun-map and atlas-slot raster ("map":
    one a slot, F1 once a stack; "packed": one B1a a stack), B3 for
    hello_shadows' camera, B2 for each forward+ lighting."""
    b1 = {"hello_blinn_phong": 1, "hello_shading_models": 9,
          "hello_water": 2, "hello_shadows": 2, "hello_ibl_skybox": 1,
          "hello_light_types": 1, "hello_normal_mapping": 1,
          "hello_shaders": 0}.get(name)
    b1a = f1 = 0
    if name == "hello_local_shadows":
        spots, points = scene["casters"]
        if kw.get("atlas") == "packed":
            b1a = int(bool(spots)) + int(bool(points))
            b1 = 1 + b1a
        else:
            b1 = 1 + len(spots) + 6 * len(points)
            f1 = f1_per_frame(spots, points)
    b2 = int(name in ("hello_ibl_skybox", "hello_light_types",
                      "hello_local_shadows", "hello_normal_mapping"))
    b3 = int(name == "hello_shadows")
    return {**expected({"rasterize_direct.launches": b1,
                        "rasterize_tiled.launches": b3,
                        "shade_fused.launches": b2,
                        "slot_inputs.launches": f1}),
            "rasterize_direct(band_h)": b1a}


def _demo_contract(tag, cpu, card, need, size=DEMO_SMALL, hdr_share=0.999):
    """Phase 3's contract, card against CPU on one demo's small frame (of
    `size`): tids equal on >= 99.5% of covered pixels, HDR within 1e-4 on
    >= hdr_share (99.9%) of agreeing pixels, LDR within 1 LSB on >= 99.9%
    (the parts `need` names: "tid", "hdr", "ldr")."""
    res = {}
    if "tid" in need:
        t_c, t_g = cpu["gb"].tri_id, card["gb"].tri_id.cpu()
        same = t_c == t_g
        res["tid_match"] = float((same | (t_c < 0)).float().mean())
    if "hdr" in need:
        err = (cpu["hdr"] - card["hdr"].cpu()).abs().amax(-1)
        res["hdr_share"] = float((err[same] <= 1e-4).float().mean())
        res["hdr_max_abs"] = float(err[same].max())
    d = (cpu["ldr"].int() - card["ldr"].cpu().int()).abs()
    res["ldr_share"] = float((d.amax(-1) <= 1).float().mean())
    log(f"demo {tag} card vs CPU at {size[0]}x{size[1]}: {res}")
    check(res.get("tid_match", 1.0) >= 0.995
          and res.get("hdr_share", 1.0) >= hdr_share
          and res["ldr_share"] >= 0.999, f"demo {tag}: card differs from CPU")
    return res


def _demo_holds(name, dev, out, rd, rt, sc):
    """The kernel launches of a demo's render on input combinations no
    earlier phase gives them, each against its plain version on the same
    inputs: B1 on hello_water's mirrored CULL_FRONT reflection view
    (rasterize_brute; depth and tid equal but on stray sliver pixels, C8,
    counted), B3 on hello_shadows' camera setup (rasterize_tiled_plain on
    the same lists, bit for bit) and B2 on each forward+ call (within
    B2_TOL, pbr_mr and blinn_phong)."""
    from lsr_tpu_torch.raster.brute import rasterize_brute

    res = {}
    if name == "hello_water":
        a, (d_k, t_k, _) = rd.calls[0]
        d_p, t_p = rasterize_brute(a["setup"], a["width"], a["height"],
                                   a["zn"], a["zf"])
        bb = a["setup"].bbox
        res["b1_mirrored_px_differ"] = same_but_strays(
            "demo hello_water reflection view (B1 vs brute, CULL_FRONT)",
            d_k, t_k, bb, d_p, t_p, bb, True)
        res["b1_mirrored_covered"] = int((t_p >= 0).sum())
    if name == "hello_shadows":
        a, (d_k, t_k, max_bin, *_) = rt.calls[0]
        w, h = a["width"], a["height"]
        d0, t0 = targets(w, h, dev)
        _b3_vs_plain(f"demo hello_shadows {w}x{h} camera", a["setup"], w, h,
                     a["zn"], a["zf"], a["tile_h"], a["chunk"], a["cap"],
                     a["fit_cap"], d0, t0)
        res["b3_max_bin"], res["b3_cap"] = int(max_bin), a["cap"]
    if sc.calls:
        res["b2_max_abs_err"] = b2b_check(
            f"demo {name}", sc.calls[0], out["gb"].depth01, dev,
            timed=False)["max_abs_err"]
    return res


def demos_phase(dev):
    """Phase 28.  Each of lsr_tpu's demos through its port
    (lsr_tpu_torch.demos.hello_*, the UV-sphere stand-in) at its own size
    on the card, counts reset before each: the exact launches of B1 / B1a
    / B2 / B3 (demo_expected), out/torch_hello_*.png and its covered
    pixels, ms per frame (CUDA events, median of DEMO_FRAMES after
    DEMO_WARMUP, [min, max]); the launches on new input combinations
    against their plain versions (_demo_holds); then the same demo at
    DEMO_SMALL on the CPU and on the card under phase 3's contract."""
    import importlib

    from lsr_tpu_torch.demos.common import stand_in_mesh, write_frame
    from lsr_tpu_torch.lighting import local_shadows as lsm

    t_start = time.perf_counter()
    mesh = stand_in_mesh()
    results = {}
    for name, (w, h), kw in DEMO_RUNS:
        tag = name + "".join(f" {k}={v}" for k, v in kw.items())
        demo = importlib.import_module(f"lsr_tpu_torch.demos.{name}")
        t0 = time.perf_counter()
        scene = demo.build_scene(mesh, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reset_counts()
        with shade_calls() as sc, \
                module_calls(demo, "rasterize_direct") as rd, \
                module_calls(demo, "rasterize_tiled") as rt, \
                module_calls(lsm, "rasterize_direct") as atlas:
            out = demo.render(scene, w, h, **kw)
            torch.cuda.synchronize()
        launches = read_counts()
        launches["rasterize_direct(band_h)"] = sum(
            1 for a, _ in atlas.calls if a["band_h"] > 0)
        want = demo_expected(name, scene, kw)
        log(f"demo {tag} {w}x{h}: launches {launches} (expected {want})")
        check(launches == want, f"demo {tag}: launches {launches}, "
              f"expected {want}")
        png = f"torch_{name}{'_' + kw['atlas'] if 'atlas' in kw else ''}.png"
        write_frame("out", png, out["ldr"])
        gb = out.get("gb")
        n_cov = int(gb.covered.sum()) if gb is not None else None
        check(bool(torch.isfinite(out["hdr"]).all()) if "hdr" in out
              else True, f"demo {tag}: HDR not finite")

        ms = []
        for i in range(DEMO_WARMUP + DEMO_FRAMES):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            demo.render(scene, w, h, **kw)
            e1.record()
            torch.cuda.synchronize()
            if i >= DEMO_WARMUP:
                ms.append(e0.elapsed_time(e1))
        res = {"size": f"{w}x{h}", "launches": launches,
               "covered": n_cov, "png": f"out/{png}",
               "ms": statistics.median(ms), "ms_min": min(ms),
               "ms_max": max(ms), "build_scene_s": build_s}
        res.update(_demo_holds(name, dev, out, rd, rt, sc))

        sw, sh = DEMO_SMALL
        small = {}
        for d in ("cpu", dev):
            sc_d = demo.build_scene(mesh, d, **DEMO_SMALL_SCENE.get(name,
                                                                    {}))
            small[str(d)] = demo.render(sc_d, sw, sh, **kw,
                                        **DEMO_SMALL_RENDER.get(name, {}))
        need = ("ldr",) if name == "hello_shaders" else (
            ("tid", "ldr") if name in ("hello_blinn_phong",
                                       "hello_shading_models")
            else ("tid", "hdr", "ldr"))
        res["card_vs_cpu"] = _demo_contract(tag, small["cpu"],
                                            small[str(dev)], need)
        log(f"demo {tag}: {res}")
        results[tag] = res
    log(f"# phase 28 took {time.perf_counter() - t_start:.1f} s")
    return results


# ---------------------------------------------------------------------------
# Phase 29: lsr_tpu's remaining entry points (the 2D and debug rasters,
# hello_full_pipeline, hello_rendering_paths, hello_parallelization and
# lsr_tpu_torch.run_phases)
# ---------------------------------------------------------------------------

REST_SMALL = (96, 72)              # the 3D demos card against CPU
REST_SUN, REST_OCC = 128, (80, 45)  # their sun map and occluders there
REST_PAR_SMALL = (64, 64)          # hello_parallelization there
REST_WARMUP, REST_FRAMES = 1, 3    # timed renders of a 3D demo
RASTER2D_W, RASTER2D_H = 1920, 1080
PHASES_ENV = {"LSR_PHASE_W": "320", "LSR_PHASE_H": "180",
              "LSR_PHASE_F_W": "1280", "LSR_PHASE_F_H": "720",
              "LSR_PHASE_F_WARMUP": "2", "LSR_PHASE_F_SAMPLES": "6",
              "LSR_PHASE_G_SECONDS": "5",
              "LSR_PHASE_PRESETS": "forward_plus,deferred"}
PHASES_OUT = os.path.join("chiprun_out", "run_phases")


def rest_expected(name, fp=None):
    """The kernel launches of one render of a demo of phase 29, read from
    its code: hello_full_pipeline B1 for the sun map and the camera, B2 for
    tiled deferred; a composition of hello_rendering_paths B1 for the
    occluders, the sun map and the depth prepass (the G-buffer reuses it)
    plus one a caster slot (none: the demo sets no casters), B2 for the
    lighting (B2b on clustered_forward) but under SSAO (the general
    branch, whose sum is G1's); hello_parallelization (8 ranks) B1 1 for
    the (1, 1) mesh, 8 B1b for dp 2 x sp 4, 8 B1b for sp 4 x lp 2, 3 for
    the pp stream of 3 cameras, and G1 on each of the 8 (band, light
    slice) ranks of sp 4 x lp 2."""
    if name == "hello_full_pipeline":
        return expected({"rasterize_direct.launches": 2,
                         "shade_fused.launches": 1})
    if name == "hello_parallelization":
        return expected({"rasterize_direct.launches": 1 + 8 + 8 + 3,
                         "accumulate_local_lights.launches": 8})
    return pipeline_expected(fp, name.endswith("+ssao"))


def _check_launches(tag, want, n=1, band=0):
    """The counts since reset_counts equal want (a render's) times n, and
    B1b's band * n; returns the counts."""
    launches = read_counts()
    want = {k: v * n for k, v in want.items()}
    b1b = counts()["rasterize_direct.band_launches"]
    log(f"{tag}: launches {launches}, B1b {b1b} (expected {want}, B1b "
        f"{band * n})")
    check(launches == want and b1b == band * n,
          f"{tag}: launches {launches}, B1b {b1b}; expected {want}, B1b "
          f"{band * n}")
    return launches


def _events_ms(fn):
    """fn() REST_WARMUP times, then REST_FRAMES times, each bracketed by
    CUDA events (_frames): (median, min, max) ms of the timed calls."""
    ms = _frames(lambda i: fn(), REST_WARMUP + REST_FRAMES, REST_WARMUP,
                 pipelined=False)[0][REST_WARMUP:]
    return statistics.median(ms), min(ms), max(ms)


def _small(out):
    """A phase 29 frame (a demo's render or a pipeline state) in
    _demo_contract's keys."""
    return {"gb": out["gbuffer"], "hdr": out["hdr"], "ldr": out["ldr"]}


def raster2d_phase(dev):
    """The 2D and debug rasters on the card against the CPU, bit for bit,
    each run twice on the card (the line scatter picks its winner per
    pixel, so two runs must agree): hello_wireframe at 600x600,
    hello_pixel_primitives' sheet, 4,096 random lines over a noisy 1080p
    canvas (endpoints off-canvas and negative, one color each: heavy
    overlap), the float32 overlay, 512 random world segments and 64 boxes
    over a 1080p frame (near-plane crossings), a 1080p triangle fill, blend
    and blit.  Each timed on the card (CUDA events, median of 3 after 1)
    and once on the CPU."""
    from lsr_tpu_torch.demos import hello_pixel_primitives as hpp
    from lsr_tpu_torch.demos import hello_wireframe as hw
    from lsr_tpu_torch.demos.common import stand_in_mesh
    from lsr_tpu_torch.raster import debug_draw, lines, primitives2d as p2
    from lsr_tpu_torch.scene.scene import make_camera

    rng = np.random.default_rng(29)
    w, h = RASTER2D_W, RASTER2D_H
    canvas = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    buf = rng.standard_normal((h, w, 4)).astype(np.float32)
    p0 = rng.integers(-400, w + 400, (4096, 2)).astype(np.int32)
    p1 = rng.integers(-400, w + 400, (4096, 2)).astype(np.int32)
    cols = rng.integers(0, 256, (4096, 3)).astype(np.uint8)
    vals = rng.standard_normal((4096, 4)).astype(np.float32)
    s0 = rng.uniform(-6, 6, (512, 3)).astype(np.float32)
    s1 = rng.uniform(-6, 6, (512, 3)).astype(np.float32)
    lo = rng.uniform(-4, 2, (64, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 2, (64, 3)).astype(np.float32)
    img = rng.integers(0, 256, (300, 400, 3)).astype(np.uint8)
    tri = rng.uniform(-100, w + 100, (3, 2)).astype(np.float32)
    alpha = rng.uniform(0, 1, (h, w)).astype(np.float32)
    mesh = stand_in_mesh()

    def cases(d):
        c = torch.as_tensor(canvas, device=d)
        b = torch.as_tensor(buf, device=d)
        vp = make_camera(w, h, (0.5, 1.0, -3.0), (0, 0, 0),
                         device=d).viewproj
        return {
            "hello_wireframe 600x600": lambda: hw.render(
                hw.build_scene(mesh, d), 600, 600)["ldr"],
            "hello_pixel_primitives sheet": lambda: hpp.render(
                hpp.build_scene(d))["ldr"],
            "rasterize_lines 4096 lines": lambda: lines.rasterize_lines(
                c, p0, p1, cols),
            "rasterize_lines_f32 4096 lines": lambda:
                lines.rasterize_lines_f32(b, p0, p1, vals),
            "draw_segments 512": lambda: debug_draw.draw_segments(
                c, s0, s1, vp),
            "draw_aabbs 64": lambda: debug_draw.draw_aabbs(c, lo, hi, vp),
            "fill_triangle_2d": lambda: p2.fill_triangle_2d(c, tri,
                                                            (250, 120, 90)),
            "alpha_blend": lambda: p2.alpha_blend(c, c.flip(0), alpha),
            "image_blit": lambda: p2.image_blit(c, torch.as_tensor(
                img, device=d), -50, 900),
        }

    cpu, card = cases("cpu"), cases(dev)
    out = {}
    for name, fn in card.items():
        t0 = time.perf_counter()
        want = cpu[name]()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        a, b = fn(), fn()
        torch.cuda.synchronize()
        mis = int((a.cpu() != want).sum())
        runs = int((a != b).sum())
        ms, ms_min, ms_max = _events_ms(fn)
        out[name] = {"shape": list(want.shape), "mismatches_vs_cpu": mis,
                     "run_to_run": runs, "ms": ms, "ms_min": ms_min,
                     "ms_max": ms_max, "cpu_ms": cpu_ms}
        log(f"2D raster {name}: {out[name]}")
        check(mis == 0 and runs == 0, f"2D raster {name}: {mis} values off "
              f"the CPU's, {runs} between two card runs")
    return out


def full_pipeline_demo_phase(dev, mesh):
    from lsr_tpu_torch.demos import hello_full_pipeline as demo
    from lsr_tpu_torch.demos.common import write_frame

    scene = demo.build_scene(mesh, dev)
    torch.cuda.synchronize()
    reset_counts()
    out = demo.render(scene, FULL_W, FULL_H)
    torch.cuda.synchronize()
    launches = _check_launches(f"demo hello_full_pipeline {FULL_W}x{FULL_H}",
                               rest_expected("hello_full_pipeline"))
    check(bool(torch.isfinite(out["hdr"]).all())
          and out["ldr"].shape == (FULL_H, FULL_W, 3)
          and len(out["pass_order"]) == 12,
          "demo hello_full_pipeline: bad frame")
    write_frame("out", "torch_hello_full_pipeline.png", out["ldr"])
    ms = _events_ms(lambda: demo.render(scene, FULL_W, FULL_H))
    warm = demo.render(scene, FULL_W, FULL_H)       # pass ms once warm
    sw, sh = REST_SMALL
    small = {str(d): _small(demo.render(demo.build_scene(mesh, d), sw, sh,
                                        shadow_size=REST_SUN))
             for d in ("cpu", dev)}
    # The final HDR is after the post stack, whose bloom and depth of
    # field spread a pixel's difference over their windows: 99.5%.
    res = {"size": f"{FULL_W}x{FULL_H}", "launches": launches,
           "ms": ms[0], "ms_min": ms[1], "ms_max": ms[2],
           "pass_order": out["pass_order"],
           "pass_ms": {k: round(v, 3) for k, v in warm["pass_ms"].items()},
           "card_vs_cpu": _demo_contract(
               "hello_full_pipeline", small["cpu"], small[str(dev)],
               ("tid", "hdr", "ldr"), REST_SMALL, hdr_share=0.995)}
    log(f"demo hello_full_pipeline: {res}")
    return res


def rendering_paths_demo_phase(dev):
    from lsr_tpu_torch.demos import hello_rendering_paths as demo
    from lsr_tpu_torch.demos.common import write_frame

    w, h = 480, 270
    scene = demo.build_scene(w, h, dev)
    pipes, rebuilds = demo.build_pipelines(w, h)
    check(rebuilds == 6, f"hello_rendering_paths: {rebuilds} rebuilds")
    want = expected({})
    for name, (_, fp, _) in pipes.items():
        for k, v in rest_expected(name, fp).items():
            want[k] += v
    n = demo.CYCLES * (1 + demo.FRAMES)
    torch.cuda.synchronize()
    reset_counts()
    shots, times = demo.cycle(scene, pipes, w, h, log=log)
    torch.cuda.synchronize()
    launches = _check_launches(
        f"demo hello_rendering_paths {w}x{h}, {len(pipes)} compositions x "
        f"{n} frames", want, n)
    sheet = demo.contact_sheet(shots)
    check(all(float((s.int().sum(-1) > 0).float().mean()) > 0.5
              for s in shots.values()), "hello_rendering_paths: empty frame")
    write_frame("out", "torch_hello_rendering_paths.png", sheet)
    sw, sh = REST_SMALL
    small = {}
    for d in ("cpu", dev):
        sc_d = demo.build_scene(sw, sh, d)
        p_d, _ = demo.build_pipelines(sw, sh)
        for name, (pipe, fp, rt) in p_d.items():
            fp.pass_params.shadow.map_size = REST_SUN
            (fp.pass_params.culling.occ_width,
             fp.pass_params.culling.occ_height) = REST_OCC
            st = pipe.execute_jitted(rt, demo.frame_state(sc_d, sw, sh, 0),
                                     fp)
            small.setdefault(name, {})[str(d)] = _small(st)
    res = {"size": f"{w}x{h}", "rebuilds": rebuilds, "launches": launches,
           "frames": n * len(pipes),
           "ms": {name: ms for c, name, _, ms in times if c == 1},
           "first_ms": {f"{name} cycle {c}": first
                        for c, name, first, _ in times},
           "card_vs_cpu": {name: _demo_contract(
               f"hello_rendering_paths {name}", v["cpu"], v[str(dev)],
               ("tid", "hdr", "ldr"), REST_SMALL)
               for name, v in small.items()}}
    log(f"demo hello_rendering_paths: {res}")
    return res


def parallelization_demo_phase(dev, mesh):
    from lsr_tpu_torch.demos import hello_parallelization as demo
    from lsr_tpu_torch.demos.common import write_frame

    w, h = 256, 128
    scene = demo.build_scene(mesh, dev)
    torch.cuda.synchronize()
    reset_counts()
    out = demo.render(scene, w, h, log=log)
    torch.cuda.synchronize()
    launches = _check_launches(
        f"demo hello_parallelization {w}x{h}, {demo.RANKS} ranks on one "
        f"card", rest_expected("hello_parallelization"), band=16)
    write_frame("out", "torch_hello_parallelization.png", out["ldr"])
    ms = _events_ms(lambda: demo.render(scene, w, h, log=lambda m: None))
    sw, sh = REST_PAR_SMALL
    small = {str(d): demo.render(demo.build_scene(mesh, d), sw, sh,
                                 log=lambda m: None)["panels"]
             for d in ("cpu", dev)}
    cmp = {}
    for name in demo.PANELS:
        dd = (small["cpu"][name].int() - small[str(dev)][name].cpu().int()
              ).abs()
        cmp[name] = {"max_lsb": int(dd.max()),
                     "share_within_1": float((dd.amax(-1) <= 1).float()
                                             .mean()),
                     "share_off": float((dd != 0).float().mean())}
        ok = (cmp[name]["max_lsb"] <= 1 and cmp[name]["share_off"] < 0.02
              if name == "sp4xlp2" else cmp[name]["share_within_1"] >= 0.999)
        check(ok, f"demo hello_parallelization {name}: card differs from "
              f"CPU {cmp[name]}")
    res = {"size": f"{w}x{h}", "launches": launches, "b1b": 16,
           "pp_diff": out["pp_diff"], "ms": ms[0], "ms_min": ms[1],
           "ms_max": ms[2], "card_vs_cpu": cmp}
    log(f"demo hello_parallelization: {res}")
    return res


def run_phases_phase(dev):
    """lsr_tpu_torch.run_phases on the card with PHASES_ENV: Phase I at
    320x180 on both raster routes, I-posts, Phase F at 1280x720 (2 warm-up,
    6 samples) on forward_plus, deferred and forward_plus+full, a 5 s Phase
    G; its rows written under PHASES_OUT, read back (each row parses, each
    carries the run's id), each path's four post stacks give four distinct
    images.  Phase G: no cycle failed, the rebuilds within lsr_tpu's bound,
    and `accepted` exactly what lsr_tpu's thresholds give for the report's
    numbers; its frame time is data (the port's 320x180 soak frames run
    over lsr_tpu's 50 ms, PERF.md), logged with the verdict."""
    from lsr_tpu_torch import run_phases
    from lsr_tpu_torch.utils.harness import SoakAcceptance

    res = run_phases.run(dict(PHASES_ENV), device=dev, out_dir=PHASES_OUT,
                         log=log)
    rows = {}
    for f in sorted(os.listdir(PHASES_OUT)):
        with open(os.path.join(PHASES_OUT, f)) as fh:
            rows[f] = [r for r in map(json.loads, fh)
                       if r.get("run_id") == res["run_id"]]
    check(len(rows) == 4 and all(rows.values()),
          f"run_phases: rows {[(f, len(r)) for f, r in rows.items()]}")
    g = res["G"]
    acc = SoakAcceptance()
    check(g["cycle_failures"] == 0 and g["frames"] > 0
          and g["rebuilds"] <= acc.max_rebuilds
          and g["accepted"] == (g["avg_frame_ms"] <= acc.max_avg_frame_ms),
          f"run_phases: Phase G {g}")
    log(f"run_phases: Phase G {'accepted' if g['accepted'] else 'NOT accepted'}"
        f": {g['avg_frame_ms']} ms a frame against lsr_tpu's "
        f"{acc.max_avg_frame_ms} ms, {g['cycle_failures']} failed cycles, "
        f"{g['rebuilds']} rebuilds (bound {acc.max_rebuilds})")
    distinct = res["I_posts_distinct"]
    check(all(a == b == 4 for a, b in distinct.values()),
          f"run_phases: post stacks not distinct {distinct}")
    out = {"floor_ms": res["floor_ms"],
           "rows": {f: len(r) for f, r in rows.items()},
           "I_match": {k: v["match"] for k, v in res["I"].items()},
           "I_posts_match": {k: v["match"]
                             for k, v in res["I_posts"].items()},
           "I_posts_distinct": distinct,
           "F": {k: {"ms_avg": r.ms_avg, "ms_min": r.ms_min,
                     "ms_max": r.ms_max} for k, r in res["F"].items()},
           "F_pass": {k: r["pass_ms"] for k, r in res["F_pass"].items()},
           "G": g}
    log(f"run_phases: {out}")
    return out


def rest_phase(dev):
    """Phase 29.  lsr_tpu's remaining entry points on the card: the 2D and
    debug rasters (raster2d_phase); hello_full_pipeline at 800x600,
    hello_rendering_paths at 480x270 (its loop: 6 compositions x 12
    frames) and hello_parallelization at 256x128 (8 ranks on this card),
    each a main path of its own, counts reset just before and read just
    after, launches exactly rest_expected's; out/torch_hello_*.png; ms per
    frame; each card against the CPU at a small size (REST_SMALL,
    REST_PAR_SMALL) under phase 3's contract; then run_phases_phase."""
    from lsr_tpu_torch.demos.common import stand_in_mesh

    t_start = time.perf_counter()
    mesh = stand_in_mesh()
    res = {"raster2d": raster2d_phase(dev),
           "hello_full_pipeline": full_pipeline_demo_phase(dev, mesh),
           "hello_rendering_paths": rendering_paths_demo_phase(dev),
           "hello_parallelization": parallelization_demo_phase(dev, mesh)}
    t_phases = time.perf_counter()
    res["run_phases"] = run_phases_phase(dev)
    log(f"# phase 29 took {time.perf_counter() - t_start:.1f} s (run_phases "
        f"{time.perf_counter() - t_phases:.1f} s)")
    return res


# ---------------------------------------------------------------------------
# Phase 31: one-program frames (utils.jit: each frame one captured CUDA
# graph, replayed)
# ---------------------------------------------------------------------------

OP_REPLAYS = 3                     # replayed frames after the capture's
FLAGSHIP_OUTS = ("ldr", "n_valid", "max_sup", "max_lights_per_bin",
                 "overflow_bins")


def _timed(fn):
    """(fn(), device ms by CUDA events around it, synchronized)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def _pipelined(fns):
    """Host ms a call of fns called back to back, one sync at the end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(fns)


def _spread(a, b):
    """(elements that differ, max abs difference) of two tensors."""
    if torch.equal(a, b):
        return 0, 0.0
    d = (a.double() - b.double()).abs()
    return int((d > 0).sum()), float(d.max())


def _ms_summary(ms):
    return {"ms": statistics.median(ms), "ms_min": min(ms),
            "ms_max": max(ms), "frame_ms_all": [round(m, 3) for m in ms]}


PROFILE_PAD_S = 0.005  # host idle at each end of a profiled window


def _busy(run, ms, match=None):
    """torch.profiler over one more call of run, warm: device busy ms (the
    sum of its kernels' times), kernels, and the busy share of ms (a
    call's time by CUDA events); given match (a predicate on kernel
    names), also the busy ms and kernels of the matching ones.  The window
    holds PROFILE_PAD_S of host idle before and after the call, so that a
    device activity stamped near its edge by the device clock still falls
    inside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        run()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    t = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                          getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    busy = sum(t(e) for e in cuda)
    top = sorted(cuda, key=t, reverse=True)[:6]
    res = {"device_busy_ms": busy, "kernels": sum(e.count for e in cuda),
           "copies": sum(e.count for e in cuda if "Memcpy" in e.key),
           "busy_share": busy / ms,
           "top": [(e.key[:60], e.count, round(t(e), 3)) for e in top]}
    if match is not None:
        hit = [e for e in cuda if match(e.key)]
        res.update(match_ms=sum(t(e) for e in hit),
                   match_kernels=sum(e.count for e in hit),
                   match_by_name={e.key[:60]: t(e) for e in hit})
    return res


def _busy_seen(run, ms, match=None, tries=3):
    """_busy, profiled again (up to tries times) when the profiler gave
    back no kernel at all, which happens now and then on a short graph
    replay."""
    for _ in range(tries):
        res = _busy(run, ms, match)
        if res["kernels"]:
            return res
    check(False, f"torch.profiler saw no kernel in {tries} tries")
    return res


def _busy_replays(call, ms, n, match=None, tries=6):
    """_busy over n calls of call in one profiled window, per call, and
    whether the window recorded all n ("complete"): its kernels and
    copies nonzero whole multiples of n and equal to those of an earlier
    such window (then the busy ms is the mean of the two windows').  The
    profiler drops some or all of the kernels of short graph replays, at
    random or in every window of a run (a window of one replay lost 60 of
    389 kernels five times in a row; windows of five came back empty every
    other time on V1 + V2, or short by the same 64 of 1,945 eight times in
    a row on the plain route), so up to tries windows are profiled; where
    none agree, the fullest window's numbers are returned, complete False,
    its busy ms a lower bound, with every window's counts (and a failure
    where no window saw a kernel)."""
    seen = []
    for _ in range(tries):
        res = _busy(lambda: [call() for _ in range(n)], ms * n, match)
        k, c = res["kernels"], res["copies"]
        same = [r for r in seen if (r["kernels"], r["copies"]) == (k, c)]
        seen.append(res)
        if k and k % n == 0 and c % n == 0 and same:
            pair, complete = (same[-1], res), True
            break
    else:
        pair, complete = (max(seen, key=lambda r: r["kernels"]),), False
        check(pair[0]["kernels"] > 0,
              f"torch.profiler saw no kernel in {tries} windows")
    per = {"device_busy_ms": sum(r["device_busy_ms"] for r in pair)
           / (len(pair) * n),
           "kernels": pair[0]["kernels"] / n,
           "copies": pair[0]["copies"] / n, "complete": complete,
           "windows": [(r["kernels"], r["copies"]) for r in seen]}
    if match is not None:
        per["match_ms"] = sum(r["match_ms"] for r in pair) / (len(pair) * n)
    if not complete:
        log(f"# torch.profiler: no two windows of {n} calls agreed on "
            f"whole multiples of {n} (kernels / copies {per['windows']}): "
            f"the fullest one's busy ms is a lower bound")
    return per


def graph_ms(fn, iters=10):
    """Device ms of one fn() (its kernels and memsets only), by
    lsr_tpu_torch.utils.devtime.graph_ms: iters calls in one captured
    graph, its replay timed by CUDA events."""
    from lsr_tpu_torch.utils.devtime import graph_ms as timed

    return timed(fn, iters)


def _captures(jitted_of):
    """The path's captures so far (0 before its Jitted exists)."""
    try:
        return jitted_of().captures
    except AttributeError:
        return 0


def _one_program(tag, jitted_of, steps, outs_of, want, band=None,
                 eager_busy=True):
    """One path through jit against its eager frame.  steps: [(jitted
    call, eager call, the eager call again from the same state[, fit])] in
    order.  A step's kind is what the call did, read off the path's
    captures: "warm" before the capture (jit's eager warm-up of a key, or a
    checked program's sizing call), "capture" (the call that captured, then
    replayed), "replay" after it.  At every step the jitted call's launches
    equal the eager call's and want; from the capture on, its outputs
    (outs_of: {name: tensor}) equal the eager frame's bit for bit, or lie
    within the spread of the eager frame against itself (measured at the
    capture's step).  fit (a checked program's eager route, the lists
    fitted on the host) must launch want and equal the jitted call bit for
    bit from the capture on, and is timed beside the replays.
    jitted_of() is the path's Jitted.  band: B1b's launches a step
    (rasterize_direct.band_launches), checked as the others are.  Then
    both sides' replay steps again back to back (pipelined ms),
    torch.profiler over one replay and (eager_busy) one eager frame, the
    graph's numbers.  Returns the result."""
    replay_ms, eager_ms, fit_ms, spread, self_spread = [], [], [], {}, None
    capture_call_ms = None
    captures0 = _captures(jitted_of)
    kinds = []
    for i, (jitted, eager, again, *fit) in enumerate(steps):
        before = _captures(jitted_of)
        reset_counts()
        out_j, ms_j = _timed(jitted)
        got = read_counts()
        got_band = counts()["rasterize_direct.band_launches"]
        after = jitted_of().captures
        kind = ("capture" if after > before else
                "replay" if "capture" in kinds else "warm")
        kinds.append(kind)
        reset_counts()
        out_e, ms_e = _timed(eager)
        ref = read_counts()
        ref_band = counts()["rasterize_direct.band_launches"]
        check(got == ref == want, f"{tag} step {i} ({kind}): launches "
              f"{got} (eager {ref}, expected {want})")
        check(band is None or got_band == ref_band == band,
              f"{tag} step {i} ({kind}): B1b launches {got_band} (eager "
              f"{ref_band}, expected {band})")
        if kind == "warm":
            continue
        if kind == "capture":
            capture_call_ms = ms_j
            twice = outs_of(again())
            self_spread = {k: _spread(v, twice[k])
                           for k, v in outs_of(out_e).items()}
        else:
            replay_ms.append(ms_j)
            eager_ms.append(ms_e)
        for k, v in outs_of(out_j).items():
            px, err = _spread(v, outs_of(out_e)[k])
            spread[k] = max(spread.get(k, (0, 0.0)), (px, err))
            check(px <= self_spread[k][0] and err <= self_spread[k][1],
                  f"{tag} step {i} ({kind}): {k} differs from the eager "
                  f"frame's in {px} elements (max {err}); the eager frame "
                  f"against itself {self_spread[k]}")
        if fit:
            reset_counts()
            out_f, ms_f = _timed(fit[0])
            got_f = read_counts()
            check(got_f == want, f"{tag} step {i} ({kind}): the fitted "
                  f"eager route launched {got_f}, expected {want}")
            _equal_outs(f"{tag} step {i} ({kind}) vs the fitted eager route",
                        outs_of(out_j), outs_of(out_f))
            if kind == "replay":
                fit_ms.append(ms_f)
    jf = jitted_of()
    check(jf.captures - captures0 == 1 and kinds.count("capture") == 1
          and "replay" in kinds, f"{tag}: steps {kinds}, "
          f"{jf.captures - captures0} captures, one expected")
    g = next(reversed(jf.graphs.values()))
    replays = [s[0] for s, k in zip(steps, kinds) if k == "replay"]
    eagers = [s[1] for s, k in zip(steps, kinds) if k == "replay"]
    res = {"replay": _ms_summary(replay_ms), "eager": _ms_summary(eager_ms),
           "replay_pipelined_ms": _pipelined(replays),
           "eager_pipelined_ms": _pipelined(eagers),
           "capture_ms": g.capture_ms, "capture_call_ms": capture_call_ms,
           "graph_bytes": g.pool_bytes, "captures": jf.captures - captures0,
           "steps": kinds, "launches_per_frame": want,
           "replay_vs_eager": spread, "eager_vs_itself": self_spread}
    check(jf.captures - captures0 == 1,
          f"{tag}: the pipelined replays captured again")
    res["replay_busy"] = _busy(replays[-1], res["replay"]["ms"])
    res["eager_busy"] = (_busy(eagers[-1], res["eager"]["ms"]) if eager_busy
                         else None)
    fit_note = ""
    if fit_ms:
        fits = [s[3] for s, k in zip(steps, kinds) if k == "replay"]
        res["fit_eager"] = _ms_summary(fit_ms)
        res["fit_eager_pipelined_ms"] = _pipelined(fits)
        res["fit_eager_busy"] = _busy(fits[-1], res["fit_eager"]["ms"])
        fb = res["fit_eager_busy"]
        fit_note = (f"; the fitted eager route {res['fit_eager']['ms']:.3f} "
                    f"[{res['fit_eager']['ms_min']:.3f}, "
                    f"{res['fit_eager']['ms_max']:.3f}], pipelined "
                    f"{res['fit_eager_pipelined_ms']:.3f}, busy "
                    f"{fb['device_busy_ms']:.3f} ms in {fb['kernels']:.0f} "
                    f"kernels ({fb['copies']} copies, "
                    f"{fb['busy_share']:.1%}), every frame from the "
                    f"capture on bit for bit the replay's; its top kernels "
                    f"{fb['top']}")
    log(f"{tag}: steps {kinds}; replay {res['replay']['ms']:.3f} ms/frame "
        f"[min {res['replay']['ms_min']:.3f}, max "
        f"{res['replay']['ms_max']:.3f}], "
        f"pipelined {res['replay_pipelined_ms']:.3f}, busy "
        f"{res['replay_busy']['device_busy_ms']:.3f} ms in "
        f"{res['replay_busy']['kernels']:.0f} kernels "
        f"({res['replay_busy']['copies']} copies, "
        f"{res['replay_busy']['busy_share']:.1%}); eager "
        f"{res['eager']['ms']:.3f} [{res['eager']['ms_min']:.3f}, "
        f"{res['eager']['ms_max']:.3f}], pipelined "
        f"{res['eager_pipelined_ms']:.3f}"
        + (f", busy {res['eager_busy']['device_busy_ms']:.3f} ms in "
           f"{res['eager_busy']['kernels']:.0f} kernels "
           f"({res['eager_busy']['copies']} copies, "
           f"{res['eager_busy']['busy_share']:.1%})" if eager_busy else "")
        + f"{fit_note}; capture "
        f"{g.capture_ms:.1f} ms host (its call {capture_call_ms:.1f} ms), "
        f"replay's top kernels {res['replay_busy']['top']}"
        + (f", eager's top kernels {res['eager_busy']['top']}"
           if eager_busy else "") + ", "
        f"graph {g.pool_bytes / 2**20:.1f} MiB, 1 capture; launches a "
        f"frame {want}; replay vs eager {spread} (eager vs itself "
        f"{self_spread})")
    return res


def _flagship_steps(jf, frame, cams):
    """Camera 0 twice (jit's warm-up, then its capture), then OP_REPLAYS
    later cameras of the staged orbit."""
    sel = [cams[0], cams[0]] + list(cams[1:1 + OP_REPLAYS])
    return [(lambda c=c: jf(*c), lambda c=c: frame(*c),
             lambda c=c: frame(*c)) for c in sel]


def _pipeline_steps(jitted_pipe, fp_j, eager_pipe, fp_e, state_fn):
    """execute_jitted against execute on the same states, 3 + OP_REPLAYS
    frames: frame 0 (no persistent keys yet; the checked program's sizing
    call) and frame 1 (jit's warm-up of the next key) run eagerly, frame 2
    captures, the rest replay.  A temporal plan (TAA's history, the
    visibility history) keys frame 1 anew, which sizes its own capacities
    first: it captures at frame 3 and replays one frame fewer.  The eager
    call again runs from the
    persistent state (TAA's history, the visibility history) its first
    call started from, and leaves the state as that call left it."""
    from lsr_tpu_torch.pipeline.executor import RenderContext

    held = {}

    def eager(i):
        held["before"] = dict(eager_pipe._persistent_state)
        out = eager_pipe.execute(RenderContext(), state_fn(i), fp_e)
        held["after"] = dict(eager_pipe._persistent_state)
        return out

    def again(i):
        eager_pipe._persistent_state = dict(held["before"])
        out = eager_pipe.execute(RenderContext(), state_fn(i), fp_e)
        eager_pipe._persistent_state = dict(held["after"])
        return out

    return [(lambda i=i: jitted_pipe.execute_jitted(RenderContext(),
                                                    state_fn(i), fp_j),
             lambda i=i: eager(i), lambda i=i: again(i))
            for i in range(3 + OP_REPLAYS)]


def _state_outs(st):
    return {"ldr": st["ldr"], "hdr": st["hdr"]}


def one_program_phase(geom, objects, lights, ctx, cams, dev, n_slots):
    """Phase 31, one-program frames: each path through utils.jit, captured
    once into a CUDA graph and replayed, against its eager frame.
    bench.py's whole frame in phase 4's four configurations (cameras staged
    on the card, capture at camera 0, OP_REPLAYS later cameras replayed);
    cameras with another zn / zf (data: the same graph replays them, each
    as its eager frame); execute_jitted on the five presets, forward_plus+full
    and forward_classic+ssao at 1280x720 and Config #5 at 800x600 (TAA's
    history through the graph's inputs) against execute on the same states;
    and a function that reads a tensor on the host, whose capture must
    raise.  Per path: launches a replay equal to the eager frame's, outputs
    bit for bit (or within the eager frame's own spread), one capture,
    replay and eager ms by CUDA events with pipelined ms, capture ms, the
    graph's memory, device busy share of a replay and of an eager frame.
    Returns {path: result}."""
    from lsr_tpu_torch.frame import FOV, bench_config, make_flagship_frame
    from lsr_tpu_torch.full_pipeline import (
        bake_ibl, build_full_pipeline, full_scene)
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu_torch.render_paths import (
        build_forward_plus_full, build_preset_pipelines)
    from lsr_tpu_torch.scene.scene import make_camera
    from lsr_tpu_torch.utils.jit import CaptureError, jit

    t_phase = time.perf_counter()
    esm, pcf = bench_config("esm", WIDTH, HEIGHT), bench_config("pcf", WIDTH,
                                                                 HEIGHT)
    out = {}
    f1 = f1_per_frame(*plan_shadow_casters(lights))
    for name, route, b1, cfg in (
            ("esm_b2", False, 3 + n_slots, esm),
            ("esm_b2_packed", False, 3 + 2, dict(esm, atlas_packed=True)),
            ("esm_resolve", True, 3 + n_slots, esm),
            ("pcf_b2", False, 3 + n_slots, pcf)):
        frame = make_flagship_frame(geom, objects, lights, ctx, WIDTH,
                                    HEIGHT, use_resolve=route, **cfg)
        jf = jit(frame)
        want = expected({
            "rasterize_direct.launches": b1,
            "slot_inputs.launches": 0 if cfg.get("atlas_packed") else f1,
            "resolve_fused.launches" if route else "shade_fused.launches": 1})
        out[name] = _one_program(f"one-program flagship [{name}]",
                                 lambda jf=jf: jf,
                                 _flagship_steps(jf, frame, cams),
                                 lambda o: dict(zip(FLAGSHIP_OUTS, o)), want)
        if name == "esm_b2":
            # Another zn / zf: data (0-d tensors), so the same key: the
            # graph captured above replays it, equal to its eager frame.
            znf = []
            for i in (2, 3, 4):
                cam, ctx_i = cams[i]
                eye = tuple(float(v) for v in cam.eye.cpu())
                znf.append((make_camera(WIDTH, HEIGHT, eye, (0, 0, 0),
                                        fov=FOV, zn=0.25, zf=40.0,
                                        device=dev), ctx_i))
            before = jf.captures
            for i, c in enumerate(znf):
                a, b = jf(*c), frame(*c)
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      f"one-program flagship [{name}]: the zn 0.25 / zf 40 "
                      f"frame (replay {i}) differs from its eager frame")
            check(jf.captures == before,
                  f"one-program flagship [{name}]: another zn / zf made "
                  f"{jf.captures - before} captures, none expected")
            out[name]["zn_zf_replayed"] = {"zn": 0.25, "zf": 40.0,
                                           "captures": jf.captures}
            log(f"one-program flagship [{name}]: cameras with zn 0.25, zf "
                f"40 replay the same graph ({jf.captures} capture) and "
                f"equal their eager frames bit for bit")
        del jf, frame

    # execute_jitted: the presets and compositions at Phase F's size, each
    # pipeline against an eager twin on the same states.
    presets = set(PRESETS) | {"forward_classic+ssao"}
    sides = [build_preset_pipelines(RP_W, RP_H, presets, device=dev,
                                    with_pipes=True)[1] for _ in range(2)]
    fulls = [build_forward_plus_full(RP_W, RP_H, device=dev,
                                     with_pipes=True)[1] for _ in range(2)]
    for s, f in zip(sides, fulls):
        s.update(f)
    for name in sorted(sides[0]):
        (pipe_j, fp_j, state_fn), (pipe_e, fp_e, _) = (s[name]
                                                       for s in sides)
        want = pipeline_expected(fp_j, name == "forward_classic+ssao")
        out[name] = _one_program(
            f"one-program execute_jitted [{name}] {RP_W}x{RP_H}",
            lambda p=pipe_j: p._jitted.jitted,
            _pipeline_steps(pipe_j, fp_j, pipe_e, fp_e, state_fn),
            _state_outs, want)
    del sides, fulls
    # Config #5, TAA on: the history flows through the graph's inputs.
    state = full_scene(FULL_W, FULL_H, ibl=bake_ibl(dev), device=dev)
    (_, pipe_j, fp_j), (_, pipe_e, fp_e) = (
        build_full_pipeline(FULL_W, FULL_H, taa=True, state=state,
                            device=dev) for _ in range(2))
    out["config5"] = _one_program(
        f"one-program execute_jitted [Config #5] {FULL_W}x{FULL_H}",
        lambda: pipe_j._jitted.jitted,
        _pipeline_steps(pipe_j, fp_j, pipe_e, fp_e, lambda i: state),
        _state_outs, expected({"rasterize_direct.launches": 2,
                               "shade_fused.launches": 1}))

    # A host read cannot be captured: the capture raises, naming it.
    bad = jit(lambda x: x * float(x.sum()), name="reads_host")
    x = torch.ones(8, device=dev)
    check(torch.equal(bad(x), x * 8.0), "reads_host: warm-up")
    try:
        bad(x)
        raised = None
    except CaptureError as e:
        raised = str(e)
    check(raised is not None and "host read" in raised and bad.captures == 0,
          f"a host read under capture did not raise: {raised}")
    check(torch.equal((x * 3.0).cpu(), torch.full((8,), 3.0)),
          "the card after a refused capture")
    log(f"one-program: a host read under capture raised: {raised}")
    out["host_read_refused"] = raised
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 31 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 32: the high-poly route as one program (utils.capacity: checked
# capacities in place of the eager route's mid-frame host reads)
# ---------------------------------------------------------------------------

HP_TURNS = (0.0, 0.0, 0.03, 0.06, 0.09)   # warm, capture, replays (radians)
FAR_SCALES = (1.5, 2.0, 3.0, 4.0)         # the overflow drill's cameras
C23_EXTRA = 2                             # target widths past jit's bound
# The (zn, zf) pairs of the C23 drills (phases 32 and 33), data to one
# graph: near planes 0.05-0.5, far planes 30-250.
ZN_PAIRS = ((0.1, 100.0), (0.25, 40.0), (0.05, 250.0), (0.5, 60.0),
            (0.15, 80.0), (0.3, 150.0), (0.08, 30.0), (0.2, 120.0),
            (0.12, 50.0), (0.4, 90.0))


def _turned(ctx, angle, dev, scale=1.0):
    """highpoly_camera's view turned about y by angle, its distance to the
    grid's center scaled: (cam, ctx with its camera_pos)."""
    from lsr_tpu_torch.highpoly import SPACING
    from lsr_tpu_torch.scene.scene import make_camera

    ext = HP_GRID * SPACING * 0.72 * scale
    c, s = float(np.cos(angle)), float(np.sin(angle))
    eye = (ext * c + ext * s, ext * 0.9, ext * s - ext * c)
    cam = make_camera(WIDTH, HEIGHT, eye, (0, 0, 0), fov=np.pi / 3.0,
                      device=dev)
    return cam, dataclasses.replace(
        ctx, camera_pos=torch.as_tensor(eye, dtype=torch.float32,
                                        device=dev))


def _caps(prog, a):
    """The capacities prog keeps for the key of call a."""
    return prog.caps[prog.key(*a)]


def _sized(tag, prog, entry, calls, want):
    """A checked program's first call of a key (entry(calls[0]), its
    public entry point: eager, the lists sized on the host) with its
    launches checked; then that key's capacities grown to what the frames
    of calls need at them (each frame's stats from prog.fn), a bound known
    before those frames, so that their warm-up, capture and replays stay
    inside it.  Returns the capacities sized and grown."""
    key = prog.key(*calls[0])
    check(key not in prog.caps and all(prog.key(*a) == key for a in calls),
          f"{tag}: the calls must share one key that has no capacities yet")
    reset_counts()
    entry(calls[0])
    got = read_counts()
    check(got == want, f"{tag}: the sizing call launched {got}, expected "
          f"{want}")
    sized = dataclasses.asdict(prog.caps[key])
    for a in calls:
        prog.caps[key] = prog.caps[key].grown(prog.fn(*a, prog.caps[key])[1])
    log(f"{tag}: the first call sized {sized}; grown over the frames to "
        f"{dataclasses.asdict(prog.caps[key])}")
    return {"sized": sized, "caps": dataclasses.asdict(prog.caps[key])}


def _checked_steps(prog, entry, calls):
    """_one_program's steps for a checked program whose capacities cover
    every call (calls[0] warms up, calls[1] captures, the rest replay)
    through its entry point: the eager frame is prog.fn at the same
    capacities, the fitted eager route prog.fn(..., None)."""
    eager = lambda a: prog.fn(*a, _caps(prog, a))[0]  # noqa: E731
    return [(lambda a=a: entry(a), lambda a=a: eager(a), lambda a=a: eager(a),
             lambda a=a: prog.fn(*a, None)[0]) for a in calls]


def _release(prog, a):
    """Releases the graph prog holds for call a at its capacities."""
    prog.jitted.forget(*a, _caps(prog, a))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _equal_outs(tag, a, b):
    for k, v in a.items():
        px, err = _spread(v, b[k])
        check(px == 0, f"{tag}: {k} differs in {px} elements (max {err})")


def _overflow_drill(tag, prog, ctx, dev, outs_of, want):
    """A camera whose largest bin exceeds the captured list width (the
    bench view moved out until it does): its frame through the program
    replays the graph, sets the flag and is redone eagerly at grown
    capacities; what comes back equals the eager fitted frame bit for bit,
    the launches are the replay's and the redone frame's, the stale graph
    is released, and the next call captures the new key and equals its
    eager frame."""
    caps0 = None
    far = None
    for scale in FAR_SCALES:
        c = _turned(ctx, 0.0, dev, scale)
        caps0 = _caps(prog, c)
        stats = prog.fn(*c, caps0)[1]
        if int(stats["raster_max_bin"]) > caps0.list_width:
            far, need = c, int(stats["raster_max_bin"])
            break
    check(far is not None, f"{tag}: no camera of {FAR_SCALES} exceeds the "
          f"list width {caps0.list_width}")
    captures0, retries0 = prog.captures, prog.retries
    graphs0 = len(prog.jitted.graphs)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved()
    reset_counts()
    out = prog(*far)
    got = read_counts()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    caps1 = _caps(prog, far)
    twice = {k: 2 * v for k, v in want.items()}
    check(got == twice, f"{tag}: the redone frame launched {got}, expected "
          f"{twice} (the replay's and the eager frame's)")
    check(prog.retries == retries0 + 1
          and len(prog.jitted.graphs) == graphs0 - 1
          and caps1.list_width >= need > caps0.list_width,
          f"{tag}: retries {prog.retries}, graphs {len(prog.jitted.graphs)} "
          f"(before {graphs0}), caps {caps1} after a bin of {need}")
    _equal_outs(f"{tag}: the redone frame vs the eager fitted frame",
                outs_of(out), outs_of(prog.fn(*far, None)[0]))
    again = prog(*far)
    check(prog.captures == captures0 + 1,
          f"{tag}: {prog.captures - captures0} captures after the growth, "
          f"one expected")
    _equal_outs(f"{tag}: the recaptured frame vs its eager frame",
                outs_of(again), outs_of(prog.fn(*far, caps1)[0]))
    res = {"max_bin": need, "caps_before": dataclasses.asdict(caps0),
           "caps_after": dataclasses.asdict(caps1), "launches": got,
           "reserved_before_mib": held / 2**20,
           "reserved_after_release_mib": after / 2**20,
           "captures": prog.captures}
    log(f"{tag} overflow drill: a bin of {need} past the captured width "
        f"{caps0.list_width}: the flag set, the frame redone at "
        f"{dataclasses.asdict(caps1)} and equal to the eager fitted frame "
        f"bit for bit, launches {got}; the stale graph released (reserved "
        f"{held / 2**20:.1f} -> {after / 2**20:.1f} MiB); recaptured and "
        f"equal to its eager frame")
    _release(prog, far)
    return res


def _c23_drill(prog, entry, call, outs_of):
    """C23: distinct (zn, zf) pairs through one program (render_forward on
    kernel B1, its public entry point).  zn / zf are data, so every pair
    has the key of the first: one capture, no eviction, every frame bit
    for bit its eager frame at its pair (prog.fn at the key's
    capacities)."""
    jf = prog.jitted
    captures0, evictions0 = jf.captures, jf.evictions
    check(not jf.graphs, f"C23 drill: {len(jf.graphs)} graphs at the start")
    for i, (zn, zf) in enumerate(ZN_PAIRS):
        a = call(zn, zf)
        out = entry(a)
        _equal_outs(f"C23 drill: zn {zn} / zf {zf} (call {i}) vs its eager "
                    f"frame", outs_of(out),
                    outs_of(prog.fn(*a, _caps(prog, a))[0]))
    captures, evictions = jf.captures - captures0, jf.evictions - evictions0
    check(captures == 1 and evictions == 0 and len(jf.graphs) == 1,
          f"C23 drill: captures {captures}, evictions {evictions}, graphs "
          f"{len(jf.graphs)} over {len(ZN_PAIRS)} (zn, zf) pairs")
    res = {"pairs": [list(p) for p in ZN_PAIRS], "captures": captures,
           "evictions": evictions, "graphs": len(jf.graphs)}
    _release(prog, call(*ZN_PAIRS[0]))
    log(f"C23 drill: {len(ZN_PAIRS)} (zn, zf) pairs through render_forward, "
        f"{captures} capture, {evictions} evictions; every frame equal to "
        f"its eager frame bit for bit")
    return res


def _bound_drill(prog, entry, call, outs_of):
    """jit's bound on graphs: target widths past it (a leaf that is still a
    key, as lsr_tpu's static width is) through one program (render_forward
    on kernel B1): each width a key of its own, sized, warmed up and
    captured; at no time more than MAX_GRAPHS graphs, evictions counted,
    the reserved memory flat once the bound is reached, and returned when
    the graphs are released; the last width's replay equals its eager
    frame."""
    from lsr_tpu_torch.utils.jit import MAX_GRAPHS

    jf = prog.jitted
    captures0, evictions0 = jf.captures, jf.evictions
    check(not jf.graphs, f"bound drill: {len(jf.graphs)} graphs at the "
          f"start")
    widths = [WIDTH - 64 * i for i in range(MAX_GRAPHS + C23_EXTRA)]
    reserved = []
    for w in widths:
        for _ in range(3):                # sizing, warm-up, capture
            out = entry(call(w))
            check(len(jf.graphs) <= MAX_GRAPHS,
                  f"bound drill: {len(jf.graphs)} graphs alive")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved() / 2**20)
    _equal_outs("bound drill: the last width's replay vs its eager frame",
                outs_of(out),
                outs_of(prog.fn(*call(widths[-1]),
                                _caps(prog, call(widths[-1])))[0]))
    captures, evictions = jf.captures - captures0, jf.evictions - evictions0
    check(captures == len(widths) and evictions == C23_EXTRA
          and len(jf.graphs) == MAX_GRAPHS,
          f"bound drill: captures {captures}, evictions {evictions}, graphs "
          f"{len(jf.graphs)}")
    res = {"widths": widths, "captures": captures, "evictions": evictions,
           "reserved_mib_after_each_width": reserved, "bound": MAX_GRAPHS}
    for w in widths[C23_EXTRA:]:
        _release(prog, call(w))
    res["reserved_mib_released"] = released = \
        torch.cuda.memory_reserved() / 2**20
    check(not jf.graphs and released < reserved[-1],
          f"bound drill: {released:.1f} MiB reserved after the release")
    log(f"bound drill: {len(widths)} target widths through render_forward, "
        f"{captures} captures, {evictions} evictions, never more than "
        f"{MAX_GRAPHS} graphs; reserved MiB after each width "
        f"{[round(r, 1) for r in reserved]}, {released:.1f} after the "
        f"release of the last {MAX_GRAPHS}")
    return res


def highpoly_program_phase(geom, objects, ctx, hp_geom, hp_objects,
                           hp_lights, hp_ctx, dev):
    """Phase 32, the high-poly route as one program with checked capacities
    (utils.capacity), each path through its public entry point:
    render_forward at 1920x1080 on kernel B1 (the flagship scene, staged
    orbit cameras) and on kernel B3 (the high-poly scene), make_highpoly_
    frame (compact setup, B3, B2) and e2e_compact_chunklist (compact setup,
    B4) on build_highpoly_scene(33, 7), the bench view and the view turned
    by HP_TURNS.  Each path: its first call sizes its capacities (eager);
    then phase 31's checks (_one_program): launches exact at every step,
    every frame from the capture on bit for bit its eager frame at the
    same capacities and the fitted eager route's, one capture; replay,
    eager and fitted eager ms, pipelined ms, busy share, capture ms, graph
    memory.  Then the overflow drill on the high-poly frame, the C23
    drill and the bound drill on render_forward.  Returns {path:
    result}."""
    from lsr_tpu_torch import highpoly as hp
    from lsr_tpu_torch import render
    from lsr_tpu_torch.frame import flagship_camera
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.scene.scene import make_camera

    t_phase = time.perf_counter()
    cols = ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")
    hp_cams = [_turned(hp_ctx, a, dev) for a in HP_TURNS]
    out = {}

    def forward_args(g, o, cam, ctx_t):
        """render_forward's program arguments: its own (the entry point
        takes the first 15) and tiled.DIRECT_ROW_LIMIT."""
        return ({k: getattr(g, k) for k in cols}, o.model, o.normal_mat,
                cam.viewproj, cam.zn, cam.zf, ctx_t, WIDTH, HEIGHT, "pbr_mr",
                (0.05, 0.07, 0.12), True, 1024, 1.0, 2.2,
                tiled.DIRECT_ROW_LIMIT)

    def forward(a):
        return render.render_forward(*a[:15])

    def forward_outs(o):
        return {"ldr": o[0], "depth": o[1].depth01, "tid": o[1].tri_id}

    def frame_outs(o):
        return {"ldr": o[0], "hdr": o[1]["hdr"], "depth": o[1]["depth"],
                "tid": o[1]["tid"]}

    # render_forward on both routes, through its program.
    prog = render.render_forward.program
    for name, g, o, cams, kernel in (
            ("render_forward_b1", geom, objects,
             [flagship_camera(i, ctx, WIDTH, HEIGHT, device=dev)
              for i in range(2 + OP_REPLAYS)], "rasterize_direct.launches"),
            ("render_forward_b3", hp_geom, hp_objects, hp_cams,
             "rasterize_tiled.launches")):
        calls = [forward_args(g, o, c, x) for c, x in cams]
        tag = f"one-program {name} {WIDTH}x{HEIGHT}"
        want = expected({kernel: 1})
        sizing = _sized(tag, prog, forward, calls, want)
        out[name] = _one_program(tag, lambda: prog.jitted,
                                 _checked_steps(prog, forward, calls),
                                 forward_outs, want)
        out[name]["capacities"] = sizing
        if name == "render_forward_b1":
            flag_call = calls[0]
        _release(prog, calls[0])

    # The high-poly forward+ frame and the end-to-end step.
    fp = hp.highpoly_frame_params(WIDTH, HEIGHT)
    frame = hp.make_highpoly_frame(hp_geom, hp_objects, hp_lights, hp_ctx,
                                   fp)
    tag = f"one-program highpoly_frame {WIDTH}x{HEIGHT}"
    want = expected({"rasterize_tiled.launches": 1,
                     "shade_fused.launches": 1})
    sizing = _sized(tag, frame, lambda a: frame(*a), hp_cams, want)
    out["highpoly_frame"] = _one_program(
        tag, lambda: frame.jitted,
        _checked_steps(frame, lambda a: frame(*a), hp_cams), frame_outs,
        want)
    out["highpoly_frame"]["capacities"] = sizing
    out["overflow_drill"] = _overflow_drill(tag, frame, hp_ctx, dev,
                                            frame_outs, want)
    del frame

    prog = hp.e2e_compact_chunklist.program
    calls = [(hp_geom, hp_objects, c, WIDTH, HEIGHT) for c, _ in hp_cams]
    tag = f"one-program e2e_compact_chunklist {WIDTH}x{HEIGHT}"
    want = expected({"rasterize_chunklist.launches": 1})
    step = lambda a: hp.e2e_compact_chunklist(*a)  # noqa: E731
    sizing = _sized(tag, prog, step, calls, want)
    out["e2e_compact_chunklist"] = _one_program(
        tag, lambda: prog.jitted, _checked_steps(prog, step, calls),
        lambda o: {"depth": o[0], "tid": o[1]}, want)
    out["e2e_compact_chunklist"]["capacities"] = sizing
    _release(prog, calls[0])

    # C23: distinct (zn, zf) through render_forward on B1, one graph; then
    # jit's bound, with target widths (still keys) past it.
    eye = tuple(float(v) for v in flagship_camera(
        0, ctx, WIDTH, HEIGHT, device=dev)[0].eye.cpu())

    def zn_call(zn, zf):
        cam = make_camera(WIDTH, HEIGHT, eye, (0, 0, 0), zn=zn, zf=zf,
                          device=dev)
        return (flag_call[0], flag_call[1], flag_call[2], cam.viewproj,
                cam.zn, cam.zf) + flag_call[6:]

    def width_call(w):
        return flag_call[:7] + (w,) + flag_call[8:]

    out["c23_drill"] = _c23_drill(render.render_forward.program, forward,
                                  zn_call, forward_outs)
    out["bound_drill"] = _bound_drill(render.render_forward.program, forward,
                                      width_call, forward_outs)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 32 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 33: zn / zf as device data (C23) and the sharded steps as one
# program each (A18 (4), every rank on this card)
# ---------------------------------------------------------------------------

ZN_PLAIN_PAIRS = ((0.1, 100.0), (0.25, 40.0), (0.05, 250.0))
ZN_W, ZN_H = 480, 272   # the kernels against their plain versions there


def _drop_graphs(jf):
    """Releases every graph a Jitted holds and forgets its warm keys."""
    for g in jf.graphs.values():
        g.release()
    jf.graphs.clear()
    jf._warm.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _sharded_program(tag, step, arg_sets, b1, b1b, g1=0, f1=0):
    """One sharded step through jit against its undecorated eager step
    (step.fn): arg_sets[0] warms up and captures, the later sets replay.
    _one_program's checks (launches, B1b's, G1's and F1's among them,
    exact at every call; one capture) and numbers, every call from the
    capture on bit for bit the eager step.  Releases the graph; returns
    the result."""
    sets = [arg_sets[0]] + list(arg_sets)
    steps = [(lambda a=a: step(*a), lambda a=a: step.fn(*a),
              lambda a=a: step.fn(*a)) for a in sets]
    res = _one_program(tag, lambda: step, steps, lambda o: {"ldr": o},
                       expected({"rasterize_direct.launches": b1,
                                 "accumulate_local_lights.launches": g1,
                                 "slot_inputs.launches": f1}),
                       band=b1b, eager_busy=False)
    check(all(px == 0 for px, _ in res["replay_vs_eager"].values()),
          f"{tag}: a replay differs from the eager step "
          f"{res['replay_vs_eager']}")
    res["b1b_per_step"] = b1b
    _drop_graphs(step)
    return res


def sharded_program_phase(geom, objects, lights, ctx, dev):
    """Phase 33, part 1: phase 27's sharded paths (every rank on this card)
    as one program each, as lsr_tpu returns jax.jit(step): the flagship at
    SHARD_WxSHARD_H with the 2048^2 sun map on (1, 1), (1, 4) and (2, 2);
    the sharded render on (2, 2); the light-sharded forward on (sp 2, lp
    2) and (sp 1, lp 4); the pipelined render over a stream of 4 cameras.
    Each through _sharded_program: warm-up and capture at cameras (0, 2)
    of the orbit, replays at (1, 3), (2, 4), (3, 5) (the pipelined stream:
    cameras k..k+3).  Returns {path: result}."""
    from lsr_tpu_torch.core.util import cdiv
    from lsr_tpu_torch.frame import flagship_camera
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu_torch.parallel import sharding as shd

    t_phase = time.perf_counter()
    w, h = SHARD_W, SHARD_H
    cams = [flagship_camera(i, ctx, w, h, device=dev)[0] for i in range(7)]
    ctx0 = flagship_camera(0, ctx, w, h, device=dev)[1]
    pairs = [(cams[k], cams[k + 2]) for k in range(4)]
    sun = ctx.light_dir_ws
    spots, points = plan_shadow_casters(lights)
    n_spot, n_face = len(spots), 6 * len(points)
    ranks = lambda n: [dev] * n  # noqa: E731
    out = {}

    def flag_args(two):
        return (torch.stack([c.viewproj for c in two]),
                torch.stack([c.view for c in two]), two[0].proj, two[0].zn,
                two[0].zf, sun)

    for dp, sp in ((1, 1), (1, 4), (2, 2)):
        mesh = shd.make_mesh(dp * sp, dp=dp, devices=ranks(dp * sp))
        step = shd.make_sharded_flagship(mesh, geom, objects, ctx0, lights,
                                         w, h, shadow_size=SHADOW)
        b1 = (dp * sp * (cdiv(n_spot, sp) + cdiv(n_face, sp) + 1)
              + 2 * sp * 2)
        b1b = (dp * sp + 2 * sp) if sp > 1 else 0
        out[f"flagship_{dp}x{sp}"] = _sharded_program(
            f"one-program sharded flagship (dp {dp}, sp {sp}) {w}x{h}, sun "
            f"{SHADOW}^2", step, [flag_args(p) for p in pairs], b1, b1b,
            2 * sp, dp * sp * f1_per_frame(spots, points))
        del step

    mesh22 = shd.make_mesh(4, dp=2, devices=ranks(4))
    step = shd.make_sharded_render(mesh22, geom, objects, ctx0, w, h)
    out["render_2x2"] = _sharded_program(
        f"one-program sharded render (dp 2, sp 2) {w}x{h}", step,
        [(torch.stack([c.viewproj for c in p]), p[0].zn, p[0].zf)
         for p in pairs], 4, 4)
    del step

    for sp, lp in ((2, 2), (1, 4)):
        mesh = shd.make_mesh_lp(sp * lp, sp=sp, lp=lp,
                                devices=ranks(sp * lp))
        step, _ = shd.make_light_sharded_forward(mesh, geom, objects, ctx0,
                                                 lights, w, h)
        out[f"light_sharded_{sp}x{lp}"] = _sharded_program(
            f"one-program light-sharded forward (sp {sp}, lp {lp}) {w}x{h}",
            step, [(p[0].viewproj, p[0].view, p[0].proj, p[0].zn, p[0].zf)
                   for p in pairs], sp * lp, sp * lp if sp > 1 else 0,
            sp * lp)
        del step

    mesh_pp = shd.make_mesh_pp(2, devices=ranks(2))
    stream = shd.make_pipelined_render(mesh_pp, geom, objects, ctx0, w, h)
    out["pipelined_pp2"] = _sharded_program(
        f"one-program pipelined render (pp 2) {w}x{h}, stream of 4", stream,
        [(torch.stack([c.viewproj for c in cams[k:k + 4]]), cams[k].zn,
          cams[k].zf) for k in range(4)], 4, 0)
    out["pipelined_pp2"]["replay_ms_per_frame"] = \
        out["pipelined_pp2"]["replay"]["ms"] / 3
    log(f"# phase 33 part 1 took {time.perf_counter() - t_phase:.1f} s")
    return out


def _zn_path(tag, jf, calls, outs_of, eager):
    """(zn, zf) pairs through one program: calls in order, each output bit
    for bit eager(call); one capture and no eviction over all of them."""
    captures0, evictions0 = jf.captures, jf.evictions
    for (zn, zf), run, a in calls:
        _equal_outs(f"{tag}: zn {zn} / zf {zf} vs its eager frame",
                    outs_of(run()), outs_of(eager(a)))
    captures, evictions = jf.captures - captures0, jf.evictions - evictions0
    check(captures == 1 and evictions == 0,
          f"{tag}: {captures} captures, {evictions} evictions over "
          f"{len(calls)} (zn, zf) pairs; one capture, none expected")
    log(f"{tag}: {len(calls)} (zn, zf) pairs, {captures} capture, "
        f"{evictions} evictions, every frame bit for bit its eager frame")
    return {"pairs": len(calls), "captures": captures,
            "evictions": evictions}


def zn_data_phase(geom, objects, lights, ctx, dev):
    """Phase 33, part 2: zn / zf as device data.  The ten ZN_PAIRS through
    render_forward on kernel B1 (1920x1080, its checked program), through
    bench.py's whole frame in its ESM default (jit(make_flagship_frame),
    configuration (a) of phase 4) and through the sharded flagship on (1,
    4) at SHARD_WxSHARD_H: one capture and no eviction a path, every frame
    bit for bit its eager frame at its pair.  Then kernels B1 (four modes,
    given targets, a B1a stack, B1b bands), B3 and B4 with z params from
    device memory against their plain versions at the three
    ZN_PLAIN_PAIRS, bit for bit, at ZN_W x ZN_H (the plain B1 takes ~8 s
    a launch at 1080p).  Returns the results."""
    from lsr_tpu_torch import render
    from lsr_tpu_torch.frame import (
        FOV, bench_config, flagship_camera, make_flagship_frame)
    from lsr_tpu_torch.lighting.local_shadows import _stack_slot_setups
    from lsr_tpu_torch.parallel import sharding as shd
    from lsr_tpu_torch.raster import tiled
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.setup import (
        DEPTH_NDC01, DEPTH_VIEWZ, scene_setup, scene_setup_slots_depth)
    from lsr_tpu_torch.scene.scene import make_camera
    from lsr_tpu_torch.utils.jit import jit

    t_phase = time.perf_counter()
    out = {}
    base = [flagship_camera(i, ctx, WIDTH, HEIGHT, device=dev)
            for i in range(len(ZN_PAIRS))]
    eyes = [tuple(float(v) for v in c.eye.cpu()) for c, _ in base]

    def cam_at(i, zn, zf, w=WIDTH, h=HEIGHT):
        return make_camera(w, h, eyes[i], (0, 0, 0), fov=FOV, zn=zn, zf=zf,
                           device=dev)

    # render_forward on B1, through its program.
    prog = render.render_forward.program
    _drop_graphs(prog.jitted)
    cols = ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")
    batch = {k: getattr(geom, k) for k in cols}

    def fwd(i, zn, zf):
        cam = cam_at(i, zn, zf)
        return (batch, objects.model, objects.normal_mat, cam.viewproj,
                cam.zn, cam.zf, base[i][1], WIDTH, HEIGHT, "pbr_mr",
                (0.05, 0.07, 0.12), True, 1024, 1.0, 2.2,
                tiled.DIRECT_ROW_LIMIT)

    calls = [(p, lambda a=a: render.render_forward(*a[:15]), a)
             for p, a in ((p, fwd(i, *p)) for i, p in enumerate(ZN_PAIRS))]
    out["render_forward_b1"] = _zn_path(
        f"zn data: render_forward (B1) {WIDTH}x{HEIGHT}", prog.jitted, calls,
        lambda o: {"ldr": o[0], "depth": o[1].depth01, "tid": o[1].tri_id},
        lambda a: prog.fn(*a, _caps(prog, a))[0])
    _drop_graphs(prog.jitted)

    # bench.py's whole frame, configuration (a).
    frame = make_flagship_frame(geom, objects, lights, ctx, WIDTH, HEIGHT,
                                **bench_config("esm", WIDTH, HEIGHT))
    jf = jit(frame)
    args = [(cam_at(i, *p), base[i][1]) for i, p in enumerate(ZN_PAIRS)]
    calls = [(p, lambda a=a: jf(*a), a) for p, a in zip(ZN_PAIRS, args)]
    out["flagship_esm_b2"] = _zn_path(
        f"zn data: flagship [esm_b2] {WIDTH}x{HEIGHT}", jf, calls,
        lambda o: dict(zip(FLAGSHIP_OUTS, o)), lambda a: frame(*a))
    _drop_graphs(jf)
    del jf, frame

    # The sharded flagship on (1, 4).
    w, h = SHARD_W, SHARD_H
    ctx0 = flagship_camera(0, ctx, w, h, device=dev)[1]
    mesh = shd.make_mesh(4, dp=1, devices=[dev] * 4)
    step = shd.make_sharded_flagship(mesh, geom, objects, ctx0, lights, w, h,
                                     shadow_size=SHADOW)
    args = []
    for i, p in enumerate(ZN_PAIRS):
        two = [cam_at(i, *p, w, h), cam_at((i + 2) % len(eyes), *p, w, h)]
        args.append((torch.stack([c.viewproj for c in two]),
                     torch.stack([c.view for c in two]), two[0].proj,
                     two[0].zn, two[0].zf, ctx.light_dir_ws))
    calls = [(p, lambda a=a: step(*a), a) for p, a in zip(ZN_PAIRS, args)]
    out["sharded_flagship_1x4"] = _zn_path(
        f"zn data: sharded flagship (dp 1, sp 4) {w}x{h}", step, calls,
        lambda o: {"ldr": o}, lambda a: step.fn(*a))
    _drop_graphs(step)
    del step

    # B1, B3 and B4 with z params from device memory against their plain
    # versions.
    rows, strays = [], 0
    for zn, zf in ZN_PLAIN_PAIRS:
        cam = cam_at(0, zn, zf, ZN_W, ZN_H)
        setup = scene_setup(
            geom.positions, geom.normals, geom.uvs, geom.indices,
            geom.vtx_obj, geom.tri_obj, objects.model, objects.normal_mat,
            cam.viewproj, ZN_W, ZN_H)
        tag = f"zn {zn} / zf {zf}"
        for name, sort, mode, track in (
                ("sort,viewz,ids", True, DEPTH_VIEWZ, True),
                ("unsorted,viewz,ids", False, DEPTH_VIEWZ, True),
                ("sort,viewz,depth-only", True, DEPTH_VIEWZ, False),
                ("unsorted,ndc01,ids", False, DEPTH_NDC01, True)):
            _vs_plain(f"B1 {tag} [{name}]", lambda: tiled.rasterize_direct(
                setup, ZN_W, ZN_H, cam.zn, cam.zf, depth_mode=mode,
                track_ids=track, spatial_sort=sort), lambda: rasterize_brute(
                setup, ZN_W, ZN_H, cam.zn, cam.zf, depth_mode=mode), track)
        d_in = torch.full((ZN_H, ZN_W), 0.25, dtype=torch.float32,
                          device=dev)
        t_in = torch.full((ZN_H, ZN_W), 1 << 20, dtype=torch.int32,
                          device=dev)
        _vs_plain(f"B1 {tag} [given targets]",
                  lambda: tiled.rasterize_direct(
                      setup, ZN_W, ZN_H, cam.zn, cam.zf, depth_init=d_in,
                      tid_init=t_in, spatial_sort=True),
                  lambda: rasterize_brute(setup, ZN_W, ZN_H, cam.zn,
                                          cam.zf, depth_init=d_in,
                                          tid_init=t_in))
        # B1a: a stack of two 256^2 slots (this camera and the next), view-z
        # depth at the pair.
        vp2 = torch.stack([cam.viewproj,
                           cam_at(1, zn, zf, ZN_W, ZN_H).viewproj])
        ts = scene_setup_slots_depth(
            geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
            objects.model, vp2, 256,
            obj_visible_slots=objects.visible[None].expand(2, -1))
        st = _stack_slot_setups(ts, 256)
        d0, t0 = targets(256, 512, dev)
        _vs_plain(f"B1a {tag} [2 slots of 256^2, viewz]",
                  lambda: tiled.rasterize_direct(st, 256, 512, cam.zn,
                                                 cam.zf, band_h=256),
                  lambda: tiled._banded_brute(st, 256, 512, 256, cam.zn,
                                              cam.zf, d0, t0, DEPTH_VIEWZ))
        # B1b: each band against the plain raster at its global rows, bit
        # for bit but on stray sliver pixels (ROADMAP C8, counted), the
        # bands against B1's full-frame launch bit for bit.
        kw = dict(depth_mode=DEPTH_VIEWZ, track_ids=True, spatial_sort=True)
        band = ZN_H // B1B_BANDS
        full = tiled.rasterize_direct(setup, ZN_W, ZN_H, cam.zn, cam.zf,
                                      **kw)
        parts = [_b1b_band(f"B1b {tag} band {i}", setup, ZN_W, band, cam.zn,
                           cam.zf, i * band, ZN_H, kw, False, strays=True)
                 for i in range(B1B_BANDS)]
        strays += sum(r["stray_px"] for r, _, _ in parts)
        check(torch.equal(torch.cat([d for _, d, _ in parts]), full[0])
              and torch.equal(torch.cat([t for _, _, t in parts]), full[1]),
              f"B1b {tag}: the bands differ from the full-frame launch")
        d0, t0 = targets(ZN_W, ZN_H, dev)
        _b3_vs_plain(f"{tag} 32x128 chunk 8", setup, ZN_W, ZN_H, cam.zn,
                     cam.zf, 32, 8, 1024, True, d0, t0)
        _b4_vs_plain(f"{tag} viewz, ids", setup, ZN_W, ZN_H, cam.zn,
                     cam.zf, DEPTH_VIEWZ, True, 0, ZN_H)
        _b4_vs_plain(f"{tag} viewz, ids, y_offset half band", setup, ZN_W,
                     ZN_H, cam.zn, cam.zf, DEPTH_VIEWZ, True, ZN_H // 2,
                     ZN_H)
        rows.append([zn, zf])
    out["kernels_vs_plain"] = {"pairs": rows, "size": [ZN_W, ZN_H],
                               "b1_modes": 4,
                               "b1_given_targets": True, "b1a": True,
                               "b1b_bands": B1B_BANDS,
                               "b1b_stray_px": strays, "b3": True, "b4": 2}
    log(f"zn data: B1 (4 modes, given targets, B1a, {B1B_BANDS} B1b "
        f"bands), B3 and B4 with z params from device memory equal their "
        f"plain versions bit for bit at {ZN_W}x{ZN_H}, pairs {rows} (B1b "
        f"but on {strays} stray sliver px, C8)")
    log(f"# phase 33 part 2 took {time.perf_counter() - t_phase:.1f} s")
    return out


def phase33(geom, objects, lights, ctx, dev):
    """Phase 33: the sharded steps as one program each (part 1), zn / zf
    as device data (part 2).  `python3 chip_smoke.py --phase33` runs it
    alone."""
    t0 = time.perf_counter()
    out = {"sharded": sharded_program_phase(geom, objects, lights, ctx, dev),
           "zn_data": zn_data_phase(geom, objects, lights, ctx, dev)}
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 33 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 30: lsr_tpu's last modules (the engine synth and kernel S1, the mesh
# loaders with the native OBJ loader, the app / input layers)
# ---------------------------------------------------------------------------

SYNTH_RATE = 48000
# S1 against its plain version on the card, bit for bit, on the first
# samples of the demo's drive cycle: (rate, samples).  The starter at
# SYNTH_RATE; and at a rate low enough for the plain loops, the cycle up to
# 3.2 s, past the catch and the first upshift's burst (each voice of the
# step); lengths either side of S1's chunk (csrc/engine_synth.cu kChunk),
# where its stages hand over and its last chunk is padded; and 3 s at 1
# kHz, where the starter's increment passes half the rate at 1.56 s, so
# S1's later chunks wrap their phases with floorf, the earlier ones fast.
SYNTH_CHUNK = 256
SYNTH_CLIPS = {"starter": (SYNTH_RATE, 4800), "cycle_2khz": (2000, 6400),
               "one_sample": (SYNTH_RATE, 1),
               "chunk-1": (SYNTH_RATE, SYNTH_CHUNK - 1),
               "chunk+1": (SYNTH_RATE, SYNTH_CHUNK + 1),
               "3chunks+1": (SYNTH_RATE, 3 * SYNTH_CHUNK + 1),
               "floor_wrap_1khz": (1000, 3000)}
# The whole voice on the card against the plain version on the host CPU:
# the carried state rounds alike (+, *, fma, floor, clamp); the CPU's and
# the card's sine and tanh may differ by an ulp or two, which the mix,
# the softclip and the output low-pass carry to the voice as a few ulps of
# its values (below 1): 2 ulps (1.2e-7) on an H100.
SYNTH_HOST_TOL = 5e-7
SYNTH_WARMUP, SYNTH_RUNS = 1, 3    # timed calls of the demo's voice
# S1's work a sample: 24 harmonics of ~25 f32 operations (wrap, sine,
# weight, the pairwise sum), and 28 bytes (six f32 inputs, one output).
SYNTH_OPS, SYNTH_BYTES = 24 * 25, 28
# Its longest loop-carried chain a sample as S1 compiles it: a phase, fma ->
# compare (u >= 1) -> sub, 5 + 5 + 4 cycles of issue stalls in its SASS.
# The smoothers (sub, saturating fma), the noise and the output low-pass
# (sub, fma) take 8.  The plain version's form of a clamped smoother (sub,
# fma, max, min) would take 18.
SYNTH_CHAIN_CYCLES = 14
# S1 on this voice in its earlier design, one warp walking each whole step
# in order (PERF.md §6): the yardstick its log line repeats.
SYNTH_ONE_WARP_MS = 137.449
# The loaders' UV sphere: 73,728 triangles, 147,460 setup rows (two a
# triangle) with the floor's, inside B1's route (tiled.DIRECT_ROW_LIMIT).
MESH_RINGS = MESH_SECTORS = 192
MESH_FORMATS = (".obj", ".ply", ".stl", ".gltf", ".glb")
MESH_SMALL = (192, 108)            # the loaded mesh card against CPU
BOT_FRAMES, BOT_EVERY, BOT_DT = 120, 30, 1.0 / 60.0
# The rig's (pos, target()) every BOT_EVERY-th frame of the orbit bot, as
# lsr_tpu's reducers give it (tests/test_torch_app_logic.py holds this
# table against lsr_tpu's path and the port's).
ORBIT_PATH = (
    ((0.02584925535318236, 0.0, -4.562830879578419),
     (0.13961934618815702, 0.0, -3.569323775209557)),
    ((0.1184090990996883, 0.0, -4.060578756741817),
     (0.36205738942530064, 0.0, -3.090715101055408)),
    ((0.2977978943775221, 0.0, -3.5238271931286342),
     (0.6822745411444955, 0.0, -2.6006924748502973)),
    ((0.5713300842086138, 0.0, -2.9955439172125535),
     (1.0998504611169533, 0.0, -2.1466233018469785)),
)


def orbit_bot_rigs(reduce_runtime_state, emit_orbit_bot_actions, state):
    """The app layer's camera path: emit_orbit_bot_actions drives
    reduce_runtime_state for BOT_FRAMES frames of BOT_DT seconds; returns
    every BOT_EVERY-th frame's (rig.pos, rig.target())."""
    rigs = []
    for f in range(1, BOT_FRAMES + 1):
        state = reduce_runtime_state(
            state, emit_orbit_bot_actions((f - 1) * BOT_DT), BOT_DT)
        if f % BOT_EVERY == 0:
            rigs.append((tuple(state.camera.pos), state.camera.target()))
    return rigs


def _max_sm_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def _synth_cols(controls, noise):
    return tuple(getattr(controls, f.name) for f in
                 dataclasses.fields(controls)) + (noise,)


def _synth_plain_host(cols, rate):
    """In a process of its own: synthesize_plain over numpy columns on the
    host CPU, one thread.  Returns (y, seconds)."""
    from lsr_tpu_torch.audio import engine_synth as es

    torch.set_num_threads(1)
    t = [torch.from_numpy(c) for c in cols]
    t0 = time.perf_counter()
    y = es.synthesize_plain(es.EngineControls(*t[:5]), t[5], rate)
    return y.numpy(), time.perf_counter() - t0


def start_synth_reference(dev):
    """hello_engine_synth's drive cycle on the card, and synthesize_plain
    over its whole voice started on the host CPU in a process of its own
    (a minute or more of one core), which runs beside the card's phases
    until synth_phase reads it.  The process ends with the script."""
    from lsr_tpu_torch.audio import engine_synth as es
    from lsr_tpu_torch.demos import hello_engine_synth as demo

    controls, noise = es.drive_cycle(demo.SECONDS, SYNTH_RATE, 0, device=dev)
    cols = [c.cpu().numpy() for c in _synth_cols(controls, noise)]
    pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(pool.terminate)
    job = pool.apply_async(_synth_plain_host, (cols, SYNTH_RATE))
    return {"controls": controls, "noise": noise, "pool": pool, "job": job}


def synth_phase(dev, ref):
    """S1 on the demo's whole voice against the plain version on the host
    (ref, from start_synth_reference), within SYNTH_HOST_TOL, with the
    largest error in each stretch of the cycle; S1 against its plain
    version on the card bit for bit on SYNTH_CLIPS; the demo
    hello_engine_synth's main() (counts reset: exactly one S1 launch) and
    its voice equal to the compared one; S1 timed by CUDA events on that
    voice (median of SYNTH_RUNS after SYNTH_WARMUP: the kernel alone and
    the wrapper), finite with peak <= 1, spectrum_image timed; lsr_tpu's
    fundamental check at 1800 and 3600 rpm on the card."""
    from lsr_tpu_torch.audio import engine_synth as es
    from lsr_tpu_torch.demos import hello_engine_synth as demo
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    clips = {}
    for name, (rate, m) in SYNTH_CLIPS.items():
        c, z = es.drive_cycle(demo.SECONDS, rate, 0, device=dev)
        cut = lambda x: x[:m].contiguous()  # noqa: E731
        c, z = es.EngineControls(*map(cut, _synth_cols(c, z)[:5])), cut(z)
        y_k = es.synthesize(c, z, rate)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_p = es.synthesize_plain(c, z, rate)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        clips[name] = {"samples": z.shape[0], "rate": rate,
                       "max_abs_err": float((y_k - y_p).abs().max()),
                       "values_differ": int((y_k != y_p).sum()),
                       "burst_max": float(c.shift_burst.max()),
                       "plain_ms_card": plain_s * 1e3}
        log(f"S1 vs plain on the card [{name} clip]: {clips[name]}")
        check(clips[name]["values_differ"] == 0,
              f"S1 {name} clip: {clips[name]} off its plain version")
    check(clips["cycle_2khz"]["burst_max"] > 0.9,
          "the 2 kHz cycle has no shift burst")

    # Main path: the demo's main(), counts from zero.
    reset_counts()
    t0 = time.perf_counter()
    demo.main(["--device", str(dev), "--out", "out"])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches = counts()["synthesize.launches"]
    log(f"hello_engine_synth main(): {demo_s:.2f} s, S1 launches {launches}"
        f", other kernels {read_counts()}")
    check(launches == 1 and not any(read_counts().values()),
          f"hello_engine_synth: S1 launched {launches} times")

    controls, noise = ref["controls"], ref["noise"]
    n = noise.shape[0]
    cols = _synth_cols(controls, noise)
    harm = es.harmonic_table(device=dev)
    uni = torch.tensor(es.step_constants(SYNTH_RATE, 16), device=dev)
    lib, stream = load_kernels(), torch.cuda.current_stream(dev).cuda_stream
    runs = {"kernel": lambda: es._synth_launch(lib, cols, harm, uni, stream),
            "wrapper": lambda: es.synthesize(controls, noise, SYNTH_RATE)}
    times = {}
    for k, fn in runs.items():
        ms = _frames(lambda i: fn(), SYNTH_WARMUP + SYNTH_RUNS, SYNTH_WARMUP,
                     pipelined=False)[0][SYNTH_WARMUP:]
        times[k] = statistics.median(ms)
    y = runs["wrapper"]()
    check(torch.equal(demo.render(dev), y),
          "the demo's voice differs from the compared one")
    peak = float(y.abs().max())
    check(bool(torch.isfinite(y).all()) and peak <= 1.0,
          f"the voice: finite {bool(torch.isfinite(y).all())}, peak {peak}")

    # The whole voice against the plain version on the host.
    t0 = time.perf_counter()
    y_plain, plain_s = ref["job"].get(timeout=1200)
    wait_s = time.perf_counter() - t0
    ref["pool"].close()
    ref["pool"].join()
    diff = np.abs(y.cpu().numpy().astype(np.float64) - y_plain)
    spans = {"0-1 s (starter, catch)": (0.0, 1.0),
             "1-2.6 s (full throttle)": (1.0, 2.6),
             "2.6-3.2 s (first upshift's burst)": (2.6, 3.2),
             "3.2-6 s (second upshift, lift-off)": (3.2, 6.0)}
    host = {"samples": n, "max_abs_err": float(diff.max()),
            "values_differ": int((diff > 0).sum()),
            "plain_s": plain_s, "waited_s": wait_s,
            "max_abs_err_by_span": {
                k: float(diff[int(a * SYNTH_RATE):int(b * SYNTH_RATE)].max())
                for k, (a, b) in spans.items()}}
    log(f"S1 vs plain on the host CPU [the whole voice]: {host}")
    check(host["max_abs_err"] <= SYNTH_HOST_TOL,
          f"S1's voice {host['max_abs_err']} off the plain version on the "
          f"host (bound {SYNTH_HOST_TOL})")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = es.spectrum_image(y, SYNTH_RATE)
    spectrum_ms = (time.perf_counter() - t0) * 1e3
    check(img.shape == (256, 512, 3), f"spectrum image {img.shape}")

    # lsr_tpu's test_fundamental_tracks_rpm on the card, at its 24 kHz.
    rate, m = 24000, int(1.8 * 24000)
    f_peaks = {}
    for rpm in (1800.0, 3600.0):
        full = lambda v: torch.full((m,), v, device=dev)  # noqa: E731
        c = es.EngineControls(full(rpm), full(0.5), full(0.5), full(0.8),
                              full(0.0))
        seg = es.synthesize(c, full(0.0), rate).cpu().numpy()[
            int(1.2 * rate):]
        mag = np.abs(np.fft.rfft(seg * np.hanning(seg.shape[0])))
        f_peaks[rpm] = float(np.fft.rfftfreq(seg.shape[0], 1.0 / rate)[
            np.argmax(mag)])
        check(abs(f_peaks[rpm] - rpm / 15.0) < 6.0,
              f"fundamental at {rpm} rpm: {f_peaks[rpm]} Hz")

    b = bound(SYNTH_BYTES * n + nbytes(harm, uni), SYNTH_OPS * n)
    chain_ms = n * SYNTH_CHAIN_CYCLES / (_max_sm_mhz() * 1e6) * 1e3
    smem = lib.lsr_engine_synth_smem_bytes()
    # The plain version of the whole voice ran on the host CPU (on the card
    # it is some 60 launches a sample); its card times are the clips'.
    res = {"max_abs_err": host["max_abs_err"],
           "ms": times["wrapper"], "kernel_ms": times["kernel"],
           "plain_ms": plain_s * 1e3,
           "plain_on": "host CPU, one thread, beside phases 1-29",
           "plain_samples": n, **b,
           "serial_chain_floor_ms": chain_ms, "samples": n,
           "dynamic_smem_bytes": smem,
           "launches": launches, "host": host, "clips": clips,
           "demo_s": demo_s, "spectrum_ms": spectrum_ms, "peak": peak,
           "fundamental_hz": f_peaks}
    log(f"S1 on the demo's voice ({n} samples): kernel {times['kernel']:.3f}"
        f" ms, wrapper {times['wrapper']:.3f} ms (one warp walking each "
        f"step, recorded: {SYNTH_ONE_WARP_MS} ms; the plain version: "
        f"{res['plain_ms']:.1f} ms on the host CPU); bound {b}, serial "
        f"chain floor {chain_ms:.3f} ms; {smem} bytes of dynamic shared "
        f"memory; spectrum_image {spectrum_ms:.1f} ms")
    return res


def _mesh_render(scene, w, h, eye=None, target=None):
    """hello_blinn_phong's render of `scene`, from its camera or from eye
    towards target."""
    from lsr_tpu_torch.demos import hello_blinn_phong as bp
    from lsr_tpu_torch.render import render_forward, simple_camera

    if eye is None:
        return bp.render(scene, w, h)
    vp, zn, zf = simple_camera(w, h, eye, target, device=scene["device"])
    ldr, gb = render_forward(scene["batch"], scene["models"], scene["nmats"],
                             vp, zn, zf, scene["ctx"], w, h,
                             model_name="blinn_phong",
                             background=(0.04, 0.06, 0.1))
    return {"ldr": ldr, "gb": gb}


def _b1_only(tag, n):
    want = expected({"rasterize_direct.launches": n})
    got = read_counts()
    check(got == want, f"{tag}: launches {got}, expected {want}")
    return got["rasterize_direct.launches"]


def loaders_phase(dev):
    """A UV sphere of MESH_RINGS x MESH_SECTORS written as OBJ, binary PLY,
    binary STL, glTF and GLB (io/mesh_writer; OBJ floats in 9 digits),
    each loaded by io/mesh_loader.load_mesh (host ms; the OBJ through the
    native loader); the same triangles in each (STL welds its corners:
    compared by corner positions); each rendered by render_forward on
    hello_blinn_phong's scene at 1920x1080 on the card, counts reset:
    exactly one B1 launch a frame, tids equal across the five formats bit
    for bit, frames equal across those that carry the same normals and
    UVs; the OBJ's frame card against CPU at MESH_SMALL.  Then the app
    layer: the orbit bot drives the reducers for BOT_FRAMES frames on the
    host (its path ORBIT_PATH), every BOT_EVERY-th rig the camera of a
    render of the OBJ's scene, one B1 launch each, frame ms."""
    from lsr_tpu_torch.app.runtime_state import RuntimeState
    from lsr_tpu_torch.demos import hello_blinn_phong as bp
    from lsr_tpu_torch.input import value_actions as va
    from lsr_tpu_torch.io import fast_obj, mesh_loader, mesh_writer
    from lsr_tpu_torch.io.obj import make_uv_sphere

    sphere = make_uv_sphere(rings=MESH_RINGS, sectors=MESH_SECTORS)
    folder = os.path.join("build", "phase30_meshes")
    os.makedirs(folder, exist_ok=True)
    check(fast_obj.native_available(), "the native OBJ loader is not built")
    corner = lambda m, f: getattr(m, f)[m.indices]  # noqa: E731
    res, frames = {}, {}
    for ext in MESH_FORMATS:
        path = os.path.join(folder, "sphere" + ext)
        mesh_writer.write_mesh(path, sphere)
        t0 = time.perf_counter()
        mesh = mesh_loader.load_mesh(path)
        load_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(corner(mesh, "positions"),
                              corner(sphere, "positions")),
              f"{ext}: the loaded triangles differ")
        scene = bp.build_scene(mesh, dev)
        reset_counts()
        out = _mesh_render(scene, WIDTH, HEIGHT)
        torch.cuda.synchronize()
        b1 = _b1_only(f"loaded {ext} at {WIDTH}x{HEIGHT}", 1)
        ms = _frames(lambda i: _mesh_render(scene, WIDTH, HEIGHT),
                     DEMO_WARMUP + DEMO_FRAMES, DEMO_WARMUP,
                     pipelined=False)[0][DEMO_WARMUP:]
        same_attrs = all(np.array_equal(corner(mesh, f), corner(sphere, f))
                         for f in ("normals", "uvs"))
        frames[ext] = (out, same_attrs)
        res[ext] = {"load_ms": load_ms, "vertices": mesh.num_vertices,
                    "triangles": mesh.num_triangles,
                    "bytes": os.path.getsize(path), "b1_launches": b1,
                    "ms": statistics.median(ms), "ms_min": min(ms),
                    "ms_max": max(ms), "covered": int(out["gb"].covered.sum()),
                    "same_normals_uvs": same_attrs}
        log(f"loaded sphere{ext}: {res[ext]}")
    ref = frames[".obj"][0]
    check(frames[".gltf"][1] and frames[".glb"][1],
          "glTF does not carry the written normals and UVs")
    for ext, (out, same_attrs) in frames.items():
        check(torch.equal(out["gb"].tri_id, ref["gb"].tri_id),
              f"{ext}: tids differ from the OBJ's")
        if same_attrs:
            check(torch.equal(out["ldr"], ref["ldr"]),
                  f"{ext}: frame differs from the OBJ's")
    del frames

    obj = mesh_loader.load_mesh(os.path.join(folder, "sphere.obj"))
    sw, sh = MESH_SMALL
    small = {str(d): _mesh_render(bp.build_scene(obj, d), sw, sh)
             for d in ("cpu", dev)}
    res["card_vs_cpu"] = _demo_contract("loaded sphere.obj", small["cpu"],
                                        small[str(dev)], ("tid", "ldr"),
                                        size=MESH_SMALL)

    rigs = orbit_bot_rigs(va.reduce_runtime_state, va.emit_orbit_bot_actions,
                          RuntimeState(bot_enabled=True))
    check(tuple(rigs) == ORBIT_PATH, f"the bot's path {rigs} differs from "
          "lsr_tpu's (ORBIT_PATH)")
    scene = bp.build_scene(obj, dev)
    reset_counts()
    bot_ms = []
    for pos, target in rigs:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = _mesh_render(scene, WIDTH, HEIGHT, pos, target)
        e1.record()
        torch.cuda.synchronize()
        bot_ms.append(e0.elapsed_time(e1))
        check(int(out["gb"].covered.sum()) > 0, f"rig at {pos}: empty frame")
    res["bot"] = {"renders": len(rigs), "ms": bot_ms,
                  "b1_launches": _b1_only("orbit bot renders", len(rigs))}
    log(f"orbit bot: {res['bot']}")
    return res


def phase30(dev, synth_ref):
    """Phase 30: synth_phase, then loaders_phase."""
    t_start = time.perf_counter()
    res = {"synth": synth_phase(dev, synth_ref),
           "loaders": loaders_phase(dev)}
    log(f"# phase 30 took {time.perf_counter() - t_start:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 34: the planes' crop windows (kernel V1) and windowed planes (V2)
# ---------------------------------------------------------------------------

VIS_TOL = 1e-6       # C1's kernel contract, for an op that is not bit for bit
P34_REPLAYS = 3      # replayed frames a plane route
P34_PROFILED = 5     # replays of the planes alone in one profiled window
# Work counts for V1 / V2's bounds (f32 operations).  V1's, counted on
# the run's data (_v1_ops), as its test (vis_common.cuh in_map) leaves
# off at the first false term: a spot plane's pixel projects w's row (6:
# 3 products, 3 sums) and tests |w| >= 1e-8 (2), then w > 0 (1); each of
# u, v, z01 that is reached takes its row, its division and * 0.5 + 0.5
# (9) and its lower compare (1), its upper compare (1) only where the
# lower held.  A point plane's pixel: the offset (3) and the norm (6, its
# f64 products and sums counted at the f32 rate) and len > 1e-4 (1), then
# len < range (1).  V2's plane, a pixel inside a running window: the bias
# (norm, divide, dot, clamps ~25), the projection and NDC (~40), the
# texel, the ESM fetch and exp (~10) or the PCF box (3 a tap).
V1_OPS_W, V1_OPS_AXIS, V1_OPS_POINT = 8, 10, 10
V2_OPS = 75
# V2's upsample of an output at vis_scale > 1: three two-tap sums (6
# products, 3 adds).
V2_UP_OPS = 9
# The drill lights on the grid-2 scene (tests/test_torch_vis_crop.py): a
# tight spot, a wide spot, a spot looking up (empty footprint), a point, a
# culled point.
DRILL_ENABLED = (True, True, True, True, False)


def drill_crop(h, w):
    """The drill's cascade for an h x w frame: a quarter and a half of each
    side, rounded up to 8 rows and 128 columns; level 0 holds the tight
    spot, no level the wide one."""
    def lv(f):
        return (-(-(h // f) // 8) * 8, -(-(w // f) // 128) * 128)

    return (lv(4), lv(2))


@contextlib.contextmanager
def plain_planes():
    """The planes' plain route on the card, for phase 34's measurement of
    what V1 and V2 replace: vis_kernel's wrappers call the plain versions
    (their counters stay 0).  No entry point runs it."""
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.lighting import vis_kernel as vk

    def v1(sh, wp):
        return ls.vis_windows_plain(sh, wp)

    def v2(sh, wp, nm, win, run):
        return ls.vis_planes_full_plain(sh, wp, nm, win, run)

    v1.launches = v2.launches = 0
    saved = vk.vis_windows, vk.vis_planes
    vk.vis_windows, vk.vis_planes = v1, v2
    try:
        yield
    finally:
        vk.vis_windows, vk.vis_planes = saved


def _levels_of(sh, win, run, h, w):
    """Each plane's level of its cascade: its index, "full" (no level
    holds the footprint, or no cascade) or "off" (run flag false)."""
    from lsr_tpu_torch.lighting.local_shadows import vis_levels

    lv = vis_levels(sh, h, w)
    out = []
    for (_, _, ch, cw), go in zip(win.tolist(), run.tolist()):
        out.append("off" if not go else lv.index((ch, cw))
                   if (ch, cw) in lv else "full")
    return out


def _window_mask(win, run, h, w):
    """(K, h, w) bool: the strided pixels inside each running plane's
    window."""
    ys = torch.arange(h, device=win.device)[None, :, None]
    xs = torch.arange(w, device=win.device)[None, None, :]
    y0, x0, ch, cw = (win[:, i, None, None] for i in range(4))
    return (run[:, None, None] & (ys >= y0) & (ys < y0 + ch) & (xs >= x0)
            & (xs < x0 + cw))


def _v1_ops(sh, wp):
    """V1's f32 operations on this run's data: each (strided pixel,
    plane) charged the terms of its footprint test up to the first false
    one (V1_OPS_*), from the plain version's projected values."""
    from lsr_tpu_torch.core import math3d as m3
    from lsr_tpu_torch.lighting import local_shadows as ls

    g, _ = ls.vis_grid(sh, wp)
    spot_ks, point_ks = ls._kinds(sh)
    ops = 0
    if spot_ks:
        _, (px, py, pz, pw) = ls._spot_clip(sh, spot_ks, g)
        u, v, z01, w_ok = ls._uvz(px, py, pz, pw)
        at_u = w_ok & (pw > 0.0)
        at_v = at_u & (u >= 0.0) & (u <= 1.0)
        at_z = at_v & (v >= 0.0) & (v <= 1.0)
        ops += (pw.numel() * V1_OPS_W + int(w_ok.sum())
                + V1_OPS_AXIS * int(at_u.sum() + at_v.sum() + at_z.sum())
                + int((at_u & (u >= 0.0)).sum() + (at_v & (v >= 0.0)).sum()
                      + (at_z & (z01 > 0.0)).sum()))
    if point_ks:
        kt = torch.tensor(point_ks, device=g.device)
        rel_len = m3.norm3(g[None] - sh.caster_pos[kt][:, None, None, :])
        ops += rel_len.numel() * V1_OPS_POINT + int((rel_len > 1e-4).sum())
    return ops


def _touched_bytes(sh, wp, nm, win, run):
    """Bytes of the q16 tables the windows' pixels sample: the distinct
    texels of every in-map pixel inside a running plane's window (its
    (2r+1)^2 box under PCF), from the plain version's own samples."""
    from lsr_tpu_torch.lighting import local_shadows as ls

    calls = []
    orig = ls._sample

    def spy(sh_, taps, plane, cx, cy, in_map, *rest):
        calls.append((taps, plane, cx, cy, in_map, rest[-1]))
        return orig(sh_, taps, plane, cx, cy, in_map, *rest)

    ls._sample = spy
    try:
        ls.vis_planes_plain(sh, wp, nm, win, run)
    finally:
        ls._sample = orig
    h, w = calls[0][2].shape[1:] if calls else (0, 0)
    keep = _window_mask(win, run, h, w)
    r = 0 if sh.filter_mode == "esm" else int(sh.pcf_radius)
    total, i0 = 0, 0
    for taps, plane, cx, cy, in_map, size in calls:
        n = plane.shape[0]
        m = in_map & keep[i0:i0 + n]
        i0 += n
        seen = torch.zeros(taps.numel(), dtype=torch.bool, device=wp.device)
        pl, px, py = plane[m], cx[m], cy[m]
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                seen[pl * (size * size)
                     + torch.clamp(py + dy, 0, size - 1) * size
                     + torch.clamp(px + dx, 0, size - 1)] = True
        total += int(seen.sum())
    return 4 * total


def _windows_equal(tag, sh, wp):
    """V1's windows and run flags on the card, checked equal to its plain
    version's; returns (win, run, win_plain, run_plain)."""
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.lighting import vis_kernel as vk

    win_k, run_k = vk.vis_windows(sh, wp)
    win_p, run_p = ls.vis_windows_plain(sh, wp)
    torch.cuda.synchronize()
    check(torch.equal(win_k, win_p) and torch.equal(run_k, run_p),
          f"{tag}: V1's windows {win_k.tolist()} / run {run_k.tolist()} "
          f"differ from the plain version's {win_p.tolist()} / "
          f"{run_p.tolist()}")
    return win_k, run_k, win_p, run_p


def _vis_pair(tag, sh, wp, nm, timed=False):
    """V1 and V2 against their plain versions on the card: the windows and
    run flags equal, the full-resolution planes bit for bit (or within
    VIS_TOL, the differing pixels counted and logged).  timed: kernel,
    wrapper and plain ms and each kernel's bound.  Returns {"v1", "v2",
    "levels", ...}."""
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.lighting import vis_kernel as vk
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    win_k, run_k, win_p, run_p = _windows_equal(tag, sh, wp)
    pl_k = vk.vis_planes(sh, wp, nm, win_k, run_k)
    pl_p = ls.vis_planes_full_plain(sh, wp, nm, win_p, run_p)
    px, err = _spread(pl_k, pl_p)
    check(bool(torch.isfinite(pl_k).all()) and err <= VIS_TOL
          and pl_k.shape == pl_p.shape == (sh.n_shadowed + 1,)
          + tuple(wp.shape[:2]),
          f"{tag}: V2 differs from its plain version in {px} values (max "
          f"{err}, tolerance {VIS_TOL})")
    h, w = ls.vis_grid_shape(sh, wp)
    k = sh.n_shadowed
    levels = _levels_of(sh, win_k, run_k, h, w)
    v1 = {"max_abs_err": 0.0, "windows": win_k.tolist(),
          "run": run_k.tolist()}
    v2 = {"max_abs_err": err, "values_differ": px,
          "not_bit_equal": (None if px == 0 else
                            "esm: expf" if sh.filter_mode == "esm"
                            else "pcf: the box mean")}
    res = {"v1": v1, "v2": v2, "levels": levels, "grid": [h, w],
           "out": list(wp.shape[:2]), "planes": k + 1,
           "filter": sh.filter_mode, "vis_scale": sh.vis_scale,
           "tables": str(next(t for t in (sh.spot_taps, sh.point_taps)
                              if t is not None).dtype).replace("torch.", "")}
    note = ""
    if timed:
        lib = load_kernels()
        v1.update(kernel_ms=graph_ms(
            lambda: vk._windows_launch(
                lib, sh, wp, torch.cuda.current_stream().cuda_stream)),
            ms=cuda_ms(lambda: vk.vis_windows(sh, wp), 20),
            plain_ms=cuda_ms(lambda: ls.vis_windows_plain(sh, wp), 5))
        v2.update(kernel_ms=graph_ms(lambda: vk._planes_launch(
            lib, sh, wp, nm, win_k, run_k,
            torch.cuda.current_stream().cuda_stream)),
            ms=cuda_ms(lambda: vk.vis_planes(sh, wp, nm, win_k, run_k), 20),
            plain_ms=cuda_ms(lambda: ls.vis_planes_full_plain(
                sh, wp, nm, win_p, run_p), 3))
        tables = nbytes(sh.spot_viewproj, sh.caster_pos, sh.caster_range)
        v1.update(bound(h * w * 12 + tables + 17 * k, _v1_ops(sh, wp)))
        live = int(sum(c * d for (_, _, c, d), go in zip(win_k.tolist(),
                                                        run_k.tolist())
                       if go))
        # World positions and normals are read where some running window
        # holds the strided pixel.
        read_px = int(_window_mask(win_k, run_k, h, w).any(0).sum())
        touched = _touched_bytes(sh, wp, nm, win_k, run_k)
        box = (1 if sh.filter_mode == "esm"
               else 3 * (2 * sh.pcf_radius + 1) ** 2)
        out_px = (k + 1) * wp.shape[0] * wp.shape[1]
        up = 0 if sh.vis_scale <= 1 else out_px * V2_UP_OPS
        v2.update(bound(read_px * 24 + out_px * 4 + touched
                        + nbytes(sh.spot_viewproj, sh.point_viewproj,
                                 sh.caster_pos, sh.caster_range,
                                 sh.strength) + 17 * k,
                        live * (V2_OPS + box) + up),
                  table_bytes_touched=touched, window_pixels=live,
                  pixels_read=read_px, outputs=out_px)
        note = (f"; V1 kernel {v1['kernel_ms']:.4f} ms (wrapper "
                f"{v1['ms']:.4f}, plain {v1['plain_ms']:.3f}, bound "
                f"{v1['bound_ms']:.5f} by {v1['bound_by']}), V2 kernel "
                f"{v2['kernel_ms']:.4f} ms (wrapper {v2['ms']:.4f}, plain "
                f"{v2['plain_ms']:.3f}, bound {v2['bound_ms']:.5f} by "
                f"{v2['bound_by']}; {live} window pixels, {touched} table "
                f"bytes touched)")
    log(f"{tag}: {k + 1} planes on {h}x{w} written at "
        f"{wp.shape[0]}x{wp.shape[1]} ({res['tables']} tables), levels "
        f"{levels}; V1 equals its plain version, V2 "
        + ("bit for bit" if px == 0 else
           f"differs in {px} values (max {err:.3g}; {v2['not_bit_equal']})")
        + note)
    return res


def _planes_graph(tag, sh, wp, nm, dev, plain):
    """The planes alone as one captured graph (closing over their inputs;
    one dummy argument keys it), on the plain route or on V1 + V2: the
    planes of a replay, its ms by CUDA events and torch.profiler's busy
    ms, kernels and copies (the output's copy out of the graph) a replay,
    from windows of P34_PROFILED replays, flagged where no two windows
    agree that they recorded them all (_busy_replays: profile_complete
    False, a lower bound)."""
    from lsr_tpu_torch.lighting.local_shadows import local_shadow_vis_planes
    from lsr_tpu_torch.utils.jit import jit

    dummy = torch.zeros((), device=dev)
    with plain_planes() if plain else contextlib.nullcontext():
        jp = jit(lambda d: local_shadow_vis_planes(sh, wp, nm),
                 name=f"planes {tag}")
        jp(dummy)
        jp(dummy)
        ms = [_timed(lambda: jp(dummy))[1] for _ in range(P34_REPLAYS)]
        out = jp(dummy)
        busy = _busy_replays(lambda: jp(dummy), statistics.median(ms),
                             P34_PROFILED,
                             match=lambda name: "Memcpy" not in name)
        check(jp.captures == 1, f"planes {tag}: {jp.captures} captures")
        _drop_graphs(jp)
    return out, {**_ms_summary(ms), "busy_ms": busy["device_busy_ms"],
                 "busy_ms_no_copies": busy["match_ms"],
                 "kernels": busy["kernels"], "copies": busy["copies"],
                 "profile_complete": busy["complete"],
                 "profiled_windows": busy["windows"]}


def _frame_route(cfg, geom, objects, lights, ctx, cams, plain):
    """bench.py's whole frame through jit on one plane route: camera 0
    warms up and captures, P34_REPLAYS later cameras replay (CUDA events),
    torch.profiler over one replay (V1 / V2's kernels by name).  Returns
    (outputs of the replays, the result)."""
    from lsr_tpu_torch.frame import make_flagship_frame
    from lsr_tpu_torch.utils.jit import jit

    reset_counts()
    with plain_planes() if plain else contextlib.nullcontext():
        jf = jit(make_flagship_frame(geom, objects, lights, ctx, WIDTH,
                                     HEIGHT, **cfg))
        frames = [0]

        def call(c):
            frames[0] += 1
            return jf(*c)

        call(cams[0])
        call(cams[0])
        outs, ms = [], []
        for c in cams[1:1 + P34_REPLAYS]:
            o, m = _timed(lambda c=c: call(c))
            outs.append(o)
            ms.append(m)
        busy = _busy_seen(lambda: call(cams[1]), statistics.median(ms),
                          match=lambda n: "vis_" in n)
        check(jf.captures == 1, f"frame route: {jf.captures} captures")
        _drop_graphs(jf)
    n = 0 if plain else frames[0]
    check(read_vis_counts() == {"vis_windows": n, "vis_planes": n},
          f"frame route ({'plain' if plain else 'V1 + V2'}): V1 / V2 "
          f"launches {read_vis_counts()} in {frames[0]} frames")
    return outs, {**_ms_summary(ms), "busy_ms": busy["device_busy_ms"],
                  "kernels": busy["kernels"],
                  "vis_kernel_ms": busy["match_ms"],
                  "vis_kernels": busy["match_kernels"],
                  "vis_kernel_ms_by_name": busy["match_by_name"]}


def _drill(dev, f32=False):
    """The four drill cases on the card at 1920x1080 (grid-2 scene, the
    five drill lights, drill_crop), under ESM and PCF at vis_scale 1 and
    2 (f32: PCF on f32 tables, f32_tables): V1 / V2 against their plain
    versions, and each light where it is meant to be (tight spot level 0,
    wide spot the whole grid, the empty footprint and the culled point
    off)."""
    from lsr_tpu_torch.frame import (
        bench_config, build_flagship_scene, flagship_camera,
        flagship_stages)
    from lsr_tpu_torch.lighting.light_types import LightSetBuilder
    from lsr_tpu_torch.lighting.local_shadows import render_local_shadow_maps
    from lsr_tpu_torch.shading.models import _norm

    geom, objects, _, ctx = build_flagship_scene(16, grid=2, device=dev)
    lb = LightSetBuilder()
    lb.spot((0.9, 3.0, -0.3), (0.0, -1.0, 0.0), intensity=3.0, range=5.0,
            inner_angle=0.1, outer_angle=0.15)
    lb.spot((-3.5, 4.0, 1.5), (0.0, -1.0, 0.0), intensity=3.0, range=9.0,
            inner_angle=0.6, outer_angle=1.1)
    lb.spot((0.0, 3.0, 0.0), (0.0, 1.0, 0.0), intensity=3.0, range=5.0,
            inner_angle=0.4, outer_angle=0.7)
    lb.point((0.8, 0.2, -1.6), intensity=2.0, range=2.0)
    lb.point((-2.4, 1.2, -2.4), intensity=2.0, range=3.0)
    lights = lb.build(dev)
    cam, ctx_t = flagship_camera(0, ctx, WIDTH, HEIGHT, device=dev)
    st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, WIDTH,
                         HEIGHT, **CUT)
    wp, nm = st["gb"].world_pos, _norm(st["gb"].normal_ws)
    en = torch.tensor(DRILL_ENABLED, dtype=torch.bool, device=dev)
    out = {}
    for mode in ("pcf",) if f32 else ("esm", "pcf"):
        cfg = bench_config(mode, WIDTH, HEIGHT)
        for sc in (1, 2):
            with f32_tables() if f32 else contextlib.nullcontext():
                sh = render_local_shadow_maps(
                    geom, objects, lights, (0, 1, 2), (3, 4),
                    map_size=cfg["local_map"], point_size=cfg["local_point"],
                    pcf_radius=2, vis_scale=sc,
                    vis_crop=drill_crop(HEIGHT, WIDTH), caster_enabled=en,
                    filter_mode=mode)
            tag = f"{mode}{'_f32' if f32 else ''}"
            r = _vis_pair(f"phase {35 if f32 else 34} drill [{tag}, "
                          f"vis_scale {sc}]", sh, wp, nm)
            check(r["levels"] == [0, "full", "off", r["levels"][3], "off"]
                  and r["levels"][3] != "off",
                  f"drill [{mode}, vis_scale {sc}]: levels {r['levels']}, "
                  f"expected [0, full, off, a level, off]")
            out[f"{tag}_sc{sc}"] = {k: r[k] for k in ("levels", "grid",
                                                     "tables")} | {
                "v2_values_differ": r["v2"]["values_differ"],
                "v2_max_abs_err": r["v2"]["max_abs_err"]}
    return out


def phase34(geom, objects, lights, ctx, cams, dev):
    """Phase 34.  Kernels V1 (the planes' crop windows) and V2 (the
    windowed planes) against their plain versions on the card, and the
    planes' time under capture before and after.  `python3 chip_smoke.py
    --phase34` runs it alone.  For flagship (a) (ESM, half resolution) and
    (d) (PCF, full resolution), default cascade, 1920x1080:
    - at each of the orbit's cameras the eager frame's stages, and V1's
      windows and run flags equal its plain version's exactly; the level
      each plane picks, as a histogram;
    - at camera 0 V2 against its plain version (bit for bit, or within
      VIS_TOL with the differing values counted), each kernel's kernel,
      wrapper and plain ms and its bound;
    - the planes alone as one captured graph on the plain route (torch
      ops) and on V1 + V2: replay ms, busy ms and kernels;
    - the whole frame through jit on both routes: replay ms, busy ms, V1 /
      V2's busy ms inside the replay, the replays' outputs bit for bit
      between the routes.
    Then the four drill cases (_drill).  Returns the result."""
    from lsr_tpu_torch.frame import bench_config, flagship_stages
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.shading.models import _norm

    t0 = time.perf_counter()
    casters = ls.plan_shadow_casters(lights)
    out = {}
    for key, mode in (("a", "esm"), ("d", "pcf")):
        tag = f"phase 34 ({key}) [{mode}]"
        cfg = bench_config(mode, WIDTH, HEIGHT)
        hist, pair = {}, None
        for i, (cam, ctx_i) in enumerate(cams):
            st = flagship_stages(geom, objects, lights, ctx, cam, ctx_i,
                                 WIDTH, HEIGHT, casters=casters, **cfg)
            sh, gb = st["local"], st["gb"]
            wp, nm = gb.world_pos, _norm(gb.normal_ws)
            if i == 0:
                pair = _vis_pair(f"{tag} camera 0", sh, wp, nm, timed=True)
                levels = pair["levels"]
                p_plain, g_plain = _planes_graph(f"({key}) plain", sh, wp,
                                                 nm, dev, True)
                p_k, g_k = _planes_graph(f"({key}) V1 + V2", sh, wp, nm,
                                         dev, False)
                g_px, g_err = _spread(p_k, p_plain)
                check(g_err <= VIS_TOL, f"{tag}: the captured planes differ "
                      f"between the routes ({g_px} values, max {g_err})")
            else:
                win, run, _, _ = _windows_equal(f"{tag} camera {i}", sh, wp)
                levels = _levels_of(sh, win, run,
                                    *ls.vis_grid_shape(sh, wp))
            for p, lv in enumerate(levels):
                hist.setdefault(p, {}).setdefault(str(lv), 0)
                hist[p][str(lv)] += 1
        outs_plain, f_plain = _frame_route(cfg, geom, objects, lights, ctx,
                                           cams, True)
        outs_k, f_k = _frame_route(cfg, geom, objects, lights, ctx, cams,
                                   False)
        f_spread = {}
        for a, b in zip(outs_k, outs_plain):
            for name, x, y in zip(FLAGSHIP_OUTS, a, b):
                f_spread[name] = max(f_spread.get(name, (0, 0.0)),
                                     _spread(x, y))
        exact = pair["v2"]["values_differ"] == 0 and g_px == 0
        check(not exact or all(v == (0, 0.0) for v in f_spread.values()),
              f"{tag}: the frames differ between the plane routes "
              f"{f_spread}")
        out[key] = {**pair, "histogram": hist, "cameras": len(cams),
                    "planes_graph": {"plain": g_plain, "v1_v2": g_k,
                                     "values_differ": g_px},
                    "frame": {"plain": f_plain, "v1_v2": f_k,
                              "replay_vs_plain_route": f_spread}}
        log(f"{tag}: levels over {len(cams)} cameras {hist}; the planes "
            f"captured alone: plain route {g_plain['ms']:.3f} ms a replay, "
            f"busy {g_plain['busy_ms']:.4f} ms ({g_plain['kernels']:g} "
            f"kernels, {g_plain['copies']:g} copies, "
            f"{g_plain['busy_ms_no_copies']:.4f} without), V1 + V2 "
            f"{g_k['ms']:.3f} ms, busy {g_k['busy_ms']:.4f} ms "
            f"({g_k['kernels']:g} kernels, {g_k['copies']:g} copies, "
            f"{g_k['busy_ms_no_copies']:.4f} without); the frame replayed: "
            f"plain route {f_plain['ms']:.3f} ms [{f_plain['ms_min']:.3f}, "
            f"{f_plain['ms_max']:.3f}], busy {f_plain['busy_ms']:.3f} ms in "
            f"{f_plain['kernels']} kernels; V1 + V2 {f_k['ms']:.3f} ms "
            f"[{f_k['ms_min']:.3f}, {f_k['ms_max']:.3f}], busy "
            f"{f_k['busy_ms']:.3f} ms in {f_k['kernels']} kernels, of them "
            f"V1 / V2 {f_k['vis_kernel_ms']:.4f} ms in "
            f"{f_k['vis_kernels']} kernels {f_k['vis_kernel_ms_by_name']}; "
            f"replays against the plain "
            f"route {f_spread}")
    out["drill"] = _drill(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 34 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 35: V1 in one launch, V2 at full resolution, lsr_tpu's f32 PCF tables
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def f32_tables():
    """lsr_tpu's TAPS_U16 False in the port (shadow_sample.TAPS_U16): the
    tables built inside keep unit-step PCF's depth in f32."""
    from lsr_tpu_torch.lighting import shadow_sample as ss

    old = ss.TAPS_U16
    ss.TAPS_U16 = False
    try:
        yield
    finally:
        ss.TAPS_U16 = old


def _resize_calls(fn):
    """fn()'s calls of resize_bilinear on a plane stack (3-D input), through
    core/image and the name lighting/local_shadows holds."""
    from lsr_tpu_torch.core import image
    from lsr_tpu_torch.lighting import local_shadows as ls

    calls = []
    orig = image.resize_bilinear

    def spy(x, shape):
        if x.dim() == 3:
            calls.append(tuple(x.shape))
        return orig(x, shape)

    image.resize_bilinear = ls.resize_bilinear = spy
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        image.resize_bilinear = ls.resize_bilinear = orig
    return calls


def _frames_launch_v1_v2(geom, objects, lights, ctx, cams, n=4):
    """Phase 4a-d's four configurations through jit over n cameras (warm
    up, capture, replays), counts from zero: one V1 and one V2 a frame.
    Returns {config: (V1, V2) launches}."""
    from lsr_tpu_torch.frame import bench_config, make_flagship_frame
    from lsr_tpu_torch.utils.jit import jit

    esm, pcf = bench_config("esm", WIDTH, HEIGHT), bench_config("pcf", WIDTH,
                                                                 HEIGHT)
    out = {}
    for name, route, cfg in (("esm_b2", False, esm),
                             ("esm_b2_packed", False,
                              dict(esm, atlas_packed=True)),
                             ("esm_resolve", True, esm),
                             ("pcf_b2", False, pcf)):
        jf = jit(make_flagship_frame(geom, objects, lights, ctx, WIDTH,
                                     HEIGHT, use_resolve=route, **cfg))
        reset_counts()
        for c in cams[:n]:
            jf(*c)
        torch.cuda.synchronize()
        got = tuple(read_vis_counts().values())
        check(got == (n, n) and jf.captures == 1,
              f"phase 35 [{name}]: V1 / V2 launches {got} in {n} frames "
              f"({jf.captures} captures)")
        _drop_graphs(jf)
        out[name] = {"frames": n, "vis_windows": got[0],
                     "vis_planes": got[1]}
    return out


def phase35(geom, objects, lights, ctx, cams, dev, p34, whole=None):
    """Phase 35 (after phase 34, whose result p34 it summarises).  V1 in
    one launch over all planes, V2 writing the full-resolution planes,
    lsr_tpu's f32 PCF tables:
    - one V1 and one V2 launch a frame on phases 4a-d, replays included
      (their counts in whole; alone, _frames_launch_v1_v2), and no
      resize_bilinear on a plane stack while the planes are made;
    - flagship (d) (PCF control) with f32 tables: the frame's HDR finite,
      V1 exactly and V2 bit for bit against their plain versions, timed,
      and the drill's PCF cases on f32 tables at vis_scale 1 and 2.
    `python3 chip_smoke.py --phase35` runs phases 34 and 35.  Returns the
    result."""
    from lsr_tpu_torch.frame import bench_config, flagship_stages
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.shading.models import _norm

    t0 = time.perf_counter()
    out = {}
    if whole is not None:
        out["launches"] = {k: {"frames": v["frames"], **v["vis_launches"]}
                           for k, v in whole.items()}
        for k, v in out["launches"].items():
            check(v["vis_windows"] == v["vis_planes"] == v["frames"],
                  f"phase 35: V1 / V2 launches {v} on phase 4 [{k}]")
    else:
        out["launches"] = _frames_launch_v1_v2(geom, objects, lights, ctx,
                                               cams)
    cam, ctx_i = cams[0]
    for key, mode in (("(a)", "esm"), ("(d)", "pcf")):
        st = flagship_stages(geom, objects, lights, ctx, cam, ctx_i, WIDTH,
                             HEIGHT, **bench_config(mode, WIDTH, HEIGHT))
        sh, gb = st["local"], st["gb"]
        calls = _resize_calls(lambda: ls.local_shadow_vis_planes(
            sh, gb.world_pos, _norm(gb.normal_ws)))
        check(not calls, f"phase 35 {key}: resize_bilinear ran on the "
              f"planes path {calls}")
    out["resize_on_planes_path"] = 0

    with f32_tables():
        st = flagship_stages(geom, objects, lights, ctx, cam, ctx_i, WIDTH,
                             HEIGHT, **bench_config("pcf", WIDTH, HEIGHT))
    sh, gb = st["local"], st["gb"]
    check(sh.spot_taps.dtype == torch.float32 and st["shadow"].taps_q16 is
          None and bool(torch.isfinite(st["hdr"]).all()),
          "phase 35: the (d) frame on f32 tables")
    out["f32_d"] = _vis_pair("phase 35 (d) [pcf, f32 tables] camera 0", sh,
                             gb.world_pos, _norm(gb.normal_ws), timed=True)
    out["f32_drill"] = _drill(dev, f32=True)
    summary = {k: {"v1_kernel_ms": p34[k]["v1"]["kernel_ms"],
                   "v2_kernel_ms": p34[k]["v2"]["kernel_ms"],
                   "planes_graph_busy_ms": p34[k]["planes_graph"]["v1_v2"][
                       "busy_ms"],
                   "replay_ms": p34[k]["frame"]["v1_v2"]["ms"],
                   "replay_busy_ms": p34[k]["frame"]["v1_v2"]["busy_ms"]}
               for k in ("a", "d")}
    out["summary"] = summary
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 35: one V1 and one V2 a frame {out['launches']}; no "
        f"resize_bilinear on the planes path; f32 tables at (d): V1 kernel "
        f"{out['f32_d']['v1']['kernel_ms']:.4f} ms, V2 kernel "
        f"{out['f32_d']['v2']['kernel_ms']:.4f} ms (bound "
        f"{out['f32_d']['v2']['bound_ms']:.5f}); (a) / (d) from phase 34 "
        f"{summary}")
    log(f"# phase 35 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 36: kernel G1 (light_runtime.accumulate_local_lights), the general
# lighting branch's local-light sum, at the SSAO composition's shapes
# ---------------------------------------------------------------------------

G1_LIGHTS = 384       # the paths_720p deployment's light count
G1_SLICES = 16        # log-Z slices of the clustered check


def _ssao_call(w, h, n_lights, dev):
    """One eager frame of forward_classic+ssao at w x h with n_lights
    lights.  Returns (the arguments of its accumulate_local_lights call by
    name, the frame's state)."""
    from lsr_tpu_torch import render_paths
    from lsr_tpu_torch.passes import standard_passes
    from lsr_tpu_torch.pipeline.executor import RenderContext

    real_state = render_paths.scene_state

    def state(width, height, **kw):
        return real_state(width, height, **dict(kw, n_lights=n_lights))

    render_paths.scene_state = state
    try:
        with module_calls(standard_passes, "accumulate_local_lights") as rec:
            _, pipes = render_paths.build_preset_pipelines(
                w, h, {"forward_classic+ssao"}, device=dev, with_pipes=True)
            pipe, fp, state_fn = pipes["forward_classic+ssao"]
            st = pipe.execute(RenderContext(), state_fn(0), fp)
    finally:
        render_paths.scene_state = real_state
    check(len(rec.calls) == 1, f"forward_classic+ssao made {len(rec.calls)} "
          "general-branch calls, one expected")
    return rec.calls[0][0], st


def _g1_pairs(call):
    """{pairs, kept, shadowed} of one accumulate_local_lights call: the
    (pixel, light) pairs its lists hold, those G1 evaluates (not left out by
    light_walk.local_light_skips or a bounded pair's plane that reads 0),
    and those of them whose light has a plane; read off the plain
    version's own terms."""
    from lsr_tpu_torch.lighting import light_runtime as lr
    from lsr_tpu_torch.lighting import light_walk

    evaluate, shadowed = lr.eval_local_lights, lr._shadowed
    n = {"pairs": 0, "kept": 0, "shadowed": 0}
    keep = {}

    def terms(cols, wp, nrm, v):
        skip, bounded = light_walk.local_light_skips(cols, wp, nrm)
        keep["mask"], keep["bounded"] = ~skip, bounded
        n["pairs"] += skip.numel()
        n["kept"] += int((~skip).sum())
        return evaluate(cols, wp, nrm, v)

    def planes(d, s, vis_t, sidx):
        t, px = vis_t.shape[:2]
        full = (sidx[:, None, :].expand(t, px, sidx.shape[1])
                if sidx.ndim == 2 else sidx)
        dark = (keep["mask"] & keep["bounded"]
                & (torch.gather(vis_t, 2, full) == 0.0))
        n["kept"] -= int(dark.sum())
        n["shadowed"] += int((keep["mask"] & ~dark
                              & (full < vis_t.shape[2] - 1)).sum())
        return shadowed(d, s, vis_t, sidx)

    lr.eval_local_lights, lr._shadowed = terms, planes
    try:
        lr.accumulate_local_lights_plain(**call)
    finally:
        lr.eval_local_lights, lr._shadowed = evaluate, shadowed
    return n


def _g1_vs_plain(tag, call):
    """G1 (the wrapper, counts reset: one launch, no other kernel) against
    accumulate_local_lights_plain on the same call, bit for bit.  Returns
    the wrapper's (diffuse, specular)."""
    from lsr_tpu_torch.lighting import light_runtime as lr

    reset_counts()
    d, s = lr.accumulate_local_lights(**call)
    got = read_counts()
    check(got == expected({"accumulate_local_lights.launches": 1}),
          f"{tag}: launches {got}, one G1 expected")
    dp, sp = lr.accumulate_local_lights_plain(**call)
    torch.cuda.synchronize()
    for name, a, b in (("diffuse", d, dp), ("specular", s, sp)):
        check(torch.equal(a, b), f"{tag}: G1's {name} differs from the "
              f"plain version's in {int((a != b).sum())} values (max "
              f"{float((a - b).abs().max()):.3g})")
    check(float(dp.sum()) > 0.0, f"{tag}: no light reached the frame")
    return d, s


def _fplus_general(tag, st, w, h, mode):
    """forward_plus's general branch (shade_forward_plus with use_kernel
    False) on the SSAO frame's G-buffer, lights and planes, mode "tiled" or
    "clustered" (G1_SLICES slices), cap 128: one G1 launch (V1 / V2 for the
    planes read apart), HDR bit for bit the same frame with the plain
    version in G1's place."""
    from lsr_tpu_torch.lighting import light_runtime as lr
    from lsr_tpu_torch.passes import forward_plus as fpm

    cam = st["camera"]

    def frame():
        return fpm.shade_forward_plus(
            st["gbuffer"], st["shade_ctx"], st["lights"], cam.view, cam.proj,
            cam.zn, cam.zf, w, h, cap=128, mode=mode, slices=G1_SLICES,
            use_kernel=False, local_shadows=st.get("local_shadow_maps"))[0]

    reset_counts()
    hdr = frame()
    got = read_counts()
    check(got == expected({"accumulate_local_lights.launches": 1}),
          f"{tag}: launches {got}, one G1 expected")
    real = fpm.accumulate_local_lights
    fpm.accumulate_local_lights = lr.accumulate_local_lights_plain
    try:
        ref = frame()
    finally:
        fpm.accumulate_local_lights = real
    torch.cuda.synchronize()
    check(torch.equal(hdr, ref), f"{tag}: HDR differs from the plain "
          f"version's in {int((hdr != ref).sum())} values")
    return {"launches": got["accumulate_local_lights.launches"],
            "hdr_equal": True}


def local_lights_phase(dev, w=RP_W, h=RP_H, n_lights=G1_LIGHTS):
    """Phase 36.  Kernel G1 (light_runtime.accumulate_local_lights,
    csrc/local_lights.cu) on the forward_classic+ssao composition's own
    call at w x h with n_lights lights (the paths_720p deployment: 16-px
    tiles of 128-slot lists, the local-shadow planes): G1 against
    accumulate_local_lights_plain bit for bit, one launch; the same on the
    frame's lights binned per cluster (G1_SLICES slices); the same
    G-buffer, lights and planes through forward_plus's general branch,
    tiled and clustered (cap 128), one G1 launch each, HDR bit for bit the
    plain version's.  Kernel ms (the launch on packed records, tiled and
    clustered), wrapper and plain ms by CUDA events; the pairs G1
    evaluates (_g1_pairs) and its bound: the G-buffer's position and
    normal read once a pixel (24 bytes), every list slot (8 bytes) and
    light record (128 bytes) once, one plane texel a kept pair with a
    plane, 24 bytes written a pixel; LIGHT_OPS a kept pair.  Returns G1's
    entry."""
    from lsr_tpu_torch.lighting import light_runtime as lr
    from lsr_tpu_torch.lighting.light_culling import cull_lights_clustered
    from lsr_tpu_torch.passes.forward_plus import _cluster_of_pixel
    from lsr_tpu_torch.utils.cuda_build import load_kernels

    t0 = time.perf_counter()
    call, st = _ssao_call(w, h, n_lights, dev)
    lists = call["tile_lists"]
    planes = call["shadow_vis_stack"]
    tag = (f"G1 forward_classic+ssao {w}x{h}, {n_lights} lights, lists "
           f"{tuple(lists.shape)}, chunk {call['chunk']}, "
           f"{0 if planes is None else planes.shape[-1]} planes")
    d, _ = _g1_vs_plain(tag, call)
    # The same frame's lights binned per cluster, each pixel its slice.
    cam, gb = st["camera"], st["gbuffer"]
    clustered = dict(
        call, slices=G1_SLICES,
        cluster_of_pixel=_cluster_of_pixel(gb.depth01, cam.zn, cam.zf,
                                           G1_SLICES),
        tile_lists=cull_lights_clustered(
            call["lights"], cam.view, cam.proj, cam.zn, cam.zf, w, h,
            tile_size=call["tile_size"], cap=lists.shape[1],
            slices=G1_SLICES)[0])
    _g1_vs_plain(f"{tag}, clustered ({G1_SLICES} slices)", clustered)
    fplus = {m: _fplus_general(f"G1 forward_plus general branch [{m}] "
                               f"{w}x{h}", st, w, h, m)
             for m in ("tiled", "clustered")}

    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    packed = lr.pack_light_records(call["lights"])

    def launch(c):
        return lambda: lr._local_lights_launch(
            lib, c["gb_world_pos"], c["gb_normal"], c["camera_pos"], packed,
            c["tile_lists"], w, h, c["tile_size"], c["chunk"],
            c["cluster_of_pixel"], c["slices"], c["shadow_vis_stack"],
            c["light_shadow_index"], stream)

    def timed(fn, iters):
        fn()
        return cuda_ms(fn, iters)

    kernel_ms = timed(launch(call), 20)
    ms = timed(lambda: lr.accumulate_local_lights(**call), 20)
    clustered_ms = timed(launch(clustered), 20)
    plain_ms = timed(lambda: lr.accumulate_local_lights_plain(**call), 3)
    n = _g1_pairs(call)
    n_bytes = (48 * w * h + 8 * lists.numel() + 128 * call["lights"].count
               + 4 * n["shadowed"])
    res = {"max_abs_err": 0.0, "ms": ms, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms,
           **bound(n_bytes, LIGHT_OPS * n["kept"]), **n,
           "clustered_kernel_ms": clustered_ms, "forward_plus_general": fplus,
           "at": tag, "lit_px": int((d.sum(-1) > 0).sum()),
           "seconds": time.perf_counter() - t0}
    log(f"{tag}: G1 bit for bit the plain version (tiled, clustered and "
        f"forward_plus's general branch tiled and clustered, one launch "
        f"each); kernel {kernel_ms:.4f} ms (clustered {clustered_ms:.4f}), "
        f"wrapper {ms:.4f}, plain {plain_ms:.3f}; pairs {n['pairs']}, "
        f"evaluated {n['kept']} ({n['kept'] / n['pairs']:.1%}), with a "
        f"plane {n['shadowed']}; bound {res['bound_ms']:.5f} ms "
        f"({res['bound_by']}; {res['kernel_ms'] / res['bound_ms']:.1f}x "
        f"it); registers / spilled bytes {resources_of('local_lights.cu')}")
    log(f"# phase 36 took {res['seconds']:.1f} s")
    return res


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
        bench_config, build_flagship_scene, flagship_camera, flagship_stages)
    from lsr_tpu_torch.highpoly import build_highpoly_scene, highpoly_camera
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters
    from lsr_tpu_torch.utils.cuda_build import (
        build_info, kernel_resources, load_kernels)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    load_kernels()
    log(f"# kernel library {'built' if build_info['built'] else 'reused'} "
        f"in {build_info['seconds']:.1f} s (one nvcc per source, in "
        f"parallel, then a link): {build_info['path']}")
    # Phase 30's plain voice, on the host CPU beside phases 1-29.
    synth_ref = start_synth_reference(dev)
    resources = kernel_resources(build_info["log"])
    for src, fns in resources.items():
        for fn in fns:
            log(f"#   ptxas {src}: {fn}")
    if sys.argv[1:] == ["--phase30"]:
        # Phase 30 alone (S1, the loaders, the app layer), for work on them.
        entry_log("engine_synth", phase30(dev, synth_ref)["synth"])
        log(f"phase 30 alone: ok ({card})")
        return 0
    if sys.argv[1:] == ["--phase36"]:
        # Phase 36 alone (G1, the general branch's local-light sum).
        entry_log("local_lights", local_lights_phase(dev))
        log(f"phase 36 alone: ok ({card})")
        return 0

    geom, objects, lights, ctx = build_flagship_scene(N_LIGHTS, SEED,
                                                      device=dev)
    cams = [flagship_camera(i, ctx, WIDTH, HEIGHT, device=dev)
            for i in range(WARMUP + FRAMES)]
    casters = plan_shadow_casters(lights)
    n_slots = len(casters[0]) + 6 * len(casters[1])
    log(f"# scene: {geom.indices.shape[0]} triangles, {lights.count} lights "
        f"(kinds {lights.kinds}, apow1 {lights.apow1}), {WIDTH}x{HEIGHT}; "
        f"shadowed spots {casters[0]}, points {casters[1]} ({n_slots} atlas "
        f"slots)")

    if sys.argv[1:] == ["--phase31"]:
        # Phase 31 alone (the one-program frames), for work on jit.
        one_program_phase(geom, objects, lights, ctx, cams, dev, n_slots)
        log(f"phase 31 alone: ok ({card})")
        return 0
    if sys.argv[1:] == ["--phase32"]:
        # Phase 32 alone (the high-poly route as one program).
        highpoly_program_phase(geom, objects, ctx, *build_highpoly_scene(
            HP_GRID, device=dev), dev)
        log(f"phase 32 alone: ok ({card})")
        return 0
    if sys.argv[1:] == ["--phase33"]:
        # Phase 33 alone (the sharded steps as one program, zn / zf as
        # data).
        phase33(geom, objects, lights, ctx, dev)
        log(f"phase 33 alone: ok ({card})")
        return 0
    if sys.argv[1:] == ["--phase34"]:
        # Phase 34 alone (the planes' crop windows, V1 and V2).
        phase34(geom, objects, lights, ctx, cams, dev)
        log(f"phase 34 alone: ok ({card})")
        return 0
    if sys.argv[1:] == ["--phase35"]:
        # Phases 34 and 35 (V1 in one launch, V2 at full resolution, f32
        # PCF tables).
        p34 = phase34(geom, objects, lights, ctx, cams, dev)
        phase35(geom, objects, lights, ctx, cams, dev, p34)
        log(f"phases 34-35 alone: ok ({card})")
        return 0

    cam0, ctx0 = cams[0]
    st = flagship_stages(geom, objects, lights, ctx, cam0, ctx0, WIDTH, HEIGHT,
                         **CUT)
    check(bool(torch.isfinite(st["hdr"]).all()), "frame 0 HDR not finite")
    b1 = b1_phase(st["setup"], cam0, dev)
    entry_log("direct_raster (camera view)", b1)
    b2 = b2_phase(st["gb"], ctx0, lights, cam0, dev)
    entry_log("shade_fused", b2)
    cpu_side, card_side = small_reference(dev)

    # Main path: bench.py's whole frame in its ESM default, B2 route, "map"
    # atlas; counts from zero.  Then the packed atlas, the resolve route
    # and the exact-PCF control, each with its own counts.
    esm, pcf = bench_config("esm", WIDTH, HEIGHT), bench_config("pcf", WIDTH,
                                                                 HEIGHT)
    whole = {
        "esm_b2": whole_frame_phase(
            "main path [ESM default, B2 route, map atlas]", geom, objects,
            lights, ctx, cams, dev, False, 3 + n_slots,
            png="torch_flagship.png", **esm),
        "esm_b2_packed": whole_frame_phase(
            "[ESM default, B2 route, packed atlas]", geom, objects, lights,
            ctx, cams, dev, False, 3 + 2, atlas_packed=True, **esm),
        "esm_resolve": whole_frame_phase(
            "[ESM default, resolve route, map atlas]", geom, objects, lights,
            ctx, cams, dev, True, 3 + n_slots,
            png="torch_flagship_resolve.png", **esm),
        "pcf_b2": whole_frame_phase(
            "[PCF control, B2 route, map atlas]", geom, objects, lights, ctx,
            cams, dev, False, 3 + n_slots, **pcf),
    }
    launches = whole["esm_b2"]["launches"]
    one_program = one_program_phase(geom, objects, lights, ctx, cams, dev,
                                    n_slots)

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
    entry_log("tiled_raster", r1080["tiled_raster"])
    entry_log("chunklist_raster", r1080["chunklist_raster"])
    hp_launches, hp_ms = highpoly_frame_phase(hp_geom, hp_objects, hp_lights,
                                              hp_ctx, dev)
    e2e_launches, e2e_ms = e2e_phase(hp_geom, hp_objects, hp_ctx, dev)
    hp_prof = highpoly_profile_phase(hp_geom, hp_objects, hp_lights, hp_ctx,
                                     dev)
    hp_program = highpoly_program_phase(geom, objects, ctx, hp_geom,
                                        hp_objects, hp_lights, hp_ctx, dev)
    del hp_geom, hp_objects
    render_forward_phase(dev)

    # The sun shadow, B5 and B6 on the flagship scene.
    sun = sun_map_phase(geom, objects, ctx, cpu_side, card_side, dev)
    entry_log("direct_raster (sun map)", sun)
    b5 = b5_phase(st, ctx0, lights, cam0, dev)
    entry_log("resolve_fused", b5)
    b6, b6_launches = b6_phase(st["gb"], ctx0, lights, cam0, dev)
    entry_log("fplus_accumulate", b6)
    res_launches, res_ms, res_pipe = resolve_frame_phase(
        geom, objects, lights, ctx, cams, dev)

    # The whole frame's kernel branches and the card against the CPU.
    atlas = atlas_phase(geom, objects, lights, cam0, casters, dev)
    entry_log("direct_raster (occluder, atlas slots, band_h)", atlas)
    planes = planes_phase(geom, objects, lights, ctx, cam0, ctx0, casters,
                          dev)
    entry_log("shade_fused (planes)", planes["b2"])
    entry_log("resolve_fused (planes)", planes["b5"])
    small_whole_phase(dev)

    # Kernel B2's clustered branch (B2b) and the render-path presets, each
    # preset a main path of its own with its counts.
    b2b = b2b_phase(geom, objects, lights, ctx, cam0, ctx0, casters, dev)
    entry_log("shade_fused (clustered, B2b)", b2b)
    rp = render_paths_phase(dev)
    entry_log("shade_fused (clustered, B2b, render-path scene)", rp["b2b"])
    phase_i_phase(dev)
    render_paths_cpu_phase(dev)

    # lsr_tpu's compositions, each a main path of its own with its counts.
    t_comp = time.perf_counter()
    comps = compositions_phase(dev)
    comps["config5"] = full_pipeline_phase(dev)
    sweep = post_sweep_phase(dev)
    compositions_cpu_phase(dev)
    log(f"# phases 23-25 took {time.perf_counter() - t_comp:.1f} s")

    # Kernel B1's screen bands (B1b) and the sharded paths, each sharded
    # path a main path of its own with its counts.
    b1b = b1b_phase(geom, objects, ctx, st["setup"], cam0)
    entry_log("direct_raster (y_offset, B1b)", b1b)
    shard = sharded_phase(geom, objects, lights, ctx, dev)
    # The sharded steps as one program each, and zn / zf as device data.
    p33 = phase33(geom, objects, lights, ctx, dev)
    # The planes' crop windows and windowed planes (V1, V2).
    p34 = phase34(geom, objects, lights, ctx, cams, dev)
    for key in ("a", "d"):
        entry_log(f"vis_windows ({key})", p34[key]["v1"])
        entry_log(f"vis_planes ({key})", p34[key]["v2"])
    p35 = phase35(geom, objects, lights, ctx, cams, dev, p34, whole)
    # Kernel G1, the general lighting branch's local-light sum.
    g1 = local_lights_phase(dev)
    entry_log("local_lights", g1)

    # lsr_tpu's demo entry points, each a main path of its own with its
    # counts.
    demos = demos_phase(dev)

    # lsr_tpu's remaining entry points, each 3D demo a main path of its own
    # with its counts.
    rest = rest_phase(dev)

    # lsr_tpu's last modules: the engine synth (S1), the loaders, the app
    # layer, each path with its counts.
    p30 = phase30(dev, synth_ref)
    entry_log("engine_synth", p30["synth"])

    prof = profile_phase(geom, objects, lights, ctx, cam0, ctx0)
    prof.update(esm_profile_phase(geom, objects, lights, ctx, cam0, ctx0,
                                  casters))
    w = {k: f"{v['ms']:.3f}" for k, v in whole.items()}
    log(f"summary: bench.py's whole frame {w} ms (ESM default: B2 route map "
        f"/ packed atlas, resolve route; PCF control, B2 route); the cut "
        f"frame (no cull, no atlas): {res_ms:.3f} ms (resolve route, "
        f"pipelined {res_pipe:.3f}); high-poly frame {hp_ms:.3f} ms, end to end "
        f"compact + chunklist {e2e_ms:.3f} ms; device busy "
        f"{prof['esm_b2']['device_busy_ms']:.3f} / "
        f"{prof['esm_resolve']['device_busy_ms']:.3f} ms a whole ESM frame in "
        f"{prof['esm_b2']['kernels_per_frame']:.0f} / "
        f"{prof['esm_resolve']['kernels_per_frame']:.0f} kernels (B2 / "
        f"resolve route); cut frame {prof['b2']['device_busy_ms']:.3f} / "
        f"{prof['resolve']['device_busy_ms']:.3f} ms in "
        f"{prof['b2']['kernels_per_frame']:.0f} / "
        f"{prof['resolve']['kernels_per_frame']:.0f} kernels; "
        f"{hp_prof['highpoly']['device_busy_ms']:.3f} ms in "
        f"{hp_prof['highpoly']['kernels_per_frame']:.0f} kernels (high-poly "
        f"frame), {hp_prof['e2e']['device_busy_ms']:.3f} ms in "
        f"{hp_prof['e2e']['kernels_per_frame']:.0f} kernels (end-to-end "
        f"step) ({card})")
    log("summary: render-path presets at {}x{}, median ms/frame {}".format(
        RP_W, RP_H, {k: f"{rp[k]['ms']:.3f}" for k in PRESETS}))
    log("summary: sharded paths at {}x{}, all ranks on this card one after "
        "another, median ms a step {}".format(
            SHARD_W, SHARD_H, {k: f"{v['ms']:.3f}" for k, v in shard.items()}))
    log("summary: phase 33, sharded steps as one program at {}x{} (replay "
        "/ eager ms a step, busy ms of a replay, graph MiB): {}; zn / zf "
        "as data: {}".format(
            SHARD_W, SHARD_H,
            {k: f"{v['replay']['ms']:.3f} / {v['eager']['ms']:.3f}, "
                f"{v['replay_busy']['device_busy_ms']:.3f}, "
                f"{v['graph_bytes'] / 2**20:.1f}"
             for k, v in p33["sharded"].items()},
            {k: v["captures"] for k, v in p33["zn_data"].items()
             if "captures" in v}))
    log("summary: demos, median ms/frame {}".format(
        {k: f"{v['ms']:.3f} [{v['ms_min']:.3f}, {v['ms_max']:.3f}]"
         for k, v in demos.items()}))
    log("summary: phase 29, ms a frame: hello_full_pipeline {:.3f}, "
        "hello_rendering_paths {}, hello_parallelization {:.3f} (a render "
        "of all four strategies); run_phases Phase F {} (avg ms), Phase G "
        "{} ms a frame".format(
            rest["hello_full_pipeline"]["ms"],
            {k: f"{v:.3f}" for k, v in
             rest["hello_rendering_paths"]["ms"].items()},
            rest["hello_parallelization"]["ms"],
            {k: f"{v['ms_avg']:.3f}" for k, v in
             rest["run_phases"]["F"].items()},
            rest["run_phases"]["G"]["avg_frame_ms"]))
    log("summary: phase 30: S1 {:.3f} ms ({} samples; wrapper {:.3f}, "
        "plain {:.1f} ms on the host CPU), loaded-mesh frames at {}x{} {} "
        "ms, orbit bot {} ms".format(
            p30["synth"]["kernel_ms"], p30["synth"]["samples"],
            p30["synth"]["ms"], p30["synth"]["plain_ms"], WIDTH,
            HEIGHT, {k: f"{v['ms']:.3f}" for k, v in p30["loaders"].items()
                     if k in MESH_FORMATS},
            [f"{m:.3f}" for m in p30["loaders"]["bot"]["ms"]]))
    log("summary: compositions, median ms/frame {} (forward_plus+full and "
        "forward_classic+ssao at {}x{}, Config #5 at {}x{}); post-stack "
        "sweep distinct images {}".format(
            {k: f"{v['ms']:.3f}" for k, v in comps.items()}, RP_W, RP_H,
            FULL_W, FULL_H, sweep))

    at_1080p = f"{WIDTH}x{HEIGHT} high-poly compact setup"
    keys = ("max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by")

    def entry(name, src, replaces, n, res, **extra):
        return {"name": name, "route": "cuda",
                "source": f"lsr_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": n, **{k: res[k] for k in keys},
                "library_ms": None, "resources": resources.get(src, []),
                **extra}

    def sub(res, *more):
        return {k: res[k] for k in keys + more if k in res}

    pair_keys = ("pairs_tested", "pairs_after_block_cull",
                 "pairs_after_warp_cull", "pairs_needed")
    b1_keys = pair_keys + (
        "list_mean", "list_max", "chunk_tests_per_block_mean",
        "chunk_tests_per_block_max", "chunk_hits_per_block_mean",
        "chunk_hits_per_block_max")
    sun_keys = ("ms", "kernel_ms", "plain_ms", "bound_ms",
                "max_abs_err") + b1_keys
    walk_keys = tuple(k for k in b5 if k.startswith(("pairs_", "lights_")))
    frames = {k: {f: v[f] for f in ("ms", "wall_ms", "pipelined_ms",
                                    "frames", "b1_per_frame")}
              for k, v in whole.items()}
    b2b_keys = ("kernel_ms_planeless", "tiled_kernel_ms_planeless",
                "bytes", "ops", "slices", "cap", "planes", "slices_in_use",
                "clusters_listed", "records_listed", "record_table_bytes",
                "pairs_walked", "pairs_binned", "pairs_live",
                "pairs_live_shadowed", "pairs_after_warp_box",
                "pairs_after_box_and_vote")
    preset_keys = ("ms", "ms_min", "ms_max", "pipelined_ms", "frames",
                   "b1_per_frame", "launches", "pass_ms")
    compositions = {k: {f: v[f] for f in preset_keys}
                    for k, v in comps.items()}

    rest_launches = {k: rest[k]["launches"] for k in (
        "hello_full_pipeline", "hello_rendering_paths",
        "hello_parallelization")}

    def on_rest(kernel):
        return {k: v[kernel] for k, v in rest_launches.items() if v[kernel]}

    def on_demos(kernel, *more):
        return {k: {"launches": v["launches"][kernel], "size": v["size"],
                    "ms": v["ms"],
                    **{m: v[m] for m in more if m in v}}
                for k, v in demos.items() if v["launches"][kernel]}
    kernels = [
        entry("direct_raster", "direct_raster.cu",
              "lsr_tpu/raster/tiled.py:289",
              launches["rasterize_direct.launches"], b1,
              counter="rasterize_direct.launches",
              launches_per_frame={
                  a: whole[c]["launches"]["rasterize_direct.launches"]
                  / whole[c]["frames"]
                  for a, c in (("map", "esm_b2"), ("packed", "esm_b2_packed"))},
              sun_map={k: sun[k] for k in sun_keys},
              occluder=sub(atlas["occluder"], "covered"),
              atlas_slot=sub(atlas["slot"], "covered"),
              atlas_cube_face=sub(atlas["slot"]["cube_face"], "covered"),
              band_h={t: sub(v, "map_ms", "packed_ms", "slots", "size")
                      for t, v in atlas["band_h"].items()},
              launches_on_compositions={
                  k: v["launches"]["rasterize_direct.launches"]
                  for k, v in comps.items()},
              highpoly_unsorted_kernel_ms=r1080["direct_raster"]["kernel_ms"],
              launches_on_demos=on_demos("rasterize_direct.launches",
                                         "b1_mirrored_px_differ"),
              band_h_launches_on_demos=on_demos("rasterize_direct(band_h)"),
              launches_on_phase29=on_rest("rasterize_direct.launches"),
              launches_on_phase30={
                  **{f"sphere{k}": v["b1_launches"]
                     for k, v in p30["loaders"].items()
                     if k in MESH_FORMATS},
                  "orbit_bot": p30["loaders"]["bot"]["b1_launches"]},
              **{k: b1[k] for k in b1_keys}),
        entry("direct_raster (y_offset, B1b)", "direct_raster.cu",
              "lsr_tpu/raster/tiled.py:289 (y_offset: :60-79, :259-270, "
              ":573, :589)", shard["flagship_1x4"]["b1b_launches"], b1b,
              at=f"{WIDTH}x{HEIGHT} camera in {B1B_BANDS} bands, summed",
              bands=b1b["bands"], sun_map=b1b["sun_map"],
              sharded={k: {f: v[f] for f in (
                  "ms", "ranks", "steps", "b1_per_step", "b1b_per_step",
                  "launches", "b1b_launches", "busy_ms", "b1_kernel_ms",
                  "b1b_kernel_ms", "b1b_stray_px") if f in v}
                       for k, v in shard.items()},
              sharded_one_program={k: {
                  "replay": {f: v["replay"][f] for f in (
                      "ms", "ms_min", "ms_max")},
                  "eager": {f: v["eager"][f] for f in (
                      "ms", "ms_min", "ms_max")},
                  "replay_pipelined_ms": v["replay_pipelined_ms"],
                  "eager_pipelined_ms": v["eager_pipelined_ms"],
                  "replay_busy_ms": v["replay_busy"]["device_busy_ms"],
                  "replay_kernels": v["replay_busy"]["kernels"],
                  "capture_ms": v["capture_ms"],
                  "graph_mib": v["graph_bytes"] / 2**20,
                  "captures": v["captures"],
                  "launches_per_step": v["launches_per_frame"][
                      "rasterize_direct.launches"],
                  "b1b_per_step": v["b1b_per_step"]}
                  for k, v in p33["sharded"].items()}),
        entry("shade_fused", "shade_fused.cu",
              "lsr_tpu/lighting/shade_kernel.py:40",
              launches["shade_fused.launches"], b2,
              counter="shade_fused.launches",
              planes=sub(planes["b2"], "kernel_ms_planeless", "planes_change",
                         "planes", *walk_keys),
              clustered={
                  "replaces": "lsr_tpu/lighting/shade_kernel.py:295-341",
                  "launches_on_clustered_forward":
                      rp["clustered_forward"]["launches"][
                          "shade_fused.launches"],
                  "flagship_1080p": sub(b2b, *b2b_keys),
                  "render_path_720p": sub(rp["b2b"], *b2b_keys)},
              presets={k: {f: rp[k][f] for f in preset_keys}
                       for k in PRESETS},
              compositions=compositions,
              launches_on_demos=on_demos("shade_fused.launches",
                                         "b2_max_abs_err"),
              launches_on_phase29=on_rest("shade_fused.launches"),
              frames=frames, **{k: b2[k] for k in walk_keys}),
        entry("tiled_raster", "tiled_raster.cu", "lsr_tpu/raster/tiled.py:125",
              hp_launches["rasterize_tiled.launches"], r1080["tiled_raster"],
              counter="rasterize_tiled.launches", at=at_1080p,
              launches_on_demos=on_demos("rasterize_tiled.launches",
                                         "b3_max_bin", "b3_cap"),
              **{k: r1080["tiled_raster"][k] for k in pair_keys}),
        entry("chunklist_raster", "chunklist_raster.cu",
              "lsr_tpu/raster/tiled.py:697",
              e2e_launches["rasterize_chunklist.launches"],
              r1080["chunklist_raster"],
              counter="rasterize_chunklist.launches", at=at_1080p,
              **{k: r1080["chunklist_raster"][k] for k in pair_keys}),
        entry("resolve_fused", "resolve_fused.cu",
              "lsr_tpu/lighting/resolve_kernel.py:65",
              whole["esm_resolve"]["launches"]["resolve_fused.launches"], b5,
              counter="resolve_fused.launches",
              planes=sub(planes["b5"], "kernel_ms_planeless",
                         "planes_change", "planes", "pairs_live",
                         "pairs_live_shadowed"),
              cut_frame_launches=res_launches["resolve_fused.launches"],
              values_not_bit_equal=b5["values_not_bit_equal"],
              **{k: b5[k] for k in walk_keys}),
        entry("fplus_accumulate", "fplus_accumulate.cu",
              "lsr_tpu/lighting/fplus_kernel.py:46",
              b6_launches["accumulate_lights.launches"], b6,
              tile_16x128=sub(b6["tile_16x128"], *walk_keys),
              **{k: b6[k] for k in walk_keys}),
        entry("vis_windows", "vis_footprint.cu",
              "lsr_tpu/lighting/local_shadows.py:674 (lax.cond crop "
              "cascade; no pallas_call)",
              whole["esm_b2"]["vis_launches"]["vis_windows"], p34["a"]["v1"],
              at=f"flagship (a) ESM, {WIDTH}x{HEIGHT} frame, planes at "
                 f"vis_scale 2, default cascade",
              launches_per_frame={k: v["vis_launches"]["vis_windows"]
                                  / v["frames"] for k, v in whole.items()},
              pcf_control=sub(p34["d"]["v1"]),
              levels={k: p34[k]["histogram"] for k in ("a", "d")},
              drill=p34["drill"],
              f32_tables_d=sub(p35["f32_d"]["v1"]),
              launches_phase35=p35["launches"]),
        entry("vis_planes", "vis_planes.cu",
              "lsr_tpu/lighting/local_shadows.py:674 (lax.cond crop "
              "cascade; no pallas_call)",
              whole["esm_b2"]["vis_launches"]["vis_planes"], p34["a"]["v2"],
              at=f"flagship (a) ESM, {WIDTH}x{HEIGHT} frame, planes at "
                 f"vis_scale 2, default cascade",
              launches_per_frame={k: v["vis_launches"]["vis_planes"]
                                  / v["frames"] for k, v in whole.items()},
              pcf_control=sub(p34["d"]["v2"], "values_differ",
                              "table_bytes_touched", "window_pixels"),
              **{f: p34["a"]["v2"][f] for f in (
                  "values_differ", "not_bit_equal", "table_bytes_touched",
                  "window_pixels")},
              planes_captured={k: p34[k]["planes_graph"] for k in ("a", "d")},
              frames_captured={k: p34[k]["frame"] for k in ("a", "d")},
              f32_tables_d=sub(p35["f32_d"]["v2"], "values_differ",
                               "table_bytes_touched", "window_pixels"),
              f32_drill=p35["f32_drill"],
              resize_on_planes_path=p35["resize_on_planes_path"]),
        entry("local_lights", "local_lights.cu",
              "lsr_tpu/lighting/light_runtime.py (accumulate_local_lights "
              "in XLA; no pallas_call)",
              comps["forward_classic+ssao"]["launches"][
                  "accumulate_local_lights.launches"], g1,
              counter="accumulate_local_lights.launches",
              **{k: g1[k] for k in (
                  "at", "pairs", "kept", "shadowed", "bytes", "ops",
                  "clustered_kernel_ms", "forward_plus_general")},
              launches_on_compositions={
                  k: v["launches"]["accumulate_local_lights.launches"]
                  for k, v in comps.items()},
              launches_on_phase29=on_rest("accumulate_local_lights.launches"),
              sharded={k: v["g1_launches"] for k, v in shard.items()
                       if v["g1_launches"]},
              sharded_one_program={
                  k: v["launches_per_frame"][
                      "accumulate_local_lights.launches"]
                  for k, v in p33["sharded"].items()
                  if v["launches_per_frame"][
                      "accumulate_local_lights.launches"]}),
        entry("slot_setup", "slot_setup.cu",
              "the \"map\" atlas's per-slot front end: lsr_tpu/raster/"
              "setup.py scene_setup_depth + lsr_tpu/raster/tiled.py "
              "_super_lists (XLA; no pallas_call)",
              launches["slot_inputs.launches"], atlas["band_h"]["spot"]["f1"],
              counter="slot_inputs.launches",
              at=f"flagship spot stack, {atlas['band_h']['spot']['slots']} "
                 f"slots of {atlas['band_h']['spot']['size']}^2",
              stacks={**{f"flagship_{k}": v["f1"]
                         for k, v in atlas["band_h"].items()},
                      **{f"render_path_{k}": v for k, v in rp["f1"].items()}},
              launches_per_frame={
                  a: whole[c]["launches"]["slot_inputs.launches"]
                  / whole[c]["frames"]
                  for a, c in (("map", "esm_b2"), ("packed", "esm_b2_packed"),
                               ("map_resolve", "esm_resolve"),
                               ("map_pcf", "pcf_b2"))},
              launches_on_compositions={
                  k: v["launches"]["slot_inputs.launches"]
                  for k, v in comps.items()},
              launches_on_presets={
                  k: rp[k]["launches"]["slot_inputs.launches"]
                  for k in PRESETS},
              launches_on_demos=on_demos("slot_inputs.launches"),
              launches_on_phase29=on_rest("slot_inputs.launches"),
              sharded={k: v["f1_launches"] for k, v in shard.items()
                       if v["f1_launches"]},
              sharded_one_program={
                  k: v["launches_per_frame"]["slot_inputs.launches"]
                  for k, v in p33["sharded"].items()
                  if v["launches_per_frame"]["slot_inputs.launches"]}),
        entry("engine_synth", "engine_synth.cu",
              "lsr_tpu/audio/engine_synth.py:84 (lax.scan; no pallas_call)",
              p30["synth"]["launches"], p30["synth"],
              at=f"hello_engine_synth's voice, {p30['synth']['samples']} "
                 f"samples at {SYNTH_RATE} Hz",
              **{k: p30["synth"][k] for k in (
                  "plain_on", "plain_samples", "serial_chain_floor_ms",
                  "host", "clips",
                  "spectrum_ms", "fundamental_hz", "bytes", "ops")}),
    ]
    # Phase 31: each path's frame as one captured graph, against eager.
    op_keys = ("captures", "capture_ms", "graph_bytes", "replay_pipelined_ms",
               "eager_pipelined_ms", "launches_per_frame")
    op_paths = {k: {"replay": {f: v["replay"][f] for f in ("ms", "ms_min",
                                                          "ms_max")},
                    "eager": {f: v["eager"][f] for f in ("ms", "ms_min",
                                                        "ms_max")},
                    "replay_busy_share": v["replay_busy"]["busy_share"],
                    "eager_busy_share": v["eager_busy"]["busy_share"],
                    **{f: v[f] for f in op_keys},
                    **({"fit_eager": {f: v["fit_eager"][f] for f in (
                        "ms", "ms_min", "ms_max")}} if "fit_eager" in v
                       else {})}
                for k, v in {**one_program, **hp_program}.items()
                if isinstance(v, dict) and "replay" in v}
    for k in kernels:
        if "counter" in k:
            k["one_program_frames"] = {
                p: v for p, v in op_paths.items()
                if v["launches_per_frame"][k["counter"]]}
        if k["name"] == "tiled_raster":
            k["one_program_overflow_drill"] = hp_program["overflow_drill"]
        if k["name"] == "direct_raster":
            k["one_program_c23_drill"] = hp_program["c23_drill"]
            k["one_program_bound_drill"] = hp_program["bound_drill"]
            k["zn_data"] = p33["zn_data"]
    log("summary: phases 31-32, one-program frames (replay / eager ms a "
        "frame, busy share of a replay): {}".format(
            {k: f"{v['replay']['ms']:.3f} / {v['eager']['ms']:.3f}, "
                f"{v['replay_busy_share']:.1%}" for k, v in op_paths.items()}))
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched: "
          f"{[(k['name'], k['launches']) for k in kernels]}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
