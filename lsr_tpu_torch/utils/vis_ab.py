"""Time kernel V1 (csrc/vis_footprint.cu, the planes' crop windows)
against patched variants and against another tree's V1, on the card, in
one process: an A/B of its three suspects; and kernel V2
(csrc/vis_planes.cu, the full-resolution planes) against variants of its
launch.

Each variant patches one suspect out of a copy of csrc/ under build/
(git-ignored), in this tree's V1 and, with --parent DIR, in another
tree's (its csrc/, say the parent commit unpacked with `git archive` into
a git-ignored directory):
- divisions: the projection's three IEEE divisions by w become multiplies
  by its rounded reciprocal (__frcp_rn);
- f64 distance: the point test's norm in double becomes one f32 sqrt;
- atomics: the global atomicMin of the bounds becomes a plain store.
A patched variant computes another function (timing only): its windows
are compared with the shipped kernel's and the differences reported, not
checked.  The shipped kernels equal the plain version (vis_windows_plain)
exactly, or the tool raises.  This tree's V1 is also timed at other
persistent grids (blocks an SM; 6 is one wave at its 40 registers).
V2's variants compute the same planes (checked bit for bit against the
shipped kernel): its upsampling kernel held to 40 registers
(__launch_bounds__ with 6 blocks an SM), and tiles of 16 rows in place
of 8.  Inputs: bench.py's whole frame at camera 0,
1920x1080, flagship (a) (ESM, planes at vis_scale 2) and (d) (PCF, vis_scale
1), default cascade.

    python -m lsr_tpu_torch.utils.vis_ab [--parent DIR] [--rounds N]

Prints the card, each library's registers / spilled bytes per kernel
(`-Xptxas -v`) and, per input, each library's ms a call (its memset and
launch, CUDA events over 30 calls captured in one graph) over rounds in
alternating order, with the median; one JSON row per input.  A patch
whose text is no longer in the source stops the tool: update the patch
with the kernel.
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
from lsr_tpu_torch.utils.devtime import graph_ms

_P, _I = ctypes.c_void_p, ctypes.c_int
FILES = ("vis_footprint.cu", "vis_planes.cu", "vis_common.cuh")
V1_GRIDS = (2, 4, 6, 16)  # blocks an SM, beside the shipped V1_BLOCKS_PER_SM

# An earlier tree's launcher (the first V1's): bounds (K, 4), no grid size.
PARENT_SIGNATURE = (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                    _I, _P, _P, _P, _I, _P)

_F32_NORM = ("  return sqrtf(__double2float_rn(\n"
             "      __dadd_rn(__dmul_rn((double)z, (double)z), (double)s)));",
             "  return sqrtf((xx + y * y) + z * z);")


def variants(parent: bool) -> dict:
    """name -> (file, old, new) replacements for this tree's V1 (parent:
    the earlier tree's)."""
    div = ("vis_common.cuh", "/ ws)", "* __frcp_rn(ws))") if parent else \
        ("vis_common.cuh", "/ pw)", "* __frcp_rn(pw))")
    atom = (("vis_footprint.cu",
             "if (m != kNone) atomicMin(bounds + 4 * k + threadIdx.x, m);",
             "if (m != kNone) bounds[4 * k + threadIdx.x] = m;") if parent
            else ("vis_footprint.cu",
                  "if (m != kNone) atomicMin(bounds + i, m);",
                  "if (m != kNone) bounds[i] = m;"))
    return {"shipped": [],
            "divisions as reciprocal multiplies": [div] * 3,
            "f32 distance": [("vis_common.cuh", *_F32_NORM)],
            "plain stores for the atomics": [atom]}


# V2's variants: name -> (patches of vis_planes.cu, tile rows or None).
V2_VARIANTS = {
    "shipped": ([], None),
    "upsampling kernel held to 40 registers": ([(
        "vis_planes.cu", "__launch_bounds__(kThreads)\nvis_planes_up(",
        "__launch_bounds__(kThreads, 6)\nvis_planes_up(")], None),
    "tiles of 16 rows": ([], (16, 8, 4, 2, 1)),
}


def _build_all(jobs, src="vis_footprint.cu"):
    """jobs: {tag: (src_dir, patches)} -> {tag: (ctypes lib, ptxas lines)}:
    each a copy of src (and the headers) built alone; one nvcc each, all
    started together."""
    root = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "vis_ab")
    procs = {}
    for tag, (src_dir, patches) in jobs.items():
        d = os.path.join(root, tag)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in FILES:
            shutil.copy(os.path.join(src_dir, f), d)
        for name, old, new in patches:
            p = os.path.join(d, name)
            with open(p) as fh:
                text = fh.read()
            if old not in text:
                raise RuntimeError(f"vis_ab: {old!r} not in {name}")
            with open(p, "w") as fh:
                fh.write(text.replace(old, new, 1))
        so = os.path.join(d, "libvis_ab.so")
        procs[tag] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(d, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"vis_ab: nvcc failed for {tag}:\n{log}")
        res = cuda_build.kernel_resources(f"== {src}\n{log}")
        out[tag] = (ctypes.CDLL(so), [(r["registers"], r["spill_bytes"])
                                      for r in res.get(src, [])])
    return out


def _launcher(lib, parent: bool):
    fn = lib.lsr_vis_windows
    fn.argtypes = list(PARENT_SIGNATURE if parent
                       else cuda_build.SIGNATURES["lsr_vis_windows"])
    fn.restype = ctypes.c_int
    return fn


def _call(fn, parent, sh, wp, per_sm=None):
    """One call of a V1 library's launcher on (sh, wp) on the current
    stream (per_sm: this tree's grid, blocks an SM); returns (win, run)."""
    from lsr_tpu_torch.lighting import local_shadows as ls
    from lsr_tpu_torch.lighting import vis_kernel as vk
    from lsr_tpu_torch.core.util import device_const

    dev = wp.device
    k = sh.n_shadowed
    h, w = ls.vis_grid_shape(sh, wp)
    levels = ls.vis_levels(sh, h, w)
    lv = device_const(list(levels) or [(0, 0)], dev, torch.int32)
    bounds = torch.empty((4 * k + (0 if parent else 1),), dtype=torch.int32,
                         device=dev)
    win = torch.empty((k, 4), dtype=torch.int32, device=dev)
    run = torch.empty((k,), dtype=torch.bool, device=dev)
    grid = () if parent else (
        (per_sm or vk.V1_BLOCKS_PER_SM) * vk._sm_count(dev),)
    err = fn(wp.data_ptr(), *wp.stride(), h, w, max(1, int(sh.vis_scale)),
             vk._info(sh, dev).data_ptr(), vk._ptr(sh.spot_viewproj),
             sh.caster_pos.data_ptr(), sh.caster_range.data_ptr(),
             vk._ptr(sh.caster_enabled), lv.data_ptr(), len(levels),
             int(bool(ls.crop_sizes(sh.vis_crop))), bounds.data_ptr(),
             win.data_ptr(), run.data_ptr(), k, *grid,
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("lsr_vis_windows", err)
    return win, run


def ab(cases, parent_dir=None, rounds=5, log=print):
    """V1's A/B: cases {name: (sh, wp, nm)} on the card; this tree's
    variants and grids and, with parent_dir, the earlier tree's; then V2's
    variants.  Returns {"libraries": {name: ptxas}, "rows": [{input,
    median_ms, ms, windows_differ}]}."""
    from lsr_tpu_torch.lighting import local_shadows as ls

    jobs = {f"this {n}": (cuda_build.CSRC, p)
            for n, p in variants(False).items()}
    if parent_dir:
        jobs.update({f"parent {n}": (parent_dir, p)
                     for n, p in variants(True).items()})
    tag_dir = {t: "v1_" + t.replace(" ", "_") for t in jobs}
    built = _build_all({tag_dir[t]: jobs[t] for t in jobs})
    v2_dir = {t: "v2_" + t.replace(" ", "_") for t in V2_VARIANTS}
    v2_built = _build_all({v2_dir[t]: (cuda_build.CSRC, p)
                           for t, (p, _) in V2_VARIANTS.items()},
                          "vis_planes.cu")
    runs = {t: (_launcher(built[tag_dir[t]][0], t.startswith("parent")),
                t.startswith("parent"), None) for t in jobs}
    shipped = runs["this shipped"]
    runs.update({f"this shipped, {n} blocks an SM": shipped[:2] + (n,)
                 for n in V1_GRIDS})
    res = {"libraries": {t: built[tag_dir[t]][1] for t in jobs}
           | {f"V2 {t}": v2_built[v2_dir[t]][1] for t in V2_VARIANTS},
           "rows": []}
    for t, v in res["libraries"].items():
        log(f"# vis_ab {t}: registers / spilled bytes {v}")
    for name, (sh, wp, nm) in cases.items():
        want = ls.vis_windows_plain(sh, wp)
        differ = {}
        for t, (fn, parent, per_sm) in runs.items():
            got = _call(fn, parent, sh, wp, per_sm)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            if "shipped" in t and not same:
                raise RuntimeError(f"vis_ab: {t} differs from "
                                   f"vis_windows_plain on {name}")
            differ[t] = not same
        v2_runs = {f"V2 {t}": _v2_run(v2_built[v2_dir[t]][0], rows, sh, wp,
                                      nm, *want)
                   for t, (_, rows) in V2_VARIANTS.items()}
        ref = v2_runs["V2 shipped"]()
        for t, run in v2_runs.items():
            if not torch.equal(run(), ref):
                raise RuntimeError(f"vis_ab: {t} differs from the shipped "
                                   f"V2 on {name}")
        calls = {t: (lambda r=r: _call(r[0], r[1], sh, wp, r[2]))
                 for t, r in runs.items()} | v2_runs
        ms = {t: [] for t in calls}
        order = list(calls)
        for r in range(rounds):
            for t in (order if r % 2 == 0 else order[::-1]):
                ms[t].append(graph_ms(calls[t], 30))
        row = {"input": name,
               "median_ms": {t: statistics.median(v) for t, v in ms.items()},
               "ms": {t: [round(x, 5) for x in v] for t, v in ms.items()},
               "windows_differ": differ}
        res["rows"].append(row)
        log(json.dumps(row))
    return res


def _v2_run(lib, rows, sh, wp, nm, win, run):
    """A call of a V2 library through vis_kernel._planes_launch (tile rows
    from `rows` where given), as a function of no arguments."""
    from lsr_tpu_torch.lighting import vis_kernel as vk

    fn = lib.lsr_vis_planes
    fn.argtypes = list(cuda_build.SIGNATURES["lsr_vis_planes"])
    fn.restype = ctypes.c_int

    class Lib:
        lsr_vis_planes = fn

    def call():
        keep = vk.V2_TILE_ROWS
        if rows is not None:
            vk.V2_TILE_ROWS = rows
            vk.upsample_layout.cache_clear()
        try:
            return vk._planes_launch(Lib, sh, wp, nm, win, run,
                                     torch.cuda.current_stream().cuda_stream)
        finally:
            if rows is not None:
                vk.V2_TILE_ROWS = keep
                vk.upsample_layout.cache_clear()

    return call


def flagship_cases(dev):
    """{"(a)": (sh, wp, nm), "(d)": (sh, wp, nm)}: bench.py's whole frame
    at camera 0, 1920x1080, in its ESM default and its PCF control."""
    from lsr_tpu_torch.frame import (
        bench_config, build_flagship_scene, flagship_camera, flagship_stages)
    from lsr_tpu_torch.shading.models import _norm

    w, h = 1920, 1080
    geom, objects, lights, ctx = build_flagship_scene(256, 42, device=dev)
    cam, ctx_t = flagship_camera(0, ctx, w, h, device=dev)
    out = {}
    for key, mode in (("(a)", "esm"), ("(d)", "pcf")):
        st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, w, h,
                             **bench_config(mode, w, h))
        out[key] = (st["local"], st["gb"].world_pos, _norm(st["gb"].normal_ws))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another tree's lsr_tpu_torch/csrc "
                    "(its V1 takes (K, 4) bounds and no grid size)")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    ab(flagship_cases(dev), args.parent, args.rounds,
       log=lambda m: print(m, flush=True))
    print("# the shipped kernels equal vis_windows_plain", flush=True)


if __name__ == "__main__":
    main()
