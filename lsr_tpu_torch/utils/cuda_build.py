"""Build and load the hand-written CUDA kernels (lsr_tpu_torch/csrc/*.cu).

The kernels expose a plain C interface and are built by nvcc into ONE shared
library at first use, then loaded with ctypes: one nvcc process compiles
each source to an object, all of them started together, and one more links
the objects.  The library lands in <repo>/build/kernels/ (gitignored), named
by a hash of the sources, the shared headers and the flags, so an edited
source rebuilds and an unchanged one is reused.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

from lsr_tpu_torch.utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# -fmad=false: no contraction of a*b+c into FMA, so the raster kernels'
# coverage and depth arithmetic rounds exactly like their plain PyTorch
# versions (separate torch ops never contract).  No -use_fast_math for the
# same reason.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures (argtypes) of every exported function; each returns an int:
# a launcher the cudaError_t of its launch.
SIGNATURES = {
    # rec, chunk_bb, slists, counts, depth_in, tid_in, depth_out, tid_out,
    # width, height, tiles_x, scap, zparams ((2,) f32 on the card: zn,
    # inv_range), max_py, depth_mode, track_ids, tie_tid, band_h, y_offset,
    # stream
    "lsr_direct_raster": (_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _P, _F, _I, _I, _I, _I, _I,
                          _P),
    # gbuf, tile_rec, counts, uniforms, vis, n_shadowed, out, width, height,
    # ph, pw, tiles_x, cap, sun_model, apow1, stream
    "lsr_shade_fused": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    # the same with slices before sun_model (clustered records)
    "lsr_shade_fused_clustered": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _P),
    # rec, lists, counts, order, depth_in, tid_in, depth_out, tid_out, width,
    # height, tile_w, tile_h, tiles_x, tiles_y, cap, zparams, y_offset,
    # max_py, depth_mode, stream
    "lsr_tiled_raster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P, _I, _F, _I, _P),
    # rec, clists, counts, order, depth_in, tid_in, depth_out, tid_out,
    # width, height, tile_w, tile_h, tiles_x, tiles_y, ccap, chunk, sub_h,
    # zparams, y_offset, max_py, depth_mode, track_ids, stream
    "lsr_chunklist_raster": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _P, _I, _F, _I, _I, _P),
    # table, tid, sun_vis, tex, tile_rec, counts, uniforms, vis, n_shadowed,
    # out, width, height, tile_h, tile_w, tiles_x, tiles_y, cap, chunk,
    # sun_model, stream
    "lsr_resolve_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _P),
    # gbuf, tile_rec, counts, uniforms, diffuse, specular, width, height, ph,
    # pw, tile_h, tile_w, tiles_x, cap, chunk, stream
    "lsr_fplus_accumulate": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P),
    # rpm, throttle, load, torque_mul, shift_burst, noise, harm, uniforms,
    # y, n, stream
    "lsr_engine_synth": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    # (no arguments): S1's dynamic shared memory in bytes
    "lsr_engine_synth_smem_bytes": (),
    # world_pos, its strides (y, x, component), h, w, vis_scale, info,
    # spot_vp, caster_pos, caster_range, enabled, levels, n_levels,
    # has_crop, bounds (4 K + 1 ints of scratch), win, run, n_planes,
    # n_blocks, stream
    "lsr_vis_windows": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                        _I, _I, _P, _P, _P, _I, _I, _P),
    # world_pos, its strides, normal, its strides, h, w (full resolution),
    # vis_scale, info, spot_vp, point_vp, caster_pos, caster_range,
    # strength, spot_taps, point_taps, spot_size, point_size, f32_taps, win,
    # run, uniforms, out, n_planes, esm, pcf_radius, the upsample's taps
    # (rows i0, i1, w0, w1, then columns; null at vis_scale 1), tile_h,
    # halo_h, halo_w, stream
    "lsr_vis_planes": (_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                       _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                       _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _P),
    # world_pos and its strides (y, x, component), normal and its strides,
    # camera, packed records, n_lights, lists (int64), cap, chunk, cluster
    # (int64, null for tiled lists) and its strides (y, x), slices, vis
    # (null without planes) and its strides (y, x, plane), n_planes,
    # shadow index (int64), diffuse, specular, width, height, tile_size,
    # stream
    "lsr_local_lights": (_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _I, _P, _I,
                         _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P,
                         _I, _I, _I, _P),
    # positions, indices, vtx_obj, tri_obj, models, viewprojs, obj_visible,
    # n_objects, slot_enabled (null: all), n_tris, n_slots, size, n_sup,
    # rec, chunk_bb, lists, counts, super_bb, tickets, stream
    "lsr_slot_setup": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P),
    # stream, counts (n_types ints), n_types: the nodes of the graph the
    # stream is capturing into, by cudaGraphNodeType (utils/trace.py)
    "lsr_capture_nodes": (_P, _P, _I),
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of lsr_tpu_torch are built from csrc/ at first use")
    return found


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _build(srcs: list[str], so: str) -> str:
    """Compile every .cu at once (one nvcc each), link them into `so`;
    returns the compilers' output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}"
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [f"{tmp}.{i}.o" for i in range(len(cus))]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cus, objs)]
    logs, failed = [], []
    for src, proc in zip(cus, procs):
        logs.append(f"== {os.path.basename(src)}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode})")
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    res = subprocess.run([nvcc, *LINK_FLAGS, "-o", f"{tmp}.so", *objs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(f"{tmp}.so", so)
    for obj in objs:
        os.remove(obj)
    return log


def load_kernels():
    """The loaded kernel library (ctypes.CDLL), building it if needed (the
    set-up span cuda_build.load, utils.trace)."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"liblsr_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    built = not os.path.exists(so)
    with trace.kept_span("cuda_build.load"):
        log = _build(srcs, so) if built else ""
        lib = ctypes.CDLL(so)
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    build_info.update(path=so, built=built,
                      seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib


def kernel_resources(log: str) -> dict:
    """What `ptxas -v` said in a build log: {source file: [{"fn": mangled
    entry function, "registers", "spill_bytes" (stores + loads),
    "stack_bytes", "smem_bytes" (static)}]}."""
    out: dict = {}
    src, cur = None, None
    for line in log.splitlines():
        if m := re.match(r"== (\S+)", line):
            src = m.group(1)
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = {"fn": m.group(1), "registers": None, "spill_bytes": 0,
                   "stack_bytes": 0, "smem_bytes": 0}
            out.setdefault(src, []).append(cur)
        elif cur is not None:
            if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line):
                cur["stack_bytes"] = int(m.group(1))
                cur["spill_bytes"] = int(m.group(2)) + int(m.group(3))
            if m := re.search(r"Used (\d+) registers", line):
                cur["registers"] = int(m.group(1))
                if s := re.search(r"(\d+) bytes smem", line):
                    cur["smem_bytes"] = int(s.group(1))
    return out


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
