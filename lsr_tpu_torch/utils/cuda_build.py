"""Build and load the hand-written CUDA kernels (lsr_tpu_torch/csrc/*.cu).

The kernels expose a plain C interface and are compiled by nvcc into ONE
shared library at first use, then loaded with ctypes.  The library lands in
<repo>/build/kernels/ (gitignored), named by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one is reused.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# -fmad=false: no contraction of a*b+c into FMA, so B1's coverage and depth
# arithmetic rounds exactly like its plain PyTorch version (separate torch
# ops never contract).  No -use_fast_math for the same reason.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures (argtypes) of every exported launcher; each returns the
# cudaError_t of its launch.
SIGNATURES = {
    # rec, chunk_bb, slists, counts, depth_in, tid_in, depth_out, tid_out,
    # width, height, tiles_x, scap, zn, inv_range, max_py, depth_mode,
    # track_ids, tie_tid, stream
    "lsr_direct_raster": (_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P),
    # gbuf, tile_rec, counts, uniforms, out, width, height, ph, pw,
    # tiles_x, cap, sun_model, apow1, stream
    "lsr_shade_fused": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P),
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


def load_kernels():
    """The loaded kernel library (ctypes.CDLL), building it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"liblsr_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[s for s in srcs if s.endswith(".cu")]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    build_info.update(path=so, seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
