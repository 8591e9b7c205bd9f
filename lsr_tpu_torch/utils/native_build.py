"""Build the port's native helpers (lsr_tpu_torch/native/*.cpp) at first use
(port of lsr_tpu/utils/native_build.py).

g++ compiles each source into one shared library in <repo>/build/native/
(gitignored), named by a hash of the compiler, its flags and the source, so
an edited source rebuilds and an unchanged one is reused; native/ itself is
never written.  The build writes a file of its own and renames it into
place, so processes that build at once (test workers) never load a
half-written library.

There is no fallback: a missing compiler or a failed build raises, as
cuda_build does for the CUDA kernels.  (lsr_tpu returns None there and its
callers take their Python paths.)
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

# Library name (lsr_tpu's) -> its source under native/.
SOURCES = {"libfastobj.so": "fast_obj.cpp",
           "libpngfilters.so": "png_filters.cpp"}


def ensure_native_built(so_name: str) -> str:
    """The absolute path of the built library `so_name` (a key of SOURCES),
    building it if needed; raises when it cannot be built."""
    src = os.path.join(NATIVE_DIR, SOURCES[so_name])
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the native helpers of "
                           f"lsr_tpu_torch are built from {NATIVE_DIR} at "
                           f"first use")
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(so_name)[0]
    path = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"{CXX} failed to build {so_name} "
                           f"({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)
    return path
