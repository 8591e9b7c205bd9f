"""ctypes bindings of the native OBJ loader (lsr_tpu_torch/native/
fast_obj.cpp; port of lsr_tpu/io/fast_obj.py).

The native runtime piece of the asset pipeline (the reference loads through
Assimp, also native).  Semantics are those of the Python parser io/obj.
load_obj: corner dedup, fan triangulation, area-weighted normals when
absent; tests hold the two equal.  The library is built with g++ at first
use (utils/native_build); where it cannot be built this raises, where
lsr_tpu falls back to its Python parser.
"""

from __future__ import annotations

import ctypes

import numpy as np

from lsr_tpu_torch.io.obj import MeshData
from lsr_tpu_torch.utils.native_build import ensure_native_built

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(ensure_native_built("libfastobj.so"))
        lib.fastobj_parse_file.restype = ctypes.c_void_p
        lib.fastobj_parse_file.argtypes = [ctypes.c_char_p]
        lib.fastobj_parse_text.restype = ctypes.c_void_p
        lib.fastobj_parse_text.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.fastobj_num_vertices.restype = ctypes.c_long
        lib.fastobj_num_vertices.argtypes = [ctypes.c_void_p]
        lib.fastobj_num_triangles.restype = ctypes.c_long
        lib.fastobj_num_triangles.argtypes = [ctypes.c_void_p]
        lib.fastobj_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.fastobj_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def native_available() -> bool:
    """Builds and loads the native loader now if needed.  Kept for name
    parity with lsr_tpu, where the native loader is optional: here a failed
    build raises, so this returns True or raises."""
    _lib()
    return True


def load_obj_fast(path_or_text: str, from_text: bool = False) -> MeshData:
    """Parse an OBJ file (or literal text with from_text=True) with the
    native loader."""
    lib = _lib()
    if from_text:
        data = path_or_text.encode()
        handle = lib.fastobj_parse_text(data, len(data))
    else:
        handle = lib.fastobj_parse_file(path_or_text.encode())
    if not handle:
        raise IOError(f"fast_obj failed to parse {path_or_text[:80]!r}")
    try:
        nv = lib.fastobj_num_vertices(handle)
        nt = lib.fastobj_num_triangles(handle)
        positions = np.empty((nv, 3), np.float32)
        normals = np.empty((nv, 3), np.float32)
        uvs = np.empty((nv, 2), np.float32)
        indices = np.empty((nt, 3), np.int32)
        lib.fastobj_copy(
            handle,
            positions.ctypes.data_as(ctypes.c_void_p),
            normals.ctypes.data_as(ctypes.c_void_p),
            uvs.ctypes.data_as(ctypes.c_void_p),
            indices.ctypes.data_as(ctypes.c_void_p),
        )
    finally:
        lib.fastobj_free(handle)
    return MeshData(positions, normals, uvs, indices)
