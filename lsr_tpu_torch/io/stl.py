"""STL mesh loader (binary + ASCII), host-side; copied from
lsr_tpu/io/stl.py.

Part of the general mesh-loading surface replacing the reference's Assimp
path (resources/loaders/mesh_loader_assimp.hpp).  STL carries no UVs or
shared vertices; identical corners are welded (aiProcess_
JoinIdenticalVertices analog) and smooth normals generated from the welded
topology (GenSmoothNormals), so a lit STL mesh shades like the reference's
Assimp import of the same file.
"""

from __future__ import annotations

import struct

import numpy as np

from lsr_tpu_torch.io.obj import MeshData
from lsr_tpu_torch.io.gltf import _smooth_normals


def _weld(tris: np.ndarray) -> MeshData:
    """tris: (F, 3, 3) corner positions -> indexed MeshData with smooth
    normals and zero UVs."""
    flat = tris.reshape(-1, 3).astype(np.float32)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    idx = inv.reshape(-1, 3).astype(np.int32)
    nrm = _smooth_normals(uniq, idx)
    return MeshData(positions=uniq, normals=nrm.astype(np.float32),
                    uvs=np.zeros((uniq.shape[0], 2), np.float32),
                    indices=idx)


def load_stl(path: str) -> MeshData:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:5].lower() == b"solid" and b"facet" in raw[:512]:
        return _load_ascii(raw.decode("ascii", errors="replace"))
    n_tri = struct.unpack_from("<I", raw, 80)[0]
    rec = np.frombuffer(raw, np.uint8, count=n_tri * 50, offset=84)
    rec = rec.reshape(n_tri, 50)
    f32 = rec[:, :48].copy().view(np.float32).reshape(n_tri, 4, 3)
    return _weld(f32[:, 1:4])            # drop the stored facet normal


def _load_ascii(text: str) -> MeshData:
    verts = []
    for line in text.splitlines():
        t = line.split()
        if len(t) == 4 and t[0] == "vertex":
            verts.append([float(t[1]), float(t[2]), float(t[3])])
    arr = np.asarray(verts, np.float32)
    if arr.size == 0 or arr.shape[0] % 3:
        raise ValueError("malformed ASCII STL")
    return _weld(arr.reshape(-1, 3, 3))
