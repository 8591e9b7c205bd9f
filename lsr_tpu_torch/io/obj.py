"""Host-side mesh primitives (numpy), copied from lsr_tpu/io/obj.py:1-182.

Meshes stay numpy until SceneBuilder.build uploads the concatenated batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Host-side indexed triangle mesh (SoA)."""

    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (F, 3) i32

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (LH winding: CCW front faces)."""
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, indices[:, k], fn)
    lens = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(lens, 1e-12)).astype(np.float32)


def make_plane(size: float = 1.0, y: float = 0.0) -> MeshData:
    """XZ ground plane of extent [-size, size], +Y normal, 2 triangles."""
    s = float(size)
    pos = np.array(
        [[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]], np.float32
    )
    nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    # Front-facing (screen-space CCW) when viewed from above through the LH
    # camera convention.
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return MeshData(pos, nrm, uv, idx)


def make_uv_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32) -> MeshData:
    """UV sphere: 2 * rings * sectors triangles."""
    ring = np.linspace(0.0, np.pi, rings + 1)
    sect = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    rr, ss = np.meshgrid(ring, sect, indexing="ij")
    x = np.sin(rr) * np.cos(ss)
    y = np.cos(rr)
    z = np.sin(rr) * np.sin(ss)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    nrm = pos.copy()
    uv = np.stack([ss / (2 * np.pi), 1.0 - rr / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    stride = sectors + 1
    for r in range(rings):
        for s_i in range(sectors):
            a = r * stride + s_i
            b = a + stride
            idx.append((a, b, a + 1))
            idx.append((a + 1, b, b + 1))
    return MeshData(pos * radius, nrm, uv, np.asarray(idx, np.int32))
