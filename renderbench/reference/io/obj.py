"""Host-side mesh primitives and the OBJ text parser (numpy), copied from
lsr_tpu/io/obj.py:1-182.

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


def _parse_index(token: str, count: int) -> int:
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_obj(path_or_text: str, from_text: bool = False) -> MeshData:
    """Parse an OBJ file (or literal text with from_text=True) into MeshData.
    Faces of more than three corners are fan-triangulated; corners with
    distinct (v, vt, vn) triplets become distinct vertices; a mesh without
    normals gets compute_vertex_normals."""
    if from_text:
        text = path_or_text
    else:
        with open(path_or_text, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()

    vs: list[tuple] = []
    vts: list[tuple] = []
    vns: list[tuple] = []
    corner_map: dict[tuple, int] = {}
    positions: list[tuple] = []
    normals: list[tuple] = []
    uvs: list[tuple] = []
    tris: list[tuple] = []
    any_normals = False

    def corner_id(tok: str) -> int:
        parts = tok.split("/")
        vi = _parse_index(parts[0], len(vs))
        ti = _parse_index(parts[1], len(vts)) if len(parts) > 1 and parts[1] else -1
        ni = _parse_index(parts[2], len(vns)) if len(parts) > 2 and parts[2] else -1
        key = (vi, ti, ni)
        idx = corner_map.get(key)
        if idx is None:
            idx = len(positions)
            corner_map[key] = idx
            positions.append(vs[vi])
            uvs.append(vts[ti][:2] if ti >= 0 else (0.0, 0.0))
            normals.append(vns[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        return idx

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            vs.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "vt":
            vals = [float(x) for x in parts[1:3]]
            while len(vals) < 2:
                vals.append(0.0)
            vts.append(tuple(vals))
        elif tag == "vn":
            vns.append(tuple(float(x) for x in parts[1:4]))
            any_normals = True
        elif tag == "f":
            ids = [corner_id(tok) for tok in parts[1:]]
            for k in range(1, len(ids) - 1):
                tris.append((ids[0], ids[k], ids[k + 1]))

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    uv = np.asarray(uvs, np.float32).reshape(-1, 2)
    nrm = np.asarray(normals, np.float32).reshape(-1, 3)
    idx = np.asarray(tris, np.int32).reshape(-1, 3)

    if not any_normals or not np.any(np.abs(nrm).sum(axis=-1) > 0):
        nrm = compute_vertex_normals(pos, idx)

    return MeshData(positions=pos, normals=nrm, uvs=uv, indices=idx)


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


def make_cube(size: float = 1.0) -> MeshData:
    """Axis-aligned cube with per-face normals / uvs, 12 triangles."""
    s = float(size) * 0.5
    faces = [
        # (normal, corner order): CCW viewed from outside (LH convention)
        ((0, 0, -1), [(-s, -s, -s), (-s, s, -s), (s, s, -s), (s, -s, -s)]),
        ((0, 0, 1), [(s, -s, s), (s, s, s), (-s, s, s), (-s, -s, s)]),
        ((-1, 0, 0), [(-s, -s, s), (-s, s, s), (-s, s, -s), (-s, -s, -s)]),
        ((1, 0, 0), [(s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s)]),
        ((0, -1, 0), [(-s, -s, s), (-s, -s, -s), (s, -s, -s), (s, -s, s)]),
        ((0, 1, 0), [(-s, s, -s), (-s, s, s), (s, s, s), (s, s, -s)]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    uvq = [(0, 0), (0, 1), (1, 1), (1, 0)]
    for n, corners in faces:
        base = len(pos)
        for c, t in zip(corners, uvq):
            pos.append(c)
            nrm.append(n)
            uv.append(t)
        idx.append((base, base + 1, base + 2))
        idx.append((base, base + 2, base + 3))
    return MeshData(np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
                    np.asarray(uv, np.float32), np.asarray(idx, np.int32))


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
