"""Stanford PLY mesh loader (ascii + binary_little_endian), host numpy;
copied from lsr_tpu/io/ply.py.

Mesh formats beyond OBJ (the reference loads arbitrary formats via Assimp,
resources/loaders/mesh_loader_assimp.hpp; this covers the other common
interchange format without the dependency).  Produces the same MeshData SoA
as io/obj.py: positions/normals/uvs indexed triangles, polygon faces
fan-triangulated, normals computed from faces when absent (area-weighted
vertex normals, the aiProcess_GenSmoothNormals analog).
"""

from __future__ import annotations

import struct

import numpy as np

from lsr_tpu_torch.io.obj import MeshData

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def _compute_vertex_normals(positions, indices):
    n = np.zeros_like(positions)
    tri = positions[indices]                     # (F, 3, 3)
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(n, indices[:, k], fn)          # area-weighted
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).astype(np.float32)


def load_ply(path: str) -> MeshData:
    with open(path, "rb") as f:
        data = f.read()

    # --- header ------------------------------------------------------------
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[data.find(b"\n", end) + 1:]

    fmt = None
    elements = []  # [(name, count, [(prop_name, type, list_types|None)])]
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format: {fmt}")

    verts = {}
    faces = []

    if fmt == "ascii":
        tokens = body.decode("ascii", "replace").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0]: [] for p in props}
                for _ in range(count):
                    for pname, _, _ in props:
                        cols[pname].append(float(tokens[pos]))
                        pos += 1
                verts = {k: np.asarray(v, np.float32)
                         for k, v in cols.items()}
            elif name == "face":
                for _ in range(count):
                    k = int(tokens[pos]); pos += 1
                    idx = [int(tokens[pos + j]) for j in range(k)]
                    pos += k
                    for j in range(1, k - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
            else:  # skip unknown element's scalar rows
                width = len(props)
                pos += count * width
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                fmt_str = "<" + "".join(_PLY_TYPES[t][0] for _, t, _ in props)
                width = struct.calcsize(fmt_str)
                arr = np.frombuffer(body, dtype=np.dtype(
                    [(p[0], "<" + _PLY_TYPES[p[1]][0]) for p in props]),
                    count=count, offset=off)
                off += count * width
                verts = {p[0]: arr[p[0]].astype(np.float32) for p in props}
            elif name == "face":
                for _ in range(count):
                    cnt_t = props[0][2]
                    idx_t = props[0][1]
                    cfmt, csz = _PLY_TYPES[cnt_t]
                    ifmt, isz = _PLY_TYPES[idx_t]
                    (k,) = struct.unpack_from("<" + cfmt, body, off)
                    off += csz
                    idx = struct.unpack_from("<" + str(k) + ifmt, body, off)
                    off += k * isz
                    for j in range(1, k - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
            else:
                fmt_str = "<" + "".join(_PLY_TYPES[t][0] for _, t, _ in props)
                off += count * struct.calcsize(fmt_str)

    positions = np.stack([verts["x"], verts["y"], verts["z"]], -1)
    indices = np.asarray(faces, np.int32).reshape(-1, 3)
    if {"nx", "ny", "nz"} <= set(verts):
        normals = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1)
        ln = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = (normals / np.maximum(ln, 1e-12)).astype(np.float32)
    else:
        normals = _compute_vertex_normals(positions, indices)
    if {"u", "v"} <= set(verts):
        uvs = np.stack([verts["u"], verts["v"]], -1)
    elif {"s", "t"} <= set(verts):
        uvs = np.stack([verts["s"], verts["t"]], -1)
    else:
        uvs = np.zeros((positions.shape[0], 2), np.float32)
    return MeshData(positions=positions.astype(np.float32),
                    normals=normals, uvs=uvs.astype(np.float32),
                    indices=indices)
