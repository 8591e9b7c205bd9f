"""Mesh writers for the formats the loaders read: OBJ, binary PLY, binary
STL and glTF 2.0 (.gltf with a base64 data URI, or .glb).  Host numpy, the
inverse of io/obj, io/ply, io/stl and io/gltf, so that one mesh written in
every format is read back by each loader (tests, chip_smoke.py).  Every
float reads back as the same float32 value: OBJ text carries 9 significant
digits.  lsr_tpu has no writer; this module is the port's own.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from lsr_tpu_torch.io.obj import MeshData


def write_obj(path: str, mesh: MeshData) -> None:
    """v / vt / vn per vertex, one f per triangle (v/vt/vn the same index).
    io/obj.load_obj numbers the vertices by first use in the faces."""
    with open(path, "w") as f:
        for tag, rows in (("v", mesh.positions), ("vt", mesh.uvs),
                          ("vn", mesh.normals)):
            f.writelines(f"{tag} " + " ".join(f"{v:.9g}" for v in r) + "\n"
                         for r in np.asarray(rows, np.float32).tolist())
        f.writelines(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n" for a, b, c
                     in (np.asarray(mesh.indices, np.int64) + 1).tolist())


def write_ply(path: str, mesh: MeshData) -> None:
    """binary_little_endian: x y z nx ny nz u v floats, faces as a uchar
    count and int indices."""
    v = np.concatenate([mesh.positions, mesh.normals, mesh.uvs], 1)
    faces = np.zeros(mesh.num_triangles, [("n", "u1"), ("i", "<i4", (3,))])
    faces["n"], faces["i"] = 3, mesh.indices
    header = (f"ply\nformat binary_little_endian 1.0\n"
              f"element vertex {mesh.num_vertices}\n"
              + "".join(f"property float {p}\n" for p in
                        ("x", "y", "z", "nx", "ny", "nz", "u", "v"))
              + f"element face {mesh.num_triangles}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(v, "<f4").tobytes())
        f.write(faces.tobytes())


def write_stl(path: str, mesh: MeshData) -> None:
    """Binary STL: an 80-byte header, the count, then per triangle a zero
    facet normal (io/stl drops it), its three corners and a zero attribute."""
    rec = np.zeros(mesh.num_triangles, [("n", "<f4", (3,)),
                                        ("v", "<f4", (3, 3)), ("a", "<u2")])
    rec["v"] = np.asarray(mesh.positions, np.float32)[mesh.indices]
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", mesh.num_triangles))
        f.write(rec.tobytes())


def write_gltf(path: str, mesh: MeshData) -> None:
    """One triangle primitive: POSITION, NORMAL, TEXCOORD_0 float32 and
    uint32 indices in one buffer; .glb puts it in the BIN chunk, .gltf in
    a data URI."""
    blobs = [(np.asarray(mesh.positions, "<f4"), "VEC3", 5126),
             (np.asarray(mesh.normals, "<f4"), "VEC3", 5126),
             (np.asarray(mesh.uvs, "<f4"), "VEC2", 5126),
             (np.asarray(mesh.indices, "<u4").reshape(-1), "SCALAR", 5125)]
    buf, views, accessors = b"", [], []
    for i, (a, typ, comp) in enumerate(blobs):
        views.append({"buffer": 0, "byteOffset": len(buf),
                      "byteLength": a.nbytes})
        accessors.append({"bufferView": i, "componentType": comp,
                          "count": a.shape[0], "type": typ})
        buf += a.tobytes()
    doc = {"asset": {"version": "2.0"}, "bufferViews": views,
           "accessors": accessors,
           "meshes": [{"primitives": [{"attributes": {
               "POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
               "indices": 3}]}]}
    if path.lower().endswith(".glb"):
        doc["buffers"] = [{"byteLength": len(buf)}]
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        buf += b"\0" * (-len(buf) % 4)
        with open(path, "wb") as f:
            f.write(b"glTF" + struct.pack("<II", 2, 28 + len(js) + len(buf)))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(buf), 0x004E4942) + buf)
        return
    doc["buffers"] = [{"byteLength": len(buf),
                       "uri": "data:application/octet-stream;base64,"
                              + base64.b64encode(buf).decode()}]
    with open(path, "w") as f:
        json.dump(doc, f)


WRITERS = {".obj": write_obj, ".ply": write_ply, ".stl": write_stl,
           ".gltf": write_gltf, ".glb": write_gltf}


def write_mesh(path: str, mesh: MeshData) -> None:
    """Write `mesh` in the format named by the path's extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in WRITERS:
        raise ValueError(f"unsupported mesh format: {ext!r} ({path})")
    WRITERS[ext](path, mesh)
