"""glTF 2.0 mesh loader (.gltf / .glb), host-side, dependency-free; copied
from lsr_tpu/io/gltf.py.

Part of the general mesh-loading surface that replaces the reference's
Assimp path (resources/loaders/mesh_loader_assimp.hpp:42
load_meshes_assimp): every mesh primitive becomes one MeshData with
positions / normals / uvs / indices, missing normals are generated
(aiProcess_GenSmoothNormals analog: area-weighted smooth normals), missing
UVs default to 0 — the same fallbacks the reference applies per vertex
(mesh_loader_assimp.hpp:63-86).

Scope: triangle primitives (mode 4, the default), indexed or not, with
accessor component types 5120-5126, normalized integers, byteStride, and
buffers from GLB BIN chunks, base64 data URIs, or sibling files.  Raw mesh
data is returned without node-transform baking, matching
load_meshes_assimp's per-mesh (not per-node-instance) output.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from lsr_tpu_torch.io.obj import MeshData

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_LANES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}
_MODE_TRIANGLES = 4


def _load_buffers(doc: dict, bin_chunk: bytes | None, base_dir: str):
    bufs = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError("glTF buffer without uri needs a GLB BIN "
                                 "chunk")
            bufs.append(bin_chunk)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            bufs.append(base64.b64decode(b64))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _read_accessor(doc: dict, bufs, idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    lanes = _TYPE_LANES[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    count = acc["count"]
    out = np.zeros((count, lanes), dtype)
    if "bufferView" in acc:
        view = doc["bufferViews"][acc["bufferView"]]
        data = bufs[view["buffer"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or dtype.itemsize * lanes
        if stride == dtype.itemsize * lanes:
            flat = np.frombuffer(
                data, dtype, count=count * lanes, offset=start)
            out = flat.reshape(count, lanes).copy()
        else:
            for i in range(count):
                out[i] = np.frombuffer(
                    data, dtype, count=lanes, offset=start + i * stride)
    # Sparse substitution (gltf 2.0 3.6.2.3).
    sp = acc.get("sparse")
    if sp:
        iview = doc["bufferViews"][sp["indices"]["bufferView"]]
        idt = np.dtype(_COMPONENT_DTYPES[sp["indices"]["componentType"]])
        ioff = iview.get("byteOffset", 0) + sp["indices"].get("byteOffset", 0)
        sidx = np.frombuffer(bufs[iview["buffer"]], idt,
                             count=sp["count"], offset=ioff)
        vview = doc["bufferViews"][sp["values"]["bufferView"]]
        voff = vview.get("byteOffset", 0) + sp["values"].get("byteOffset", 0)
        vals = np.frombuffer(bufs[vview["buffer"]], dtype,
                             count=sp["count"] * lanes,
                             offset=voff).reshape(sp["count"], lanes)
        out[sidx.astype(np.int64)] = vals
    if acc.get("normalized") and dtype.kind in "iu":
        scale = float(np.iinfo(dtype).max)
        out = out.astype(np.float32) / scale
        if dtype.kind == "i":
            out = np.maximum(out, -1.0)
    return out


def _smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (aiProcess_GenSmoothNormals analog)."""
    p = positions
    tri = indices
    fn = np.cross(p[tri[:, 1]] - p[tri[:, 0]], p[tri[:, 2]] - p[tri[:, 0]])
    n = np.zeros_like(p)
    for c in range(3):
        np.add.at(n, tri[:, c], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.where(ln > 1e-12, n / np.maximum(ln, 1e-12),
                    np.asarray([0.0, 1.0, 0.0], np.float32))


def _parse_glb(raw: bytes):
    magic, version, _length = struct.unpack_from("<III", raw, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB container")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    off = 12
    doc = None
    bin_chunk = None
    while off + 8 <= len(raw):
        clen, ctype = struct.unpack_from("<II", raw, off)
        body = raw[off + 8:off + 8 + clen]
        if ctype == 0x4E4F534A:          # 'JSON'
            doc = json.loads(body.decode("utf-8"))
        elif ctype == 0x004E4942:        # 'BIN\0'
            bin_chunk = body
        off += 8 + clen
    if doc is None:
        raise ValueError("GLB without a JSON chunk")
    return doc, bin_chunk


def load_gltf_meshes(path: str) -> list[MeshData]:
    """Every triangle primitive in the file, in mesh/primitive order."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == b"glTF":
        doc, bin_chunk = _parse_glb(raw)
    else:
        doc = json.loads(raw.decode("utf-8"))
        bin_chunk = None
    bufs = _load_buffers(doc, bin_chunk, os.path.dirname(path))

    out = []
    for mesh in doc.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if prim.get("mode", _MODE_TRIANGLES) != _MODE_TRIANGLES:
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, bufs, attrs["POSITION"]) \
                .astype(np.float32)
            v = pos.shape[0]
            if "indices" in prim:
                idx = _read_accessor(doc, bufs, prim["indices"]) \
                    .reshape(-1).astype(np.int32)
            else:
                idx = np.arange(v, dtype=np.int32)
            tri = idx.reshape(-1, 3)
            if "NORMAL" in attrs:
                nrm = _read_accessor(doc, bufs, attrs["NORMAL"]) \
                    .astype(np.float32)
            else:
                nrm = _smooth_normals(pos, tri)
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(doc, bufs, attrs["TEXCOORD_0"]) \
                    [:, :2].astype(np.float32)
            else:
                uv = np.zeros((v, 2), np.float32)
            out.append(MeshData(positions=pos, normals=nrm, uvs=uv,
                                indices=tri))
    return out


def load_gltf(path: str) -> MeshData:
    """First triangle primitive (load_mesh_assimp_first analog)."""
    meshes = load_gltf_meshes(path)
    if not meshes:
        raise ValueError(f"no triangle meshes in {path}")
    return meshes[0]
