"""Format-dispatching mesh loader (copied from lsr_tpu/io/mesh_loader.py;
OBJ through the native loader, io/fast_obj): the load_meshes_assimp /
load_mesh_assimp_first surface (resources/loaders/mesh_loader_assimp.hpp:
42, :104) without the Assimp dependency.

Formats: OBJ (incl. the reference's .rawobj dialect), PLY (ascii/binary),
glTF 2.0 (.gltf/.glb), STL (ascii/binary).  Every loader normalizes to the
same indexed MeshData (positions/normals/uvs/indices) with the reference's
per-vertex fallbacks (generated smooth normals, zero UVs).
"""

from __future__ import annotations

import os

from lsr_tpu_torch.io.obj import MeshData


def load_meshes(path: str) -> list[MeshData]:
    """All triangle meshes in the file (load_meshes_assimp analog)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".obj", ".rawobj"):
        from lsr_tpu_torch.io.fast_obj import load_obj_fast

        return [load_obj_fast(path)]
    if ext == ".ply":
        from lsr_tpu_torch.io.ply import load_ply

        return [load_ply(path)]
    if ext in (".gltf", ".glb"):
        from lsr_tpu_torch.io.gltf import load_gltf_meshes

        return load_gltf_meshes(path)
    if ext == ".stl":
        from lsr_tpu_torch.io.stl import load_stl

        return [load_stl(path)]
    raise ValueError(f"unsupported mesh format: {ext!r} ({path})")


def load_mesh(path: str) -> MeshData:
    """First mesh in the file (load_mesh_assimp_first analog)."""
    meshes = load_meshes(path)
    if not meshes:
        raise ValueError(f"no meshes in {path}")
    return meshes[0]
