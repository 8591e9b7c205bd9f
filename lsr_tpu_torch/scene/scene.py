"""Retained scene: objects SoA + camera, as frozen dataclasses of tensors.

Port of lsr_tpu/scene/scene.py (GeometryBatch, ObjectsSoA, CameraState,
SunLight, make_camera, update_prev, SceneBuilder, object_world_aabbs,
cull_scene, shadow_caster_aabb) plus the
concat_scene / morton_order helpers of lsr_tpu/render.py that
SceneBuilder.build uses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.geometry.volumes import (
    frustum_cull_objects,
    merge_aabbs,
    transform_aabb,
)


@dataclasses.dataclass(frozen=True)
class GeometryBatch:
    positions: torch.Tensor  # (V, 3) f32
    normals: torch.Tensor    # (V, 3) f32
    uvs: torch.Tensor        # (V, 2) f32
    indices: torch.Tensor    # (T, 3) i64
    vtx_obj: torch.Tensor    # (V,) i64
    tri_obj: torch.Tensor    # (T,) i64


@dataclasses.dataclass(frozen=True)
class ObjectsSoA:
    """Per-object render items."""

    model: torch.Tensor        # (O, 4, 4)
    prev_model: torch.Tensor   # (O, 4, 4)
    normal_mat: torch.Tensor   # (O, 3, 3)
    local_min: torch.Tensor    # (O, 3)
    local_max: torch.Tensor    # (O, 3)
    casts_shadow: torch.Tensor # (O,) bool
    visible: torch.Tensor      # (O,) bool
    material: torch.Tensor     # (O,) i64


@dataclasses.dataclass(frozen=True)
class CameraState:
    """Camera matrices on the device; zn / zf are host floats (f32 values),
    so kernels and plain versions read the same constants without a sync."""

    view: torch.Tensor
    proj: torch.Tensor
    viewproj: torch.Tensor
    prev_viewproj: torch.Tensor
    eye: torch.Tensor
    zn: float
    zf: float


@dataclasses.dataclass(frozen=True)
class SunLight:
    dir_ws: torch.Tensor     # (3,) from the light toward the scene
    color: torch.Tensor      # (3,)
    intensity: torch.Tensor  # ()


def make_camera(width, height, eye, target, fov=np.pi / 3, zn=0.1, zf=100.0,
                up=(0, 1, 0), prev_viewproj=None, device=None) -> CameraState:
    device = resolve_device(device)
    view = m3.look_at_lh(eye, target, up, device=device)
    proj = m3.perspective_lh_no(fov, width / height, zn, zf, device=device)
    vp = m3.matmul4(proj, view)
    return CameraState(
        view=view, proj=proj, viewproj=vp,
        prev_viewproj=vp if prev_viewproj is None else prev_viewproj,
        eye=torch.as_tensor(eye, dtype=torch.float32, device=device),
        zn=float(np.float32(zn)), zf=float(np.float32(zf)),
    )


def update_prev(camera: CameraState, prev: CameraState) -> CameraState:
    """camera with prev's view-projection as its previous one."""
    return dataclasses.replace(camera, prev_viewproj=prev.viewproj)


def morton_order(mesh) -> np.ndarray:
    """Triangle permutation sorting by Morton code of the centroid
    (lsr_tpu/render.py:morton_order): spatially coherent raster chunks."""
    cent = mesh.positions[mesh.indices].mean(axis=1)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = ((cent - lo) / span * 1023.0).astype(np.uint64)

    def spread(v):
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable").astype(np.int64)


def concat_scene(meshes, object_of_mesh=None, spatial_sort=True):
    """Concatenate host meshes into one SoA batch with per-vertex object ids.

    object_of_mesh: optional object index per mesh (defaults to 0..len-1);
    spatial_sort reorders each mesh's triangles into Morton order.  Returns
    a dict of numpy arrays."""
    if object_of_mesh is None:
        object_of_mesh = list(range(len(meshes)))
    pos, nrm, uv, idx, vobj, tobj = [], [], [], [], [], []
    base = 0
    for mesh, obj in zip(meshes, object_of_mesh):
        pos.append(mesh.positions)
        nrm.append(mesh.normals)
        uv.append(mesh.uvs)
        tris = mesh.indices[morton_order(mesh)] if spatial_sort \
            else mesh.indices
        idx.append(tris + base)
        vobj.append(np.full(mesh.num_vertices, obj, np.int32))
        tobj.append(np.full(mesh.num_triangles, obj, np.int32))
        base += mesh.num_vertices
    return dict(
        positions=np.concatenate(pos).astype(np.float32),
        normals=np.concatenate(nrm).astype(np.float32),
        uvs=np.concatenate(uv).astype(np.float32),
        indices=np.concatenate(idx).astype(np.int32),
        vtx_obj=np.concatenate(vobj),
        tri_obj=np.concatenate(tobj),
    )


def geometry_from_numpy(batch: dict, device) -> GeometryBatch:
    """GeometryBatch on `device` from numpy columns (indices become int64)."""
    f32 = lambda k: torch.as_tensor(  # noqa: E731
        np.array(batch[k], np.float32), device=device)
    i64 = lambda k: torch.as_tensor(  # noqa: E731
        np.array(batch[k], np.int64), device=device)
    return GeometryBatch(
        positions=f32("positions"), normals=f32("normals"), uvs=f32("uvs"),
        indices=i64("indices"), vtx_obj=i64("vtx_obj"), tri_obj=i64("tri_obj"))


def object_world_aabbs(objects: ObjectsSoA):
    """Per-object world AABBs (mins (O, 3), maxs (O, 3))."""
    return transform_aabb(objects.model, objects.local_min, objects.local_max)


def cull_scene(objects: ObjectsSoA, viewproj):
    """Frustum visibility mask per object, ANDed with objects.visible
    (culling_runtime.hpp:111)."""
    wmin, wmax = object_world_aabbs(objects)
    return frustum_cull_objects(viewproj, wmin, wmax) & objects.visible


def shadow_caster_aabb(objects: ObjectsSoA):
    """Merged world AABB of the visible shadow casters
    (pass_shadow_map.hpp:70-131); the unit box [-1, 1]^3 when there is
    none.  No host sync."""
    wmin, wmax = object_world_aabbs(objects)
    mask = objects.casts_shadow & objects.visible
    smin, smax = merge_aabbs(wmin, wmax, mask)
    any_caster = mask.any()
    one = torch.ones(3, dtype=torch.float32, device=smin.device)
    return (torch.where(any_caster, smin, -one),
            torch.where(any_caster, smax, one))


class SceneBuilder:
    """Host-side scene assembly -> device dataclasses."""

    def __init__(self):
        self._meshes = []
        self._models = []
        self._prev_models = []
        self._materials = []
        self._casts_shadow = []
        self._visible = []

    def add(self, mesh, model=None, material: int = 0, casts_shadow=True,
            visible=True, prev_model=None):
        model = np.eye(4, dtype=np.float32) if model is None \
            else np.asarray(model, np.float32)
        self._meshes.append(mesh)
        self._models.append(model)
        self._prev_models.append(
            model if prev_model is None else np.asarray(prev_model, np.float32))
        self._materials.append(material)
        self._casts_shadow.append(bool(casts_shadow))
        self._visible.append(bool(visible))
        return len(self._meshes) - 1

    def build(self, device=None):
        device = resolve_device(device)
        geom = geometry_from_numpy(concat_scene(self._meshes), device)
        models = torch.as_tensor(np.stack(self._models), device=device)
        nmats = torch.stack([m3.normal_matrix(m) for m in models])
        t = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(x), dtype=dt, device=device)
        objects = ObjectsSoA(
            model=models,
            prev_model=t(np.stack(self._prev_models)),
            normal_mat=nmats,
            local_min=t(np.stack([m.positions.min(axis=0) for m in self._meshes])),
            local_max=t(np.stack([m.positions.max(axis=0) for m in self._meshes])),
            casts_shadow=t(self._casts_shadow, torch.bool),
            visible=t(self._visible, torch.bool),
            material=t(self._materials, torch.int64),
        )
        return geom, objects
