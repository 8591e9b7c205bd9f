"""Carry scene state from lsr_tpu's dataclasses into this package's.

from_numpy_state reads every field through np.asarray(getattr(x, name)), so
it takes lsr_tpu's registered dataclasses (or anything with the same field
names) without importing jax.  The parity tests use it so both packages
render exactly the same geometry, lights, materials, texture and camera;
frame_params, compact_stats, batch, shadow_context, local_shadow_maps and
ibl carry a FrameParams, a CompactStats, a concat_scene batch, a sun
ShadowContext, a local shadow atlas and the IBL maps the same way; cubemap
and texture_array a loaded cubemap and a ResourceRegistry's texture
stack (or any texture array).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from lsr_tpu_torch.core.frame import FrameParams
from lsr_tpu_torch.lighting.light_types import COLUMNS, LightsSoA, lights_from_numpy
from lsr_tpu_torch.lighting.local_shadows import LocalShadowMaps
from lsr_tpu_torch.lighting.shadow_sample import ShadowContext
from lsr_tpu_torch.raster.setup import CompactStats
from lsr_tpu_torch.scene.scene import (
    CameraState,
    GeometryBatch,
    ObjectsSoA,
    geometry_from_numpy,
)
from lsr_tpu_torch.shading.common import MaterialsSoA
from lsr_tpu_torch.shading.models import ShadeContext, make_shade_context

_GEOM = ("positions", "normals", "uvs", "indices", "vtx_obj", "tri_obj")
_OBJECTS = ("model", "prev_model", "normal_mat", "local_min", "local_max",
            "casts_shadow", "visible", "material")
_LOCAL_TAP_STRIDE = 6   # lsr_tpu's anchor stride of the local PCF windows
_MATERIALS = ("base_color", "metallic", "roughness", "ao", "emissive",
              "tex_id", "normal_tex", "orm_tex", "emissive_tex")


def _np(x, name):
    return np.asarray(getattr(x, name))


def _tensor(a: np.ndarray, device):
    if a.dtype == np.bool_:
        return torch.as_tensor(np.array(a), device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def geometry(geom, device) -> GeometryBatch:
    return geometry_from_numpy({k: _np(geom, k) for k in _GEOM}, device)


def objects_soa(objects, device) -> ObjectsSoA:
    return ObjectsSoA(**{k: _tensor(_np(objects, k), device) for k in _OBJECTS})


def lights_soa(lights, device) -> LightsSoA:
    return lights_from_numpy({k: _np(lights, k) for k in COLUMNS}, device)


def materials_soa(materials, device) -> MaterialsSoA:
    return MaterialsSoA(
        **{k: _tensor(_np(materials, k), device) for k in _MATERIALS})


def _q16_planes(taps, n: int, s: int, filter_mode: str, stride: int,
                radius: int) -> np.ndarray:
    """n (S, S) int32 q16 planes from lsr_tpu's u16 tap table of n maps:
    ESM's soft maps from their u32 texel pairs (low half = even texel),
    unit-step PCF's depth from its per-anchor u16 tap windows (anchor
    (ay, ax) lane (li, lj) holds texel (ay * stride - r + li, ax * stride -
    r + lj), clamped)."""
    taps = np.asarray(taps)
    if taps.dtype != np.uint32:
        raise NotImplementedError("only lsr_tpu's u16 tap tables (TAPS_U16) "
                                  "are carried")
    lo, hi = taps & 0xFFFF, taps >> 16
    pairs = np.stack([lo, hi], axis=-1).reshape(taps.shape[:-1] + (-1,))
    if filter_mode == "esm":
        return pairs.reshape(n, s, s).astype(np.int32)
    win = stride + 2 * radius
    n_anchor = -(-s // stride)
    win_tab = pairs.reshape(n, n_anchor * n_anchor, win, win)
    y, x = np.mgrid[0:s, 0:s]
    return win_tab[:, (y // stride) * n_anchor + x // stride,
                   y % stride + radius, x % stride + radius].astype(np.int32)


def shadow_context(sc, device) -> ShadowContext:
    """lsr_tpu's ShadowContext as this package's.  Its tap table becomes the
    (S, S) int32 q16 plane (_q16_planes)."""
    depth = np.array(sc.depth, np.float32)
    s = depth.shape[0]
    taps = None
    if sc.depth_taps is not None:
        taps = torch.as_tensor(_q16_planes(
            sc.depth_taps, 1, s, sc.filter_mode, int(sc.tap_stride),
            int(sc.pcf_radius))[0], device=device)
    f = lambda k: float(np.float32(_np(sc, k)))  # noqa: E731
    return ShadowContext(
        depth=torch.as_tensor(depth, device=device),
        light_viewproj=torch.as_tensor(
            np.array(sc.light_viewproj, np.float32), device=device),
        bias_const=f("bias_const"), bias_slope=f("bias_slope"),
        strength=f("strength"), pcf_radius=int(sc.pcf_radius),
        pcf_step=int(sc.pcf_step), taps_q16=taps, filter_mode=sc.filter_mode, esm_c=float(sc.esm_c))


def local_shadow_maps(sh, device) -> LocalShadowMaps:
    """lsr_tpu's LocalShadowMaps as this package's: each stack's tap table
    as (n, S, S) int32 q16 planes (_q16_planes; lsr_tpu's PCF anchor stride
    is 6), the other fields by name."""
    def stack(taps, vp, size):
        if taps is None:
            return None
        return torch.as_tensor(_q16_planes(
            taps, np.asarray(vp).shape[0], size, sh.filter_mode,
            _LOCAL_TAP_STRIDE, int(sh.pcf_radius)), device=device)

    t = lambda k: _tensor(_np(sh, k), device)  # noqa: E731
    en = getattr(sh, "caster_enabled", None)
    return LocalShadowMaps(
        spot_taps=stack(sh.spot_taps, sh.spot_viewproj, int(sh.spot_size)),
        point_taps=stack(sh.point_taps, sh.point_viewproj,
                         int(sh.point_size)),
        spot_viewproj=t("spot_viewproj"), point_viewproj=t("point_viewproj"),
        caster_pos=t("caster_pos"), caster_range=t("caster_range"),
        light_shadow_index=t("light_shadow_index"), strength=t("strength"),
        bias_const=float(np.float32(_np(sh, "bias_const"))),
        bias_slope=float(np.float32(_np(sh, "bias_slope"))),
        caster_enabled=None if en is None else _tensor(np.asarray(en),
                                                       device),
        spot_size=int(sh.spot_size), point_size=int(sh.point_size),
        pcf_radius=int(sh.pcf_radius), kinds=tuple(sh.kinds),
        base_slots=tuple(sh.base_slots), vis_scale=int(sh.vis_scale),
        filter_mode=sh.filter_mode, esm_c=float(sh.esm_c))


def shade_context(ctx, materials: MaterialsSoA, device) -> ShadeContext:
    """lsr_tpu's ShadeContext (with its sun ShadowContext and its IBL maps,
    if any) as this package's."""
    tex = getattr(ctx, "textures", None)
    shadow = getattr(ctx, "shadow", None)
    sc = make_shade_context(
        materials,
        light_dir_ws=_np(ctx, "light_dir_ws"),
        light_color=_np(ctx, "light_color"),
        light_intensity=_np(ctx, "light_intensity"),
        camera_pos=_np(ctx, "camera_pos"),
        textures=None if tex is None else _tensor(np.asarray(tex), device),
        ibl=ibl(ctx.ibl, device) if getattr(ctx, "ibl", None) is not None
        else None,
        device=device,
    )
    if shadow is None:
        return sc
    return dataclasses.replace(sc, shadow=shadow_context(shadow, device))


def ibl(maps, device) -> tuple:
    """lsr_tpu's IBL maps, (irradiance faces, (prefiltered mips...)), as
    tensors on `device` in the same structure."""
    irr, pref = maps
    return (_tensor(np.asarray(irr), device),
            tuple(_tensor(np.asarray(m), device) for m in pref))


def cubemap(faces, device) -> torch.Tensor:
    """A (6, S, S, 3) cubemap (lsr_tpu's load_cubemap result or a baked
    sky) as an f32 tensor on `device`."""
    return _tensor(np.asarray(faces), device)


def texture_array(textures, device):
    """A texture stack (NT, S, S, 3) as an f32 tensor on `device`:
    lsr_tpu's ResourceRegistry (its texture_array(); None when it holds no
    texture) or the array itself."""
    if hasattr(textures, "texture_array"):
        textures = textures.texture_array()
    return None if textures is None else _tensor(np.asarray(textures),
                                                 device)


def camera_state(camera, device) -> CameraState:
    t = lambda k: _tensor(_np(camera, k), device)  # noqa: E731
    return CameraState(
        view=t("view"), proj=t("proj"), viewproj=t("viewproj"),
        prev_viewproj=t("prev_viewproj"), eye=t("eye"),
        zn=float(np.float32(_np(camera, "zn"))),
        zf=float(np.float32(_np(camera, "zf"))),
    )


def batch(b: dict, device) -> dict:
    """A concat_scene batch (dict of arrays) as tensors on `device`, with
    the integer columns as int64 (render_forward's input)."""
    return {k: _tensor(np.asarray(v), device) for k, v in b.items()}


def compact_stats(stats) -> CompactStats:
    """lsr_tpu's CompactStats as this package's (CPU tensors)."""
    t = lambda k: torch.as_tensor(np.array(_np(stats, k)))  # noqa: E731
    return CompactStats(n_direct=t("n_direct").to(torch.int64),
                        n_clip=t("n_clip").to(torch.int64),
                        overflow=t("overflow"),
                        cap_direct=int(stats.cap_direct),
                        cap_clip=int(stats.cap_clip))


def _dataclass_like(cls, src):
    """An instance of dataclass `cls` with every field read from `src` by
    name: nested dataclasses recurse, enums convert by value."""
    default = cls()
    kw = {}
    for f in dataclasses.fields(cls):
        v, d = getattr(src, f.name), getattr(default, f.name)
        if dataclasses.is_dataclass(d):
            v = _dataclass_like(type(d), v)
        elif isinstance(d, enum.Enum):
            v = type(d)(v.value)
        kw[f.name] = v
    return cls(**kw)


def frame_params(fp) -> FrameParams:
    """lsr_tpu's FrameParams as this package's, every field and parameter
    block read by name."""
    return _dataclass_like(FrameParams, fp)


def from_numpy_state(geom, objects, lights, materials, ctx, camera, device):
    """lsr_tpu scene state -> this package's dataclasses on `device`.

    Returns (geom, objects, lights, materials, ctx, camera); ctx holds the
    converted materials."""
    mats = materials_soa(materials, device)
    return (geometry(geom, device), objects_soa(objects, device),
            lights_soa(lights, device), mats, shade_context(ctx, mats, device),
            camera_state(camera, device))
