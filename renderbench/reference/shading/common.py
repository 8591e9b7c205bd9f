"""Shading common: materials SoA, texture sampling, surface maps (normal,
ORM, emissive), fake IBL (port of lsr_tpu/shading/common.py).

lsr_tpu packs per-row records to make TPU gathers cheap (core/gather.py);
here the same packed layouts are kept so the two packages compare field by
field, and the gathers are plain tensor indexing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from renderbench.reference.core.util import device_const, resolve_device


@dataclasses.dataclass(frozen=True)
class MaterialsSoA:
    """Per-object material table; texture slots index ShadeContext.textures
    (-1 = unused)."""

    base_color: torch.Tensor    # (O, 3) linear
    metallic: torch.Tensor      # (O,)
    roughness: torch.Tensor     # (O,)
    ao: torch.Tensor            # (O,)
    emissive: torch.Tensor      # (O, 3)
    tex_id: torch.Tensor        # (O,) i64 base-color texture; -1 = none
    normal_tex: torch.Tensor    # (O,) i64
    orm_tex: torch.Tensor       # (O,) i64
    emissive_tex: torch.Tensor  # (O,) i64


def make_materials(base_color=((1.0, 1.0, 1.0),), metallic=(0.0,),
                   roughness=(0.6,), ao=(1.0,), emissive=None, tex_id=None,
                   normal_tex=None, orm_tex=None, emissive_tex=None,
                   device=None) -> MaterialsSoA:
    device = resolve_device(device)
    base = torch.as_tensor(np.asarray(base_color, np.float32), device=device)
    o = base.shape[0]

    def bcast(x, dt=torch.float32):
        return torch.broadcast_to(
            torch.as_tensor(x, dtype=dt, device=device), (o,)).contiguous()

    def tex_col(x):
        return bcast(-1 if x is None else x, torch.int64)

    em = np.zeros((o, 3), np.float32) if emissive is None \
        else np.broadcast_to(np.asarray(emissive, np.float32), (o, 3))
    return MaterialsSoA(
        base_color=base,
        metallic=bcast(metallic),
        roughness=bcast(roughness),
        ao=bcast(ao),
        emissive=torch.as_tensor(np.ascontiguousarray(em), device=device),
        tex_id=tex_col(tex_id),
        normal_tex=tex_col(normal_tex),
        orm_tex=tex_col(orm_tex),
        emissive_tex=tex_col(emissive_tex),
    )


def _norm(v, eps=1e-12):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=eps)


def pack_material_records(m: MaterialsSoA):
    """(O, 16) record: [0:3] base_color | [3] metallic | [4] roughness |
    [5] ao | [6:9] emissive | [9] tex_id | [10] normal_tex | [11] orm_tex |
    [12] emissive_tex | [13:16] pad."""
    o = m.base_color.shape[0]
    f = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    return torch.cat([
        m.base_color, f(m.metallic), f(m.roughness), f(m.ao), m.emissive,
        f(m.tex_id), f(m.normal_tex), f(m.orm_tex), f(m.emissive_tex),
        torch.zeros((o, 3), dtype=torch.float32, device=m.base_color.device),
    ], dim=-1)


def gather_materials(m: MaterialsSoA, obj_id, mat_rec=None):
    """Per-pixel material fields from the packed record (or a per-pixel
    record plane such as GBuffer.mat).

    Rows are looked up by object id clamped into the table, as lsr_tpu's
    XLA gather clamps it.

    Returns (base_color, metallic, roughness, ao, emissive, tex_id)."""
    if mat_rec is None:
        table = pack_material_records(m)
        mat_rec = table[torch.clamp(obj_id, 0, table.shape[0] - 1)]
    rec = mat_rec
    return (rec[..., 0:3], rec[..., 3:4], rec[..., 4:5], rec[..., 5:6],
            rec[..., 6:9], rec[..., 9].to(torch.int64))


def gather_material_texture_slots(m: MaterialsSoA, obj_id, mat_rec=None):
    """(normal_tex, orm_tex, emissive_tex) per pixel, from the packed
    record's lanes 10-12."""
    if mat_rec is None:
        table = pack_material_records(m)
        mat_rec = table[torch.clamp(obj_id, 0, table.shape[0] - 1)]
    return tuple(mat_rec[..., k].to(torch.int64) for k in (10, 11, 12))


def apply_surface_maps(textures, quads, uv, tangent, n, normal_tex, orm_tex,
                       emissive_tex, metallic, roughness, ao, emissive):
    """The normal, ORM and emissive texture slots per pixel.

    The tangent is made orthogonal to n, the bitangent completes the frame,
    and the tangent-space normal sample (x, y, z in [0, 1] -> [-1, 1])
    rotates into world space where the slot is used.  ORM (R occlusion, G
    roughness, B metallic) and emissive samples multiply their factors; an
    unused slot samples 1.0.  Returns (n', metallic', roughness', ao',
    emissive')."""
    t = _norm(tangent - n * (n * tangent).sum(-1, keepdim=True))
    b = torch.linalg.cross(n, t)
    ts = sample_texture_bilinear(textures, normal_tex, uv, quads) * 2.0 - 1.0
    n_mapped = _norm(t * ts[..., 0:1] + b * ts[..., 1:2] + n * ts[..., 2:3])
    n_out = torch.where((normal_tex >= 0)[..., None], n_mapped, n)
    orm = sample_texture_bilinear(textures, orm_tex, uv, quads)
    em = sample_texture_bilinear(textures, emissive_tex, uv, quads)
    return (n_out, metallic * orm[..., 2:3], roughness * orm[..., 1:2],
            ao * orm[..., 0:1], emissive * em)


def pack_texture_quads(textures):
    """(NT, TH, TW, 3) -> (NT*TH*TW, 12): each texel row holds its 2x2
    clamped neighborhood [c00 c10 c01 c11]."""
    nt, th, tw, _ = textures.shape
    right = torch.cat([textures[:, :, 1:], textures[:, :, -1:]], dim=2)
    down = torch.cat([textures[:, 1:], textures[:, -1:]], dim=1)
    down_right = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    quads = torch.cat([textures, right, down, down_right], dim=-1)
    return quads.reshape(nt * th * tw, 12)


def sample_texture_bilinear(textures, tex_id, uv, quads=None):
    """Bilinear, repeat-wrapped sampling over a texture array.

    textures: (NT, TH, TW, 3) f32 linear; tex_id: (H, W) int (-1 = white);
    uv: (H, W, 2); quads: optional pack_texture_quads(textures).
    Returns (H, W, 3)."""
    nt, th, tw, _ = textures.shape
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    fx = u * (tw - 1)
    fy = v * (th - 1)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    tid = torch.clamp(tex_id, min=0)
    if quads is None:
        quads = pack_texture_quads(textures)
    # Rows are clamped into the table, as XLA's gather clamps them: pixels
    # outside coverage extrapolate triangle 0's uvs, which can be non-finite.
    flat = torch.clamp((tid * th + y0) * tw + x0, 0, quads.shape[0] - 1)
    q = quads[flat]
    c00, c10, c01, c11 = q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    cx0 = c00 + (c10 - c00) * tx
    cx1 = c01 + (c11 - c01) * tx
    out = cx0 + (cx1 - cx0) * ty
    return torch.where((tex_id >= 0)[..., None], out, torch.ones_like(out))


def eval_fake_ibl(n, v, base_color, metallic, roughness, ao):
    """Ambient approximation without LUT/PMREM (builtin_shaders.hpp:57-89)."""
    n = _norm(n)
    v = _norm(v)
    ndv = (n * v).sum(-1, keepdim=True)
    r = 2.0 * ndv * n - v
    sky_zenith = device_const([0.32, 0.46, 0.72], n.device)
    sky_horizon = device_const([0.62, 0.66, 0.72], n.device)
    ground = device_const([0.16, 0.15, 0.14], n.device)

    up_n = torch.clamp(n[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
    up_r = torch.clamp(r[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
    env_n = ground + ((sky_horizon + (sky_zenith - sky_horizon) * up_n) - ground) * up_n
    env_r = ground + ((sky_horizon + (sky_zenith - sky_horizon) * up_r) - ground) * up_r

    m = torch.clamp(metallic, 0.0, 1.0)
    rgh = torch.clamp(roughness, 0.0, 1.0)
    f0 = 0.04 + (torch.clamp(base_color, min=0.0) - 0.04) * m
    fres = torch.pow(1.0 - torch.clamp(ndv, min=0.0), 5.0)
    f = f0 + (1.0 - f0) * fres

    kd = (1.0 - f) * (1.0 - m)
    diffuse = kd * base_color * env_n * 0.12
    spec_strength = 0.02 + (1.0 - rgh) * 0.18
    spec = env_r * f * spec_strength
    return (diffuse + spec) * torch.clamp(ao, 0.0, 1.0)


def checkerboard_texture(size: int = 64, squares: int = 8,
                         c0=(0.8, 0.8, 0.8), c1=(0.2, 0.25, 0.35)) -> np.ndarray:
    """Host-side procedural test texture (linear color)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((xx * squares // size) + (yy * squares // size)) % 2
    tex = np.where(cell[..., None] == 0, np.float32(c0), np.float32(c1))
    return tex.astype(np.float32)


def bump_normal_texture(size: int = 128, bumps: int = 6,
                        amplitude: float = 0.8) -> np.ndarray:
    """Host-side tangent-space normal map of a grid of cosine bumps:
    (size, size, 3) in the [0, 1] encoding apply_surface_maps decodes
    (linear data)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = 2.0 * np.pi * bumps
    dhdx = amplitude * np.sin(phase * xx) * phase / size * 8.0
    dhdy = amplitude * np.sin(phase * yy) * phase / size * 8.0
    n = np.stack([-dhdx, -dhdy, np.ones_like(dhdx)], -1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)
