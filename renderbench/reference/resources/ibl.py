"""Image-based lighting: the irradiance and prefiltered specular bakes and
their lookup (port of lsr_tpu/resources/ibl.py).

The bakes integrate over deterministic Hammersley sample directions and sum
them in chunks of 32, in lsr_tpu's chunk order (its lax.scan), so that the
maps agree in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from renderbench.reference.core.util import device_const
from renderbench.reference.sky.sky_models import sample_cubemap

_CHUNK = 32     # sample directions summed at a time


def _face_dirs(size: int):
    """(6, S, S, 3) outward unit direction of each cubemap texel, in
    sample_cubemap's face conventions (numpy)."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(t, t)
    one = np.ones_like(u)
    faces = [
        np.stack([one, v, -u], -1),    # +X
        np.stack([-one, v, u], -1),    # -X
        np.stack([u, one, -v], -1),    # +Y
        np.stack([u, -one, v], -1),    # -Y
        np.stack([u, v, one], -1),     # +Z
        np.stack([-u, v, -one], -1),   # -Z
    ]
    d = np.stack(faces)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _hammersley(n: int):
    """(n, 2) float32 Hammersley points: i / n and the bit-reversed i."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = (((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1))
    bits = (((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2))
    bits = (((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4))
    bits = (((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8))
    return np.stack([i / n, bits.astype(np.float64) / 2**32],
                    -1).astype(np.float32)


def _unit(v):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)),
                           min=1e-8)


def _tangent_basis(n):
    """(t, b) completing the unit normals n (..., 3) to a frame."""
    dev = n.device
    up = torch.where(torch.abs(n[..., 1:2]) < 0.95,
                     device_const([0.0, 1.0, 0.0], dev),
                     device_const([1.0, 0.0, 0.0], dev))
    t = _unit(torch.linalg.cross(up.expand(n.shape), n))
    return t, torch.linalg.cross(n, t)


def _lobe_sum(env_faces, dirs, local, weighted: bool):
    """Sum over the sample directions `local` (N, 3) in each texel's frame
    of env_faces' color (times the cosine weight when weighted), chunk by
    chunk.  Returns (acc (6, S, S, 3), weight sum ())."""
    t, b = _tangent_basis(dirs)
    acc = torch.zeros_like(dirs)
    wsum = torch.zeros((), dtype=torch.float32, device=dirs.device)
    for chunk in local.reshape(-1, _CHUNK, 3):
        sd = (t[..., None, :] * chunk[:, 0, None]
              + b[..., None, :] * chunk[:, 1, None]
              + dirs[..., None, :] * chunk[:, 2, None])   # (6, S, S, C, 3)
        col = sample_cubemap(env_faces, sd)
        if weighted:
            w = chunk[:, 2]
            acc = acc + (col * w[:, None]).sum(-2)
            wsum = wsum + w.sum()
        else:
            acc = acc + col.sum(-2)
    return acc, wsum


def _local_dirs(cos_t, phi):
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], -1)


def compute_irradiance_map(env_faces, out_size: int = 16, samples: int = 256):
    """Cosine-weighted diffuse irradiance cubemap (6, S, S, 3) of
    env_faces."""
    dev = env_faces.device
    dirs = torch.as_tensor(_face_dirs(out_size), device=dev)
    xi = torch.as_tensor(_hammersley(samples), device=dev)
    phi = 2.0 * np.pi * xi[:, 0]
    cos_t = torch.sqrt(1.0 - xi[:, 1])
    sin_t = torch.sqrt(xi[:, 1])
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                         cos_t], -1)
    acc, _ = _lobe_sum(env_faces, dirs, local, weighted=False)
    return acc / samples


def compute_prefiltered_specular(env_faces, out_size: int = 32,
                                 samples: int = 128, mips: int = 5):
    """Phong-lobe prefiltered specular chain: a list of `mips` (6, S_m,
    S_m, 3) maps, S_m = max(4, out_size >> m), roughness m / (mips - 1)."""
    dev = env_faces.device
    xi = torch.as_tensor(_hammersley(samples), device=dev)
    phi = 2.0 * np.pi * xi[:, 0]
    out = []
    for mip in range(mips):
        size = max(4, out_size >> mip)
        rough = mip / max(1, mips - 1)
        power = np.float32(max(2.0, (1.0 - rough) * 512.0))
        exponent = float(np.float32(1.0) / (power + np.float32(1.0)))
        dirs = torch.as_tensor(_face_dirs(size), device=dev)
        local = _local_dirs(torch.pow(xi[:, 1], exponent), phi)
        acc, wsum = _lobe_sum(env_faces, dirs, local, weighted=True)
        out.append(acc / torch.clamp(wsum, min=1e-6))
    return out


def sample_prefiltered(mip_maps, dirs, roughness):
    """Prefiltered lookup, linear between the two mips around roughness
    (..., same leading shape as dirs)."""
    mips = len(mip_maps)
    level = torch.clamp(roughness, 0.0, 1.0) * (mips - 1)
    lo = torch.clamp(torch.floor(level).to(torch.int64), 0, mips - 1)
    frac = level - lo.to(torch.float32)
    out = torch.zeros(dirs.shape[:-1] + (3,), dtype=torch.float32,
                      device=dirs.device)
    zero = torch.zeros_like(frac)
    for m in range(mips):
        cm = sample_cubemap(mip_maps[m], dirs)
        w = (torch.where(lo == m, 1.0 - frac, zero)
             + torch.where(lo + 1 == m, frac, zero))
        if w.ndim < cm.ndim:
            w = w[..., None]
        out = out + cm * w
    return out


def eval_ibl(irradiance_faces, prefiltered_mips, n, v, base_color, metallic,
             roughness, ao):
    """The IBL ambient term: diffuse from the irradiance map, specular from
    the prefiltered chain along the reflection, Schlick-weighted."""
    ndv = torch.clamp((n * v).sum(-1, keepdim=True), min=0.0)
    r = 2.0 * ndv * n - v
    irr = sample_cubemap(irradiance_faces, n)
    spec_env = sample_prefiltered(
        prefiltered_mips, r,
        roughness[..., 0] if roughness.ndim > n.ndim - 1 else roughness)
    f0 = 0.04 + (base_color - 0.04) * metallic
    fres = torch.pow(1.0 - ndv, 5.0)
    f = f0 + (torch.maximum(1.0 - roughness, f0) - f0) * fres
    kd = (1.0 - f) * (1.0 - metallic)
    return (kd * base_color * irr + spec_env * f) * torch.clamp(ao, 0.0, 1.0)
