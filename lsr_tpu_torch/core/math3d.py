"""Left-handed 3D math (conventions: LH, +Y up, +Z forward, NDC z in [-1,1]).

Port of lsr_tpu/core/math3d.py: row-major matrices acting on column vectors,
``clip = M @ [x, y, z, 1]^T``.  Every function returns float32 tensors on
the requested device.
"""

from __future__ import annotations

import torch


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def normalize(v, eps: float = 1e-12):
    """Normalize along the last axis (eps-guarded norm)."""
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(n, min=eps)


def perspective_lh_no(fovy, aspect, znear, zfar, device=None):
    """Left-handed perspective, NDC z in [-1, 1] (glm::perspectiveLH_NO)."""
    t = torch.tan(_f32(fovy, device) * 0.5)
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = (zfar + znear) / (zfar - znear)
    m[2, 3] = -(2.0 * zfar * znear) / (zfar - znear)
    m[3, 2] = 1.0
    return m


def look_at_lh(eye, center, up, device=None):
    """Left-handed look-at view matrix (glm::lookAtLH)."""
    eye = _f32(eye, device)
    center = _f32(center, device)
    up = _f32(up, device)
    f = normalize(center - eye)
    s = normalize(torch.linalg.cross(up, f))
    u = torch.linalg.cross(f, s)
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = f
    m[0, 3] = -(s * eye).sum()
    m[1, 3] = -(u * eye).sum()
    m[2, 3] = -(f * eye).sum()
    return m


def translate(t, device=None):
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[:3, 3] = _f32(t, device)
    return m


def rotate_axis_angle(axis, angle, device=None):
    """Rotation about a (normalized) axis by angle (radians), like glm::rotate."""
    axis = normalize(_f32(axis, device))
    x, y, z = axis[0], axis[1], axis[2]
    angle = _f32(angle, device)
    c = torch.cos(angle)
    s = torch.sin(angle)
    ic = 1.0 - c
    r = torch.stack([
        torch.stack([c + x * x * ic, x * y * ic - z * s, x * z * ic + y * s]),
        torch.stack([y * x * ic + z * s, c + y * y * ic, y * z * ic - x * s]),
        torch.stack([z * x * ic - y * s, z * y * ic + x * s, c + z * z * ic]),
    ])
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[:3, :3] = r
    return m


def rotate_y(a, device=None):
    return rotate_axis_angle([0.0, 1.0, 0.0], a, device)


def normal_matrix(model):
    """Inverse-transpose of the upper-left 3x3, with degenerate-det guard
    (|det| <= 1e-8 keeps the raw 3x3, as lsr_tpu's normal_matrix)."""
    m3 = model[:3, :3]
    det = torch.linalg.det(m3)
    if bool(torch.abs(det) > 1e-8):
        return torch.linalg.inv(m3).T.contiguous()
    return m3.clone()
