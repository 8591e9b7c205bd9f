"""Left-handed 3D math (conventions: LH, +Y up, +Z forward, NDC z in [-1,1]).

Port of lsr_tpu/core/math3d.py: row-major matrices acting on column vectors,
``clip = M @ [x, y, z, 1]^T``.  Every function returns float32 tensors on
the requested device.
"""

from __future__ import annotations

import torch


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# The small vector ops below round as lsr_tpu's do when it runs them one at a
# time on XLA:CPU, which contracts a * b + c into a fused multiply-add
# inside jnp.linalg.norm and jnp.cross but not inside jnp.dot.  Elementwise
# float32 and float64 ops round the same on the CPU and the card, so each
# device gives the same bits.  They work on whole vectors and matrices at
# once: each op is a launch on the card, and the light camera runs every
# frame.


def fma(a, b, c):
    """float32 a * b + c rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64, but rounding the
    float64 sum to nearest and then to float32 rounds twice: a sum just off
    a float32 midpoint can land on it and tie the wrong way.  So the sum is
    rounded to odd instead (round to nearest, then step one float64 ulp
    toward the exact value when the sum was inexact and its last bit is
    even; the error comes from Knuth's TwoSum).  Rounding to odd with two
    or more spare bits, then to nearest, equals one rounding to nearest."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def dot3(a, b):
    """Dot product over a last axis of 3, summed left to right (jnp.dot)."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def norm3(v):
    """Length over a last axis of 3 (jnp.linalg.norm: fused squares,
    sqrt(fma(z, z, fma(y, y, x * x))))."""
    sq = (v.double() * v.double())        # exact squares
    s = (sq[..., 1] + (v[..., 0] * v[..., 0]).double()).float()
    return torch.sqrt((sq[..., 2] + s.double()).float())


def cross3(a, b):
    """Cross product over a last axis of 3 (jnp.cross: component k is
    fma(a_i, b_j, -(a_j * b_i)) for (i, j) = (1, 2), (2, 0), (0, 1))."""
    ai, bi = torch.roll(a, -1, dims=-1), torch.roll(b, -1, dims=-1)
    aj, bj = torch.roll(a, 1, dims=-1), torch.roll(b, 1, dims=-1)
    return fma(ai, bj, -(aj * bi))


def normalize(v, eps: float = 1e-12):
    """Normalize 3-vectors along the last axis (eps-guarded norm)."""
    return v / torch.clamp(norm3(v)[..., None], min=eps)


def perspective_lh_no(fovy, aspect, znear, zfar, device=None):
    """Left-handed perspective, NDC z in [-1, 1] (glm::perspectiveLH_NO).
    tan(fovy / 2) is taken in float64 and rounded once to float32, so the
    CPU and the card give the same, correctly rounded value."""
    t = torch.tan((_f32(fovy, device) * 0.5).double()).float()
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = (zfar + znear) / (zfar - znear)
    m[2, 3] = -(2.0 * zfar * znear) / (zfar - znear)
    m[3, 2] = 1.0
    return m


def ortho_lh_no(left, right, bottom, top, znear, zfar, device=None):
    """Left-handed orthographic, NDC z in [-1, 1] (glm::orthoLH_NO).  The
    bounds may be 0-d tensors on a device (a fitted light camera)."""
    lo = torch.stack([_f32(x, device) for x in (left, bottom, znear)])
    hi = torch.stack([_f32(x, device) for x in (right, top, zfar)])
    d = hi - lo
    rows = torch.cat([torch.diag(2.0 / d), (-(hi + lo) / d)[:, None]], dim=1)
    return torch.cat([rows, torch.eye(4, device=lo.device)[3:]])


def look_at_lh(eye, center, up, device=None):
    """Left-handed look-at view matrix (glm::lookAtLH).  Leading axes of the
    (..., 3) arguments are a batch: (..., 4, 4) matrices."""
    eye = _f32(eye, device)
    center = _f32(center, device)
    up = _f32(up, device)
    f = normalize(center - eye)
    s = normalize(cross3(up, f))
    rot = torch.stack([s, cross3(f, s), f], dim=-2)
    rows = torch.cat([rot, -dot3(rot, eye[..., None, :])[..., None]], dim=-1)
    last = torch.eye(4, device=rot.device)[3:].expand(rot.shape[:-2] + (1, 4))
    return torch.cat([rows, last], dim=-2)


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


def rotate_x(a, device=None):
    return rotate_axis_angle([1.0, 0.0, 0.0], a, device)


def rotate_y(a, device=None):
    return rotate_axis_angle([0.0, 1.0, 0.0], a, device)


def rotate_z(a, device=None):
    return rotate_axis_angle([0.0, 0.0, 1.0], a, device)


def scale(s, device=None):
    """Scale matrix; s is a scalar or a 3-vector."""
    s = torch.broadcast_to(_f32(s, device), (3,))
    m = torch.eye(4, dtype=torch.float32, device=s.device)
    m[[0, 1, 2], [0, 1, 2]] = s
    return m


def compose_trs(translation, rotation, scale_v, device=None):
    """Model matrix T @ R @ S (rotation: a 4x4 or 3x3 rotation matrix)."""
    rotation = _f32(rotation, device)
    dev = rotation.device
    r4 = rotation
    if rotation.shape == (3, 3):
        r4 = torch.eye(4, dtype=torch.float32, device=dev)
        r4[:3, :3] = rotation
    return matmul4(matmul4(translate(translation, dev), r4),
                   scale(scale_v, dev))


def euler_xyz(rx, ry, rz, device=None):
    """R = Rz @ Ry @ Rx (glm::rotate applied about Z, then Y, then X)."""
    return matmul4(matmul4(rotate_z(rz, device), rotate_y(ry, device)),
                   rotate_x(rx, device))


def normal_matrix(model):
    """Inverse-transpose of the upper-left 3x3, with degenerate-det guard
    (|det| <= 1e-8 keeps the raw 3x3, as lsr_tpu's normal_matrix)."""
    m3 = model[:3, :3]
    det = torch.linalg.det(m3)
    if bool(torch.abs(det) > 1e-8):
        return torch.linalg.inv(m3).T.contiguous()
    return m3.clone()


def transform_points_h(m, pts):
    """(..., N, 3) points -> homogeneous (..., N, 4) via clip = M @ [p,1].
    Each row sums as (m0 x + m1 y) + (m2 z + m3), the order of lsr_tpu's
    (N, 4) @ (4, 4) product on XLA:CPU, on every device."""
    pts = _f32(pts, m.device)
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    p = hom[..., None, :] * m                 # p[..., n, i, k] = m_ik h_k
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def transform_points(m, pts):
    """Affine transform of (..., N, 3) points; drops w (assumes affine m)."""
    return transform_points_h(m, pts)[..., :3]


def transform_dirs(m, dirs):
    """Direction vectors (..., 3) through the upper-left 3x3 of m, each
    component summed left to right."""
    p = _f32(dirs, m.device)[..., None, :] * m[:3, :3]
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def project_to_ndc(clip, eps: float = 1e-12):
    """Perspective divide: (..., 4) clip -> (..., 3) NDC, |w| kept >= eps
    with w's sign."""
    w = clip[..., 3:4]
    guard = torch.where(w < 0, torch.full_like(w, -eps), torch.full_like(w, eps))
    return clip[..., :3] / torch.where(torch.abs(w) < eps, guard, w)


def ndc_to_screen(ndc_xy, width, height):
    """NDC [-1, 1] -> canvas pixel coordinates, bottom-left origin:
    (ndc * 0.5 + 0.5) * (W - 1, H - 1) (rasterizer.hpp:267-269)."""
    wh = torch.tensor([width - 1, height - 1], dtype=torch.float32,
                      device=ndc_xy.device)
    return (ndc_xy * 0.5 + 0.5) * wh


def reflect(i, n):
    """GLM reflect: i - 2 dot(n, i) n (i points toward the surface)."""
    return i - 2.0 * dot3(n, i)[..., None] * n


def matmul4(a, b):
    """(..., 4, 4) @ (..., 4, 4) with transform_points_h's summation order."""
    p = a[..., :, None, :] * b.transpose(-1, -2)[..., None, :, :]
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])   # a_ik b_kj
