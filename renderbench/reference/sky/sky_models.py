"""Sky models and the fullscreen sky (port of lsr_tpu/sky/sky_models.py).

A sky model maps a direction to linear RGB; render_sky evaluates it for
every pixel's camera ray, reconstructed through the inverse
view-projection.
"""

from __future__ import annotations

import torch

from renderbench.reference.core.util import device_const


def _unit(v):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)),
                           min=1e-8)


def procedural_sky(dirs, zenith=(0.2, 0.38, 0.72), horizon=(0.68, 0.72, 0.78),
                   ground=(0.18, 0.16, 0.15), sun_dir_ws=None,
                   sun_color=(1.0, 0.95, 0.85), sun_size: float = 0.995,
                   sun_intensity: float = 12.0):
    """Gradient sky above the horizon, darkened ground below it, and a sun
    disk around -sun_dir_ws.  dirs (..., 3) -> (..., 3)."""
    dev = dirs.device
    d = _unit(dirs)
    up = torch.clamp(d[..., 1:2], -1.0, 1.0)
    t = torch.clamp(up, 0.0, 1.0)
    hor = device_const(horizon, dev)
    sky = hor + (device_const(zenith, dev) - hor) * torch.sqrt(t)
    gnd = device_const(ground, dev) * (1.0 + up * 0.5)
    col = torch.where(up >= 0.0, sky, gnd)
    if sun_dir_ws is not None:
        to_sun = -torch.as_tensor(sun_dir_ws, dtype=torch.float32).to(dev)
        to_sun = _unit(to_sun)
        cos_a = (d * to_sun).sum(-1, keepdim=True)
        disk = torch.clamp((cos_a - sun_size) / max(1.0 - sun_size, 1e-5),
                           0.0, 1.0) ** 2
        col = col + device_const(sun_color, dev) * disk * sun_intensity
    return col


def sample_cubemap(faces, dirs):
    """Bilinear cubemap lookup.  faces (6, S, S, 3) in the order +X, -X,
    +Y, -Y, +Z, -Z; dirs (..., 3).  Returns (..., 3).

    The face is chosen as lsr_tpu chooses it, on cube edges too: X when
    |x| >= |y| and |x| >= |z|, else Y when |y| >= |z|, else Z."""
    d = _unit(dirs)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def pick(cond, a, b):
        return torch.where(cond, a, b)

    face = pick(is_x, pick(x > 0, 0, 1),
                pick(is_y, pick(y > 0, 2, 3), pick(z > 0, 4, 5)))
    ma = torch.clamp(pick(is_x, ax, pick(is_y, ay, az)), min=1e-8)
    u = pick(is_x, pick(x > 0, -z, z), pick(is_y, x, pick(z > 0, x, -x)))
    v = pick(is_y, pick(y > 0, -z, z), y)
    u = (u / ma + 1.0) * 0.5
    v = (v / ma + 1.0) * 0.5

    s = faces.shape[1]
    fx = u * (s - 1)
    fy = v * (s - 1)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    # Indices clamped into the face, as XLA's gather clamps them.
    x1 = torch.clamp(x0 + 1, 0, s - 1)
    y1 = torch.clamp(y0 + 1, 0, s - 1)
    x0 = torch.clamp(x0, 0, s - 1)
    y0 = torch.clamp(y0, 0, s - 1)
    c00 = faces[face, y0, x0]
    c10 = faces[face, y0, x1]
    c01 = faces[face, y1, x0]
    c11 = faces[face, y1, x1]
    return (c00 + (c10 - c00) * tx) + (
        (c01 + (c11 - c01) * tx) - (c00 + (c10 - c00) * tx)) * ty


def camera_ray_dirs(inv_viewproj, width: int, height: int):
    """(H, W, 3) unit world-space ray per pixel center: the near- and
    far-plane points of its NDC position, un-projected."""
    dev = inv_viewproj.device
    xs = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
          / width) * 2.0 - 1.0
    ys = ((torch.arange(height, dtype=torch.float32, device=dev) + 0.5)
          / height) * 2.0 - 1.0
    ny, nx = torch.meshgrid(ys, xs, indexing="ij")
    one = torch.ones_like(nx)
    near = torch.stack([nx, ny, -one, one], -1)
    far = torch.stack([nx, ny, one, one], -1)
    pn = near @ inv_viewproj.T
    pf = far @ inv_viewproj.T
    pn = pn[..., :3] / torch.where(torch.abs(pn[..., 3:4]) > 1e-8,
                                   pn[..., 3:4], torch.ones_like(pn[..., 3:4]))
    pf = pf[..., :3] / torch.where(torch.abs(pf[..., 3:4]) > 1e-8,
                                   pf[..., 3:4], torch.ones_like(pf[..., 3:4]))
    return _unit(pf - pn)


def procedural_sky_cubemap(size: int = 64, sun_dir_ws=None, device=None):
    """The procedural sky baked into a (6, S, S, 3) cubemap (an IBL
    source)."""
    from renderbench.reference.core.util import resolve_device
    from renderbench.reference.resources.ibl import _face_dirs

    dirs = torch.as_tensor(_face_dirs(size), device=resolve_device(device))
    return procedural_sky(dirs, sun_dir_ws=sun_dir_ws)


def render_sky(viewproj, width: int, height: int, kind: str = "procedural",
               sun_dir_ws=None, cubemap=None):
    """Fullscreen sky background (H, W, 3) linear HDR: the cubemap's when
    kind is "cubemap" and one is given, the procedural sky's otherwise."""
    # inv_ex: no error check, so no wait for the card.
    inv_vp = torch.linalg.inv_ex(viewproj)[0]
    dirs = camera_ray_dirs(inv_vp, width, height)
    if kind == "cubemap" and cubemap is not None:
        return sample_cubemap(cubemap, dirs)
    return procedural_sky(dirs, sun_dir_ws=sun_dir_ws)
