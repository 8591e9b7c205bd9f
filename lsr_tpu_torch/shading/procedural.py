"""Procedural 2D fragment-shader library, the hello-shaders demo family
(port of lsr_tpu/shading/procedural.py).

Every function is a fullscreen field: (H, W) uv / pixel grids -> (H, W, 3)
colors, evaluated with tensor ops on the requested device.  The building
blocks mirror shs::Math (shs_renderer.hpp:127-197): the sin-dot hash
f_random (:179), simplex-based fbm with rotation + shift octaves
(:182-194), and the demos' hsb_to_rgb (hello_color_hsb.cpp:26-40).

mod is jnp.mod's definition, fmod with the divisor's sign (exact, so both
packages give the same bits on the same input); frac is jnp.modf's
fractional part, x - trunc(x).  f_random multiplies sin(...) by 43758.5,
so a 1-ulp difference between two sin implementations moves its value by
up to ~4e-3: fields built on it agree with lsr_tpu's on most pixels, not
on all.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import resolve_device

_PI = 3.14159265358979


def _mod(x, y):
    """jnp.mod: the remainder with the divisor's sign."""
    r = torch.fmod(x, y)
    y = torch.as_tensor(y, dtype=r.dtype, device=r.device)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _frac(x):
    """jnp.modf(x)[0]: x - trunc(x), with x's sign."""
    return x - torch.trunc(x)


def _t(t, device):
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def uv_grid(width: int, height: int, device=None):
    """(H, W) u and v in [0, 1) plus raw pixel coords, bottom-left origin."""
    device = resolve_device(device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px / width, py / height, px, py


def f_random(x, y):
    """shs::Math::f_random: fract(sin(dot(st, (12.9898, 78.233))) *
    43758.5453)."""
    return _mod(_frac(torch.sin(x * 12.9898 + y * 78.233) * 43758.5453123),
                1.0)


def _permute(x):
    return _mod(((x * 34.0) + 1.0) * x, 289.0)


def snoise2(x, y):
    """2D simplex noise (the permutation-polynomial formulation that
    glm::simplex uses).  Values in about [-1, 1]."""
    c_x = 0.211324865405187
    c_y = 0.366025403784439
    c_z = -0.577350269189626
    c_w = 0.024390243902439

    s = (x + y) * c_y
    ix = torch.floor(x + s)
    iy = torch.floor(y + s)
    t = (ix + iy) * c_x
    x0 = x - ix + t
    y0 = y - iy + t

    i1x = (x0 > y0).to(torch.float32)
    i1y = 1.0 - i1x
    x1 = x0 + c_x - i1x
    y1 = y0 + c_x - i1y
    x2 = x0 + c_z
    y2 = y0 + c_z

    ix = _mod(ix, 289.0)
    iy = _mod(iy, 289.0)
    p0 = _permute(_permute(iy) + ix)
    p1 = _permute(_permute(iy + i1y) + ix + i1x)
    p2 = _permute(_permute(iy + 1.0) + ix + 1.0)

    def contrib(p, xx, yy):
        m = torch.clamp(0.5 - (xx * xx + yy * yy), min=0.0)
        m = m * m
        m = m * m
        gx = 2.0 * _frac(p * c_w) - 1.0
        h = torch.abs(gx) - 0.5
        ox = torch.floor(gx + 0.5)
        a0 = gx - ox
        m = m * (1.79284291400159 - 0.85373472095314 * (a0 * a0 + h * h))
        return m * (a0 * xx + h * yy)

    return 130.0 * (contrib(p0, x0, y0) + contrib(p1, x1, y1)
                    + contrib(p2, x2, y2))


def fbm(x, y, octaves: int = 5):
    """shs::Math::fbm: simplex octaves with a fixed rotation + shift."""
    c = torch.cos(_t(0.5, x.device))
    s = torch.sin(_t(0.5, x.device))
    v = torch.zeros_like(x)
    a = 0.5
    for _ in range(octaves):
        v = v + a * snoise2(x, y)
        # p = rot * p * 2 + 100, rot = [[c, -s], [s, c]] (glm column-major).
        nx = (c * x - s * y) * 2.0 + 100.0
        ny = (s * x + c * y) * 2.0 + 100.0
        x, y = nx, ny
        a = a * 0.5
    return v


def hsb_to_rgb(h, s, b):
    """hello_color_hsb.cpp:26-40 conversion (smoothstepped hue ramp)."""
    def channel(off):
        r = torch.clamp(torch.abs(_mod(h * 6.0 + off, 6.0) - 3.0) - 1.0,
                        0.0, 1.0)
        return r * r * (3.0 - 2.0 * r)

    rgb = torch.stack([channel(0.0), channel(4.0), channel(2.0)], dim=-1)
    out = 1.0 + (rgb - 1.0) * s[..., None]
    return out * b[..., None]


def _rgb(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Shader fields (one per reference demo)
# ---------------------------------------------------------------------------

def shader_color_gradient(width: int, height: int, t=0.0, device=None):
    """HelloColorGradient: animated two-corner rgb gradient."""
    u, v, _, _ = uv_grid(width, height, device)
    t = _t(t, u.device)
    r = u * (0.5 + 0.5 * torch.sin(t))
    b = (0.5 + 0.5 * torch.cos(t * 0.7)).expand(u.shape)
    return torch.stack([r, v, b], dim=-1)


def shader_color_hsb(width: int, height: int, t=0.0, device=None):
    """HelloColorHSB: hue from x, brightness from y."""
    u, v, _, _ = uv_grid(width, height, device)
    return hsb_to_rgb(u, torch.ones_like(u), v)


def shader_color_hsb_polar(width: int, height: int, t=0.0, device=None):
    """HelloColorHSBPolar: hue from angle, saturation from radius."""
    u, v, _, _ = uv_grid(width, height, device)
    x = u * 2.0 - 1.0
    y = v * 2.0 - 1.0
    ang = torch.atan2(y, x) / (2.0 * _PI) + 0.5 + _t(t, u.device) * 0.05
    rad = torch.clamp(torch.sqrt(x * x + y * y), max=1.0)
    return hsb_to_rgb(_mod(ang, 1.0), rad, torch.ones_like(rad))


def shader_color_mix(width: int, height: int, t=0.0, device=None):
    """HelloColorMix: mix of two colors by an animated sine curve."""
    u, v, _, _ = uv_grid(width, height, device)
    a = _rgb([0.149, 0.141, 0.912], u.device)
    b = _rgb([1.000, 0.833, 0.224], u.device)
    pct = (0.5 + 0.5 * torch.sin(u * _PI * 2.0 + _t(t, u.device)))[..., None]
    return a + (b - a) * pct


def shader_fbm_clouds(width: int, height: int, t=0.0, octaves: int = 5,
                      device=None):
    """HelloFractalBrownianMotion (hello_fbm.cpp:32-64): warped fbm
    clouds."""
    _, _, px, py = uv_grid(width, height, device)
    t = _t(t, px.device)
    sx = px / width * 3.0
    sy = py / height * 3.0
    warp = torch.abs(torch.sin(t * 0.1) * 3.0)
    sx = sx + warp * sx
    sy = sy + warp * sy

    qx = fbm(sx, sy, octaves)
    qy = fbm(sx + 1.0, sy + 1.0, octaves)
    rx = fbm(sx + qx + 1.7 + 0.15 * t, sy + qy + 9.2, octaves)
    ry = fbm(sx + qx + 8.3 + 0.126 * t, sy + qy + 2.8, octaves)
    f = fbm(sx + rx, sy + ry, octaves)

    c1 = _rgb([0.101961, 0.619608, 0.666667], px.device)
    c2 = _rgb([0.666667, 0.666667, 0.498039], px.device)
    c3 = _rgb([0.0, 0.0, 0.164706], px.device)
    c4 = _rgb([0.666667, 1.0, 1.0], px.device)

    m1 = torch.clamp(f * f * 4.0, 0.0, 1.0)[..., None]
    col = c1 + (c2 - c1) * m1
    ql = torch.clamp(torch.sqrt(qx * qx + qy * qy), 0.0, 1.0)[..., None]
    col = col + (c3 - col) * ql
    rl = torch.clamp(torch.abs(rx), 0.0, 1.0)[..., None]
    col = col + (c4 - col) * rl
    return col * (f * f * f + 0.6 * f * f + 0.5 * f)[..., None]


def shader_green_noise(width: int, height: int, t=0.0,
                       font_scale: float = 16.0, device=None):
    """HelloGreenNoise (matrix rain, hello_green_noise.cpp:27-60)."""
    _, _, px, py = uv_grid(width, height, device)
    ix = px / font_scale
    iy = py / font_scale
    jx = _mod(ix, 1.0)
    jy = _mod(iy, 1.0)
    fx = torch.floor(ix)
    fy = torch.floor(iy)
    speed = 10.0
    offset = 18.0 * torch.sin(fx)
    pyv = fy + torch.floor(_t(t, px.device) * (speed + offset))
    noise = f_random(torch.zeros_like(pyv), pyv)
    g = torch.where((jx > 0.75) | (jy > 0.75) | (noise < 0.25),
                    torch.zeros_like(noise), noise)
    z = torch.zeros_like(g)
    return torch.stack([z, g, z], dim=-1)


def shader_mongolian_flag(width: int, height: int, t=0.0, device=None):
    """HelloMongolianFlag: waving three-band flag + emblem + vignette +
    grain (hello_mongolian_flag.cpp:97-117 field structure)."""
    u, v, px, py = uv_grid(width, height, device)
    dev = u.device
    t = _t(t, dev)
    red = _rgb([0.753, 0.188, 0.286], dev)
    blue = _rgb([0.095, 0.278, 0.610], dev)
    yellow = _rgb([0.980, 0.824, 0.212], dev)

    w = torch.sin((u + v - t * 2.95
                   + torch.sin(15.5 * u + 4.5 * v) * _PI * 0.1) * _PI * 0.6)
    uw = u * (1.0 + (0.026 - 0.026 * w))
    vw = v * (1.0 + (0.026 - 0.026 * w))

    # The middle band is blue, the outer two red.
    middle = (uw >= 1.0 / 3.0) & (uw < 2.0 / 3.0)
    col = torch.where(middle[..., None], blue, red)

    # Emblem: a stacked soyombo-like glyph in the left band.
    ex = (uw - 1.0 / 6.0) * 6.0
    ey = (vw - 0.5) * 3.0
    flame = ((torch.abs(ex) < 0.22) & (ey > 0.55)
             & (ey < 1.0 + 0.2 * torch.cos(ex * 8.0)))
    sun = ex * ex + (ey - 0.35) ** 2 < 0.18 ** 2
    bars = (torch.abs(ex) < 0.45) & (
        ((ey > -0.95) & (ey < -0.75)) | ((ey > 0.05) & (ey < 0.25)))
    rects = (torch.abs(torch.abs(ex) - 0.58) < 0.10) & (torch.abs(ey) < 0.95)
    circ = ex * ex + (ey + 0.42) ** 2 < 0.22 ** 2
    emblem = flame | sun | bars | rects | circ
    col = torch.where(emblem[..., None], yellow, col)

    col = col + w[..., None] * 0.225
    vin = 16.0 * u * (1.0 - u) * v * (1.0 - v)
    col = col * (1.0 - 0.6 * torch.exp2(-1.75 * vin))[..., None]
    col = col - f_random(px, py)[..., None] * 0.004
    return torch.clamp(col, 0.0, 1.0)


def shader_worm_hole(width: int, height: int, t=0.0, samples: int = 7,
                     device=None):
    """HelloWormHole: swirling tunnel with temporal supersampling
    (hello_worm_hole.cpp:137-159 structure)."""
    u, v, _, _ = uv_grid(width, height, device)
    x = (u * 2.0 - 1.0) * (width / height)
    y = v * 2.0 - 1.0
    t = _t(t, u.device)
    r = torch.sqrt(x * x + y * y) + 1e-4
    span = 0.0045 + 0.0002 * r

    col = torch.zeros(u.shape + (3,), dtype=torch.float32, device=u.device)
    for k in range(samples):
        f = k / (samples - 1)
        tk = t + f * span
        ang = torch.atan2(y, x)
        tunnel = 0.3 / r + tk * 2.0
        swirl = ang * 3.0 + 4.0 * r - tk * 3.0
        stripes = 0.5 + 0.5 * torch.sin(tunnel * 8.0 + torch.sin(swirl))
        glow = torch.exp(-2.5 * r)
        ck = torch.stack([
            stripes * (0.4 + 0.6 * torch.sin(tk + ang)) + glow,
            stripes * 0.55 + glow * 0.7,
            stripes * (0.7 + 0.3 * torch.cos(tk * 0.7)) + glow * 1.2,
        ], dim=-1)
        fade = torch.clamp(r * 1.4, 0.0, 1.0)[..., None]
        col = col + ck * fade
    return torch.clamp(col / samples, 0.0, 1.0)


PROCEDURAL_SHADERS = {
    "color_gradient": shader_color_gradient,
    "color_hsb": shader_color_hsb,
    "color_hsb_polar": shader_color_hsb_polar,
    "color_mix": shader_color_mix,
    "fbm": shader_fbm_clouds,
    "green_noise": shader_green_noise,
    "mongolian_flag": shader_mongolian_flag,
    "worm_hole": shader_worm_hole,
}
