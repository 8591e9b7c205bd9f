"""Local-light evaluation (port of lsr_tpu/lighting/light_runtime.py:
pack_light_records, eval_distance_attenuation, eval_local_lights).

- Point:   shaping 1,                     spec (36.0, 0.30)
- Spot:    smoothstep cone shaping,       spec (34.0, 0.32)
- Rect:    representative-point + facing, spec (26.0, 0.26)
- Tube:    closest-point-on-segment,      spec (22.0, 0.20)
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.lighting.light_types import (
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
    LightsSoA,
)

_HALF_PI = 1.5707963267948966


def _norm(v, eps=1e-8):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=eps)


def _where(c, a, b):
    a = torch.as_tensor(a, dtype=torch.float32, device=c.device)
    b = torch.as_tensor(b, dtype=torch.float32, device=c.device)
    return torch.where(c, a, b)


def eval_distance_attenuation(dist, rng, model, power, bias, cutoff):
    """Linear / Smooth / InverseSquare falloff with power and cutoff."""
    rng = torch.clamp(rng, min=0.001)
    norm = torch.clamp(1.0 - dist / rng, 0.0, 1.0)
    smooth = norm * norm * (3.0 - 2.0 * norm)
    inv = torch.clamp((rng * rng) / torch.maximum(dist * dist, bias),
                      max=1.0) * norm * norm
    falloff = torch.where(model == 0, norm, torch.where(model == 1, smooth, inv))
    falloff = torch.pow(torch.clamp(falloff, min=0.0),
                        torch.clamp(power, min=0.001))
    falloff = torch.where((cutoff > 0.0) & (falloff < cutoff),
                          torch.zeros_like(falloff), falloff)
    return torch.where(dist < rng, torch.clamp(falloff, min=0.0),
                       torch.zeros_like(falloff))


def eval_local_lights(lights_g, world_pos, normal, view_dir):
    """Evaluate gathered lights against shaded points.
    lights_g: dict of light columns shaped (..., K, C); world_pos / normal /
    view_dir: (..., 3).  Returns (diffuse (..., K, 3), specular (..., K, 3))."""
    p = world_pos[..., None, :]
    n = normal[..., None, :]
    v = view_dir[..., None, :]
    ltype = lights_g["type"]
    pos = lights_g["position"]
    fwd = _norm(lights_g["direction"])
    axis = _norm(lights_g["axis"])

    up_hint = _norm(lights_g["up"])
    right = _norm(torch.linalg.cross(up_hint, fwd))
    up = _norm(torch.linalg.cross(fwd, right))
    right = _norm(torch.linalg.cross(up, fwd))
    dvec = p - pos
    he = torch.clamp(lights_g["rect_half_extents"], min=0.05)
    ux = torch.clamp((dvec * right).sum(-1, keepdim=True), -he[..., :1], he[..., :1])
    uy = torch.clamp((dvec * up).sum(-1, keepdim=True), -he[..., 1:2], he[..., 1:2])
    rect_pt = pos + right * ux + up * uy

    half_len = torch.clamp(lights_g["tube_half_length"], min=0.1)[..., None]
    a = pos - axis * half_len
    ab = axis * (2.0 * half_len)
    denom = torch.clamp((ab * ab).sum(-1, keepdim=True), min=1e-8)
    t = torch.clamp(((p - a) * ab).sum(-1, keepdim=True) / denom, 0.0, 1.0)
    tube_pt = a + ab * t

    is_rect = (ltype == LIGHT_RECT_AREA)[..., None]
    is_tube = (ltype == LIGHT_TUBE_AREA)[..., None]
    emit = torch.where(is_rect, rect_pt, torch.where(is_tube, tube_pt, pos))
    to_light = emit - p
    dist = torch.sqrt((to_light * to_light).sum(-1))
    l_dir = to_light / torch.clamp(dist, min=1e-8)[..., None]

    inner = torch.clamp(lights_g["inner_angle"], 0.02, _HALF_PI - 0.02)
    lo = inner + 0.005
    outer = torch.minimum(torch.maximum(torch.maximum(lo, lights_g["outer_angle"]),
                                        lo),
                          torch.full_like(lo, _HALF_PI - 0.005))
    cos_inner = torch.cos(inner)
    cos_outer = torch.cos(outer)
    cos_theta = (-l_dir * fwd).sum(-1)
    tt = torch.clamp((cos_theta - cos_outer)
                     / torch.clamp(cos_inner - cos_outer, min=1e-5), 0.0, 1.0)
    spot_shape = torch.where(cos_theta > cos_outer, tt * tt * (3.0 - 2.0 * tt),
                             torch.zeros_like(tt))
    facing = torch.clamp((fwd * (-l_dir)).sum(-1), min=0.0)
    rect_shape = torch.where(facing > 0.0, 0.65 + 0.55 * facing,
                             torch.zeros_like(facing))
    soft = torch.clamp(1.0 - dist / torch.clamp(lights_g["range"], min=0.1),
                       0.0, 1.0)
    tube_shape = 0.75 + 0.35 * soft
    shaping = torch.where(
        ltype == LIGHT_SPOT, spot_shape,
        torch.where(ltype == LIGHT_RECT_AREA, rect_shape,
                    torch.where(ltype == LIGHT_TUBE_AREA, tube_shape,
                                torch.ones_like(tube_shape))))
    spec_power = _where(ltype == LIGHT_SPOT, 34.0,
                        _where(ltype == LIGHT_RECT_AREA, 26.0,
                               _where(ltype == LIGHT_TUBE_AREA, 22.0, 36.0)))
    spec_scale = _where(ltype == LIGHT_SPOT, 0.32,
                        _where(ltype == LIGHT_RECT_AREA, 0.26,
                               _where(ltype == LIGHT_TUBE_AREA, 0.20, 0.30)))

    ndl = torch.clamp((n * l_dir).sum(-1), min=0.0)
    atten = eval_distance_attenuation(
        dist, lights_g["range"], lights_g["atten_model"],
        lights_g["atten_power"], lights_g["atten_bias"],
        lights_g["atten_cutoff"]) * torch.clamp(shaping, min=0.0)
    live = (dist > 1e-4) & (ndl > 0.0) & (atten > 0.0)
    radiance = (torch.clamp(lights_g["color"], min=0.0)
                * torch.clamp(lights_g["intensity"], min=0.0)[..., None]
                * atten[..., None])
    h = _norm(l_dir + v)
    ndh = torch.clamp((n * h).sum(-1), min=0.0)
    spec = spec_scale * torch.pow(ndh, spec_power)
    live_f = live[..., None].to(radiance.dtype)
    return radiance * ndl[..., None] * live_f, \
        radiance * spec[..., None] * live_f


def pack_light_records(lights: LightsSoA):
    """(L, 32) f32 record: [0] type | [1:4] pos | [4:7] dir | [7:10] up |
    [10:13] axis | [13:16] color | [16] intensity | [17] range | [18] inner |
    [19] outer | [20:22] rect_he | [22] tube_hl | [23] tube_r |
    [24] atten_model | [25] atten_power | [26] atten_bias | [27] atten_cutoff |
    [28:32] pad."""
    n = lights.type.shape[0]
    f = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    return torch.cat([
        f(lights.type), lights.position, lights.direction, lights.up,
        lights.axis, lights.color, f(lights.intensity), f(lights.range),
        f(lights.inner_angle), f(lights.outer_angle), lights.rect_half_extents,
        f(lights.tube_half_length), f(lights.tube_radius),
        f(lights.atten_model), f(lights.atten_power), f(lights.atten_bias),
        f(lights.atten_cutoff),
        torch.zeros((n, 4), dtype=torch.float32, device=lights.type.device),
    ], dim=-1)
