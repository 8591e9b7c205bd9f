"""Local-light evaluation and the binned accumulation over the framebuffer
(port of lsr_tpu/lighting/light_runtime.py: pack_light_records,
unpack_light_records, eval_distance_attenuation, eval_local_lights,
accumulate_local_lights, combine_local_light, eval_env_probes,
collect_object_lights, animate_lights).

accumulate_local_lights is lsr_tpu's XLA anchor of the binned light loop:
per screen tile, chunk by chunk of its padded list, in list order, with the
local-shadow plane of each light.  lsr_tpu keeps it in XLA; the port runs
it as kernel G1 (csrc/local_lights.cu) on the card and as its plain
version, accumulate_local_lights_plain (torch ops), on the CPU, and G1
equals the plain version bit for bit on the card (kernel B6,
lighting/fplus_kernel.py, bins its own lists).

- Point:   shaping 1,                     spec (36.0, 0.30)
- Spot:    smoothstep cone shaping,       spec (34.0, 0.32)
- Rect:    representative-point + facing, spec (26.0, 0.26)
- Tube:    closest-point-on-segment,      spec (22.0, 0.20)
"""

from __future__ import annotations

import dataclasses

import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.util import cdiv, device_const
from lsr_tpu_torch.lighting.light_types import (
    LIGHT_ENV_PROBE,
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
    LightsSoA,
    light_bounding_spheres,
)
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

_HALF_PI = 1.5707963267948966


def _norm(v, eps=1e-8):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=eps)


def _where(c, a, b):
    a, b = (x.to(torch.float32) if isinstance(x, torch.Tensor)
            else device_const(x, c.device) for x in (a, b))
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


def unpack_light_records(rec, live_mask=None):
    """(..., 32) packed records -> the column dict eval_local_lights takes;
    live_mask zeroes the intensity of the slots it leaves out."""
    intensity = rec[..., 16]
    if live_mask is not None:
        intensity = torch.where(live_mask, intensity,
                                torch.zeros_like(intensity))
    return {
        "type": rec[..., 0].to(torch.int64),
        "position": rec[..., 1:4],
        "direction": rec[..., 4:7],
        "up": rec[..., 7:10],
        "axis": rec[..., 10:13],
        "color": rec[..., 13:16],
        "intensity": intensity,
        "range": rec[..., 17],
        "inner_angle": rec[..., 18],
        "outer_angle": rec[..., 19],
        "rect_half_extents": rec[..., 20:22],
        "tube_half_length": rec[..., 22],
        "tube_radius": rec[..., 23],
        "atten_model": rec[..., 24].to(torch.int64),
        "atten_power": rec[..., 25],
        "atten_bias": rec[..., 26],
        "atten_cutoff": rec[..., 27],
    }


_COLUMNS = ("type", "position", "direction", "up", "axis", "color",
            "intensity", "range", "inner_angle", "outer_angle",
            "rect_half_extents", "tube_half_length", "tube_radius",
            "atten_model", "atten_power", "atten_bias", "atten_cutoff")


def _gather_light_columns(lights: LightsSoA, idx):
    """The light columns at the -1-padded indices idx (...) -> (..., C);
    a padded slot gets intensity 0."""
    safe = torch.clamp(idx, 0, lights.type.shape[0] - 1)
    cols = {name: getattr(lights, name)[safe] for name in _COLUMNS}
    cols["intensity"] = torch.where(idx >= 0, cols["intensity"],
                                    torch.zeros_like(cols["intensity"]))
    return cols


def _to_tiles(x, tile_size: int, tiles_y: int, tiles_x: int):
    """(H, W, C...) -> (tiles, ts * ts, C...), zero-padded to whole
    tiles."""
    h, w = x.shape[0], x.shape[1]
    ph, pw = tiles_y * tile_size, tiles_x * tile_size
    xp = torch.zeros((ph, pw) + tuple(x.shape[2:]), dtype=x.dtype,
                     device=x.device)
    xp[:h, :w] = x
    xp = xp.reshape((tiles_y, tile_size, tiles_x, tile_size)
                    + tuple(x.shape[2:])).transpose(1, 2)
    return xp.reshape((tiles_y * tiles_x, tile_size * tile_size)
                      + tuple(x.shape[2:]))


def _from_tiles(x, tile_size: int, tiles_y: int, tiles_x: int, h: int,
                w: int):
    c = tuple(x.shape[2:])
    xp = x.reshape((tiles_y, tiles_x, tile_size, tile_size) + c)
    xp = xp.transpose(1, 2).reshape((tiles_y * tile_size,
                                     tiles_x * tile_size) + c)
    return xp[:h, :w]


def _shadowed(d, s, vis_t, sidx):
    """d, s (T, px, chunk, 3) times each light's visibility plane: vis_t
    (T, px, K+1), sidx (T, chunk) or (T, px, chunk) the plane of each
    slot.  lsr_tpu selects the plane with a one-hot (K+1)-wide product;
    for the finite planes local_shadow_vis_stack makes and sidx in [0, K],
    a gather of the same plane is the same value."""
    t, px = vis_t.shape[:2]
    if sidx.ndim == 2:
        sidx = sidx[:, None, :].expand(t, px, sidx.shape[1])
    vis = torch.gather(vis_t, 2, sidx)
    return d * vis[..., None], s * vis[..., None]


def accumulate_local_lights_plain(gb_world_pos, gb_normal, camera_pos,
                                  lights: LightsSoA, tile_lists, width: int,
                                  height: int, tile_size: int = 16,
                                  chunk: int = 8, cluster_of_pixel=None,
                                  slices: int = 1, shadow_vis_stack=None,
                                  light_shadow_index=None):
    """Sum the binned local lights over the framebuffer (the plain version
    of kernel G1, what accumulate_local_lights runs for CPU tensors).

    tile_lists: (tiles [* slices], cap) -1-padded light indices, tiles of
    tile_size over (height, width) row-major.  cluster_of_pixel: optional
    (H, W) slice of each pixel (clustered lists); None: tiled lists.
    shadow_vis_stack: optional (H, W, K+1) local-shadow visibility planes
    (plane K is 1.0), light_shadow_index: (L,) the plane of each light.
    The lists are walked `chunk` slots at a time, in order.
    Returns (diffuse (H, W, 3), specular (H, W, 3))."""
    dev = gb_world_pos.device
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    n_tiles = tiles_y * tiles_x
    wp_t = _to_tiles(gb_world_pos, tile_size, tiles_y, tiles_x)  # (T, px, 3)
    n_t = _to_tiles(gb_normal, tile_size, tiles_y, tiles_x)
    v_t = _norm(camera_pos[None, None, :] - wp_t)
    vis_t = None
    if shadow_vis_stack is not None:
        # Padded pixels tile to all-zero planes; they are cropped at the end.
        vis_t = _to_tiles(shadow_vis_stack, tile_size, tiles_y, tiles_x)
    list_idx = None
    if cluster_of_pixel is not None:
        cl_t = _to_tiles(cluster_of_pixel[..., None], tile_size, tiles_y,
                         tiles_x)[..., 0].to(torch.int64)
        list_idx = torch.arange(n_tiles, device=dev)[:, None] * slices + cl_t

    cap = tile_lists.shape[1]
    n_chunks = -(-cap // chunk)
    lists_p = torch.full((tile_lists.shape[0], n_chunks * chunk), -1,
                         dtype=torch.int64, device=dev)
    lists_p[:, :cap] = tile_lists
    packed = pack_light_records(lights)
    safe_rows = torch.clamp(lists_p, 0, packed.shape[0] - 1)
    if list_idx is None:
        tile_rec = torch.where((lists_p >= 0)[..., None], packed[safe_rows],
                               torch.zeros((), device=dev))  # (T, capP, 32)

    diff = torch.zeros((n_tiles, tile_size * tile_size, 3),
                       dtype=torch.float32, device=dev)
    spec = torch.zeros_like(diff)
    for ck in range(n_chunks):
        sl = slice(ck * chunk, (ck + 1) * chunk)
        if list_idx is None:
            rec = tile_rec[:, sl]
            # Padded slots have zero range.
            cols = unpack_light_records(rec, rec[..., 17] > 0.0)
            cols = {k: v[:, None] for k, v in cols.items()}
            ids = safe_rows[:, sl]                              # (T, chunk)
        else:
            idx = lists_p[:, sl][list_idx]                      # (T, px, chunk)
            ids = torch.clamp(idx, 0, packed.shape[0] - 1)
            cols = unpack_light_records(packed[ids], idx >= 0)
        d, s = eval_local_lights(cols, wp_t, n_t, v_t)
        if vis_t is not None:
            d, s = _shadowed(d, s, vis_t, light_shadow_index[ids])
        diff = diff + d.sum(-2)
        spec = spec + s.sum(-2)
    return (_from_tiles(diff, tile_size, tiles_y, tiles_x, height, width),
            _from_tiles(spec, tile_size, tiles_y, tiles_x, height, width))


# The bounds within which kernel G1 decides that a pair adds +0 (its kBound
# and kNormalBound; light_walk.local_light_skips models the rule).
SKIP_BOUND = 1e6         # the light fields, the position and the camera
SKIP_NORMAL_BOUND = 2.0  # a normal component


def _kernel_args(gb_world_pos, gb_normal, camera_pos, lights: LightsSoA,
                 tile_lists, width, height, tile_size, chunk,
                 cluster_of_pixel, slices, shadow_vis_stack,
                 light_shadow_index):
    """Raise ValueError on what kernel G1 does not take (host metadata
    only: shapes, types, devices)."""
    dev = gb_world_pos.device

    def bad(msg):
        raise ValueError(f"accumulate_local_lights: {msg}")

    if tile_size < 1 or not 1 <= chunk <= 32:
        bad("tile_size must be >= 1 and chunk in [1, 32] (PyTorch sums a "
            "chunk of at most 32 in one thread, the order G1 follows)")
    if lights.count < 1:
        bad("needs at least one light")
    rows = cdiv(width, tile_size) * cdiv(height, tile_size)
    if cluster_of_pixel is not None:
        rows *= slices
        if (slices < 1 or tuple(cluster_of_pixel.shape) != (height, width)
                or cluster_of_pixel.dtype.is_floating_point
                or cluster_of_pixel.device != dev):
            bad("cluster_of_pixel must be (height, width) integers on the "
                "G-buffer's device")
    if (tile_lists.ndim != 2 or tile_lists.shape[0] != rows
            or tile_lists.dtype not in (torch.int32, torch.int64)
            or tile_lists.device != dev):
        bad(f"tile_lists must be ({rows}, cap) int32 / int64 on {dev}")
    tensors = [("gb_world_pos", gb_world_pos, (height, width, 3)),
               ("gb_normal", gb_normal, (height, width, 3)),
               ("camera_pos", camera_pos, (3,))]
    if shadow_vis_stack is not None:
        if (light_shadow_index is None
                or tuple(light_shadow_index.shape) != (lights.count,)
                or light_shadow_index.dtype.is_floating_point
                or light_shadow_index.device != dev):
            bad("planes need light_shadow_index: (L,) integers")
        tensors.append(("shadow_vis_stack", shadow_vis_stack,
                        (height, width, max(shadow_vis_stack.shape[-1], 1))))
    for name, t, shape in tensors:
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or t.numel() >= 2 ** 31):
            bad(f"{name} must be {shape} f32 on {dev}")


def _local_lights_launch(lib, gb_world_pos, gb_normal, camera_pos, packed,
                         tile_lists, width, height, tile_size, chunk,
                         cluster_of_pixel, slices, shadow_vis_stack,
                         light_shadow_index, stream):
    """Launch kernel G1 through the C interface; returns (diffuse,
    specular), each (H, W, 3)."""
    dev = gb_world_pos.device
    i64 = lambda t: None if t is None else t.to(torch.int64)  # noqa: E731
    lists = i64(tile_lists).contiguous()
    sidx = i64(light_shadow_index)
    sidx = None if sidx is None else sidx.contiguous()
    cluster = i64(cluster_of_pixel)
    cam = camera_pos.contiguous()
    vis = shadow_vis_stack
    diffuse = torch.empty((height, width, 3), dtype=torch.float32,
                          device=dev)
    specular = torch.empty_like(diffuse)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    cl_s = (0, 0) if cluster is None else cluster.stride()
    v_s = (0, 0, 0) if vis is None else vis.stride()
    err = lib.lsr_local_lights(
        gb_world_pos.data_ptr(), *gb_world_pos.stride(), gb_normal.data_ptr(),
        *gb_normal.stride(), cam.data_ptr(), packed.data_ptr(),
        packed.shape[0], lists.data_ptr(), lists.shape[1], chunk,
        ptr(cluster), *cl_s, slices if cluster is not None else 1, ptr(vis),
        *v_s, 0 if vis is None else vis.shape[-1], ptr(sidx),
        diffuse.data_ptr(), specular.data_ptr(), width, height, tile_size,
        stream)
    check_launch("lsr_local_lights", err)
    return diffuse, specular


def accumulate_local_lights(gb_world_pos, gb_normal, camera_pos,
                            lights: LightsSoA, tile_lists, width: int,
                            height: int, tile_size: int = 16, chunk: int = 8,
                            cluster_of_pixel=None, slices: int = 1,
                            shadow_vis_stack=None, light_shadow_index=None):
    """Sum the binned local lights over the framebuffer: the arguments and
    result of accumulate_local_lights_plain.  CPU tensors run the plain
    version; CUDA tensors launch kernel G1 (csrc/local_lights.cu, once, on
    the current stream, with no host read) or raise ValueError on what it
    does not take: chunk outside [1, 32], G-buffer planes other than
    (height, width, 3) f32, a list count other than the tiles' (times the
    slices), planes without light_shadow_index, no light.  G1 leaves a
    (pixel, light) pair out only where the plain version adds +0, and
    decides that only where the pair's inputs lie within SKIP_BOUND (a
    normal within SKIP_NORMAL_BOUND)."""
    args = (gb_world_pos, gb_normal, camera_pos, lights, tile_lists, width,
            height, tile_size, chunk, cluster_of_pixel, slices,
            shadow_vis_stack, light_shadow_index)
    dev = gb_world_pos.device
    if dev.type == "cpu":
        return accumulate_local_lights_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"accumulate_local_lights: unsupported device {dev}")
    _kernel_args(*args)
    out = _local_lights_launch(
        load_kernels(), gb_world_pos, gb_normal, camera_pos,
        pack_light_records(lights), tile_lists, width, height, tile_size,
        chunk, cluster_of_pixel, slices, shadow_vis_stack,
        light_shadow_index, torch.cuda.current_stream(dev).cuda_stream)
    accumulate_local_lights.launches += 1
    return out


accumulate_local_lights.launches = 0


def combine_local_light(albedo, diffuse, specular):
    """Albedo-modulated diffuse plus white specular."""
    return albedo * diffuse + specular


def eval_env_probes(lights: LightsSoA, world_pos, ambient,
                    max_probes: int = 8):
    """Localized IBL: each enabled LIGHT_ENV_PROBE row (position, range)
    re-emits the ambient term scaled by its color * intensity with a
    smoothstep falloff.  ambient (H, W, 3); returns the additive
    contribution (H, W, 3) of the first max_probes probe rows."""
    is_probe = (lights.type == LIGHT_ENV_PROBE) & lights.enabled
    order = torch.argsort(torch.where(is_probe, 0, 1), stable=True)[
        :max_probes]
    pos = lights.position[order]                           # (K, 3)
    rng = torch.clamp(lights.range[order], min=1e-3)
    gain = (torch.clamp(lights.color[order], min=0.0)
            * torch.clamp(lights.intensity[order], min=0.0)[:, None])
    valid = is_probe[order].to(torch.float32)
    dv = world_pos[..., None, :] - pos[None, None, :, :]
    d = torch.sqrt((dv * dv).sum(-1))                      # (H, W, K)
    t = torch.clamp(1.0 - d / rng[None, None, :], 0.0, 1.0)
    w = t * t * (3.0 - 2.0 * t) * valid[None, None, :]
    return ambient * torch.einsum("hwk,kc->hwc", w, gain)


# ---------------------------------------------------------------------------
# Per-object light selection and light motion (light_runtime.hpp:537-632)
# ---------------------------------------------------------------------------

def collect_object_lights(lights: LightsSoA, obj_centers, obj_radii,
                          cap: int = 8):
    """Per-object candidate light lists (collect_object_lights /
    LightSelection, light_runtime.hpp:258-289, :592): for each object the
    `cap` nearest enabled local lights whose bounding spheres touch the
    object's bounding sphere, nearest first, ties in light order.  Returns
    (indices (O, cap) int32 padded with -1, counts (O,) int32)."""
    centers, radii = light_bounding_spheres(lights)
    d = obj_centers[:, None, :] - centers[None, :, :]
    dist2 = (d * d).sum(-1)                                   # (O, L)
    reach = radii[None, :] + obj_radii[:, None]
    touching = dist2 <= reach * reach
    local = (lights.type != 0) & (lights.type != LIGHT_ENV_PROBE) \
        & lights.enabled
    mask = touching & local[None, :]
    key = torch.where(mask, dist2, torch.full_like(dist2, float("inf")))
    order = torch.argsort(key, dim=1, stable=True)[:, :cap]
    picked = torch.gather(mask, 1, order)
    idx = torch.where(picked, order, torch.full_like(order, -1))
    return idx.to(torch.int32), picked.sum(dim=1).to(torch.int32)


def animate_lights(lights: LightsSoA, time_s, orbit_radius=0.0,
                   orbit_speed=1.0, orbit_axis=(0.0, 1.0, 0.0),
                   pulse_amount=0.0, pulse_speed=2.0, phase=None):
    """Light motion profiles (update_light_motion, light_runtime.hpp:
    537-590): positions orbit their anchors in the plane orthogonal to
    orbit_axis and intensities pulse, over the whole set at once.  phase:
    optional (L,) per-light phase offsets (default 0.618 * index)."""
    dev = lights.position.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    if phase is None:
        phase = torch.arange(lights.count, dtype=torch.float32,
                             device=dev) * 0.618
    t = f32(time_s)
    axis = f32(orbit_axis)
    axis = axis / torch.clamp(m3.norm3(axis), min=1e-8)
    ref = torch.where(torch.abs(axis[1]) > 0.9, f32([1.0, 0.0, 0.0]),
                      f32([0.0, 1.0, 0.0]))
    u = m3.cross3(axis, ref)
    u = u / torch.clamp(m3.norm3(u), min=1e-8)
    v = m3.cross3(axis, u)
    ang = t * orbit_speed + phase
    offset = (u[None, :] * torch.cos(ang)[:, None]
              + v[None, :] * torch.sin(ang)[:, None]) * orbit_radius
    pulse = 1.0 + pulse_amount * torch.sin(t * pulse_speed + phase)
    return dataclasses.replace(lights, position=lights.position + offset,
                               intensity=lights.intensity * pulse)
