"""Local light shadows: spot maps and point cube faces (port of
lsr_tpu/lighting/local_shadows.py: LocalShadowMaps, default_vis_crop,
plan_shadow_casters, plan_slot_stacks, shadow_index_for_lights,
render_local_shadow_maps and the visibility planes, :90-1027).

The flagship's local atlas: up to 8 spot maps and 2 point lights x 6 cube
faces, each slot a depth-only raster (kernel B1, NDC01, no ids) of the
shadow casters inside the slot's own frustum.  Three strategies, as in
lsr_tpu (atlas_packed):
  False ("map")   per slot: frustum cull, scene_setup_depth(CULL_NONE), one
                  B1 launch;
  True ("packed") one scene_setup_slots_depth over the stack, the slots
                  merged into one tall target (_stack_slot_setups, each slot
                  padded to whole supers of 256 rows) and ONE B1 launch with
                  band_h = size (slot-local rows, kernel variant B1a);
  "hybrid"        the batched setup, then one B1 launch per slot.
All three give the same maps bit for bit.

A slot's table is its (S, S) int32 q16 plane: ESM's prefiltered soft map of
the LINEARISED slot depth (_linearize01), or PCF's depth.  lsr_tpu packs
these as u32 texel pairs and u16 anchor windows for its gathers
(convert.local_shadow_maps unpacks them); fetching the clamped texel of the
plane gives the same values and counts.

Sampling gives one visibility plane per shadowed light, plane K the
constant 1.0 of unshadowed lights (light_shadow_index).  Planes of one
light kind are evaluated together, batched over the lights.  Three choices
against lsr_tpu, each the same function without a host sync:
- a light culled this frame (caster_enabled False) renders an all-far map
  by masking its slot's setup lanes (lsr_tpu's batched strategies do the
  same; its "map" strategy skips the raster with lax.cond) and its plane is
  torch.where(enabled, plane, 1.0);
- vis_crop is accepted and the planes are evaluated on the full grid:
  lsr_tpu's crop cascade (_cropped_plane) picks a crop from the data
  through nested lax.cond and is documented exact against the full grid
  (:679-683, :805-806); it exists for the TPU's gather-row cost;
- a point light's per-pixel face view-projection is an indexed gather,
  where lsr_tpu contracts a one-hot face vector with the six matrices
  (:861-864): the sum of 0 * x + 1 * v over finite entries is v exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsr_tpu_torch.core import math3d as m3
from lsr_tpu_torch.core.image import resize_bilinear
from lsr_tpu_torch.core.util import device_const
from lsr_tpu_torch.geometry.volumes import frustum_cull_objects
from lsr_tpu_torch.lighting.light_types import (
    LIGHT_POINT,
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
)
from lsr_tpu_torch.lighting.shadow_sample import (
    Q16,
    esm_visibility,
    prefilter_esm,
    quantize_q16,
)
from lsr_tpu_torch.raster.setup import (
    CULL_NONE,
    DEPTH_NDC01,
    TriSetup,
    scene_setup_depth,
    scene_setup_slots_depth,
)
from lsr_tpu_torch.raster.tiled import _SUPER, rasterize_direct
from lsr_tpu_torch.scene.scene import object_world_aabbs

# shadow_technique.hpp:18-25
SHADOW_NONE = 0
SHADOW_SPOT_2D = 2          # SpotMap2D (also AreaProxySpotMap2D)
SHADOW_POINT_CUBE = 3

_SHADOW_NEAR = 0.05          # kShadowNearZ, hello_rendering_paths.cpp:100
_LOCAL_STRENGTH = 0.72       # spot strength, hello_rendering_paths.cpp:6398
_F32 = lambda x: float(np.float32(x))  # noqa: E731
_FAR_MIN = _F32(_SHADOW_NEAR + 0.2)
_FOV_MIN, _FOV_MAX = _F32(np.deg2rad(25.0)), _F32(np.deg2rad(150.0))
_FOV_POINT = _F32(np.deg2rad(90.0))

# Cube face forward / up table (make_point_shadow_face_view_proj :6824).
_FACE_DIRS = np.asarray(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float32)
_FACE_UPS = np.asarray(
    [[0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, -1, 0], [0, -1, 0]],
    np.float32)


@dataclasses.dataclass(frozen=True)
class LocalShadowMaps:
    """The rendered local-shadow stacks and the per-light sampling data.

    K = number of shadowed lights; visibility stacks carry K+1 planes (plane
    K is the constant 1.0 every unshadowed light indexes).  base_slots[k]
    indexes the light's own stack: its spot slot, or its first cube face
    (6 * p)."""
    spot_taps: torch.Tensor | None   # (n_spot, S1, S1) i32 q16 planes
    point_taps: torch.Tensor | None  # (n_point * 6, S2, S2) i32 q16 planes
    spot_viewproj: torch.Tensor      # (n_spot, 16) row-major
    point_viewproj: torch.Tensor     # (n_point * 6, 16)
    caster_pos: torch.Tensor         # (K, 3)
    caster_range: torch.Tensor       # (K,)
    light_shadow_index: torch.Tensor  # (L,) i64: k if shadowed, else K
    strength: torch.Tensor           # (K,)
    bias_const: float = _F32(2e-3)   # host floats holding f32 values
    bias_slope: float = _F32(6e-3)
    caster_enabled: torch.Tensor | None = None  # (K,) bool: survived the
                                     # camera cull this frame
    spot_size: int = 1024
    point_size: int = 512
    pcf_radius: int = 1
    kinds: tuple = ()                # per shadowed light: SPOT_2D | CUBE
    base_slots: tuple = ()
    vis_scale: int = 1
    filter_mode: str = "pcf"         # "pcf" | "esm"
    esm_c: float = 80.0

    @property
    def n_shadowed(self) -> int:
        return len(self.kinds)


def default_vis_crop(height: int, width: int) -> tuple:
    """lsr_tpu's four-level crop cascade for the plane evaluation (sublane
    multiple of 8, lane multiple of 128), ascending area; the port takes it
    and evaluates the full grid, which is the same function."""
    def rh(f):
        return min(height, -(-int(height * f) // 8) * 8)

    def rw(f):
        return min(width, -(-int(width * f) // 128) * 128)

    out, seen = [], set()
    for lv in [(rh(33 / 64), rw(1 / 3)), (rh(5 / 8), rw(1 / 2)),
               (rh(3 / 4), width), (height, rw(3 / 4))]:
        if lv not in seen and not (lv[0] >= height and lv[1] >= width):
            seen.add(lv)
            out.append(lv)
    return tuple(out)


def plan_shadow_casters(lights, max_spot: int = 8, max_point: int = 2,
                        include_area_proxies: bool = True):
    """Which lights get shadow maps: the first max_spot enabled spots (and
    area lights as spot proxies) and the first max_point enabled points in
    light order (hello_rendering_paths.cpp:6390-6646).  Host-side, once per
    light set.  Returns (spot_ids, point_ids), tuples of ints."""
    types = lights.type.cpu().numpy()
    enabled = lights.enabled.cpu().numpy()
    spot_ids, point_ids = [], []
    for i in range(types.shape[0]):
        if not enabled[i]:
            continue
        t = int(types[i])
        if t == LIGHT_SPOT or (include_area_proxies
                               and t in (LIGHT_RECT_AREA, LIGHT_TUBE_AREA)):
            if len(spot_ids) < max_spot:
                spot_ids.append(i)
        elif t == LIGHT_POINT and len(point_ids) < max_point:
            point_ids.append(i)
    return tuple(spot_ids), tuple(point_ids)


def _perspective(tan_half, far):
    """(N, 4, 4) perspective_lh_no at aspect 1 and near _SHADOW_NEAR for
    per-slot tan(fov / 2) and far (N,), in lsr_tpu's f32 operations."""
    zero = torch.zeros_like(far)
    a = 1.0 / tan_half
    r2 = torch.stack([zero, zero, (far + _SHADOW_NEAR) / (far - _SHADOW_NEAR),
                      -(2.0 * far * _SHADOW_NEAR) / (far - _SHADOW_NEAR)], -1)
    return torch.stack([
        torch.stack([a, zero, zero, zero], -1),
        torch.stack([zero, a, zero, zero], -1), r2,
        torch.stack([zero, zero, zero + 1.0, zero], -1)], dim=-2)


def _tan_half(fov):
    """tan(fov * 0.5) of f32 angles, correctly rounded to f32 (through
    float64), so that the CPU and the card give the same bits; it equals
    XLA:CPU's f32 tan at the atlas's angles."""
    return torch.tan((fov * 0.5).double()).float()


def _spot_viewproj(pos, direction, outer_angle, rng):
    """(N, 4, 4) build_local_shadow_vp (hello_rendering_paths.cpp:6846-6860)
    for N spots: look down the light direction, fov = clamp(2 * outer, 25,
    150 degrees), square, far = max(range, near + 0.2)."""
    d = m3.normalize(direction)
    steep = (torch.abs(d[:, 1]) > 0.95).to(torch.float32)
    up = torch.stack([torch.zeros_like(steep), 1.0 - steep, steep], -1)
    view = m3.look_at_lh(pos, pos + d, up)
    fov = torch.clamp(2.0 * outer_angle, _FOV_MIN, _FOV_MAX)
    far = torch.clamp(rng, min=_FAR_MIN)
    return m3.matmul4(_perspective(_tan_half(fov), far), view)


def _point_face_viewprojs(pos, rng):
    """(P * 6, 4, 4) make_point_shadow_face_view_proj (:6824) for P point
    lights: six 90-degree square faces each."""
    p = pos.shape[0]
    dev = pos.device
    dirs = device_const(_FACE_DIRS, dev)
    ups = device_const(_FACE_UPS, dev)
    eye = pos[:, None, :].expand(p, 6, 3)
    view = m3.look_at_lh(eye, eye + dirs[None], ups[None].expand(p, 6, 3))
    far = torch.clamp(rng, min=_FAR_MIN)[:, None].expand(p, 6)
    fov = torch.full_like(far, _FOV_POINT)
    return m3.matmul4(_perspective(_tan_half(fov), far), view).reshape(
        p * 6, 4, 4)


def plan_slot_stacks(lights, spot_ids: tuple, point_ids: tuple):
    """Slot metadata: (kinds, base_slots, caster_pos (K, 3), caster_range
    (K,), strengths (K,), spot_vp (n_spot, 4, 4), point_vp (n_point*6, 4,
    4)).  Shadowed lights in spot-then-point order."""
    dev = lights.position.device
    ids = device_const(list(spot_ids) + list(point_ids), dev, torch.int64)
    sid, pid = ids[:len(spot_ids)], ids[len(spot_ids):]
    kinds = (SHADOW_SPOT_2D,) * len(spot_ids) + (SHADOW_POINT_CUBE,) * len(
        point_ids)
    base_slots = tuple(range(len(spot_ids))) + tuple(
        6 * i for i in range(len(point_ids)))
    spot_vp = (_spot_viewproj(lights.position[sid], lights.direction[sid],
                              lights.outer_angle[sid], lights.range[sid])
               if len(spot_ids) else torch.zeros((0, 4, 4), device=dev))
    point_vp = (_point_face_viewprojs(lights.position[pid], lights.range[pid])
                if len(point_ids) else torch.zeros((0, 4, 4), device=dev))
    strengths = torch.full((len(ids),), _LOCAL_STRENGTH, dtype=torch.float32,
                           device=dev)
    return (kinds, base_slots, lights.position[ids], lights.range[ids],
            strengths, spot_vp, point_vp)


def shadow_index_for_lights(lights, spot_ids, point_ids):
    """(L,) i64: the visibility plane of each light; K = unshadowed."""
    idx = np.full(lights.count, len(spot_ids) + len(point_ids), np.int64)
    for k, lid in enumerate(list(spot_ids) + list(point_ids)):
        idx[lid] = k
    return device_const(idx, lights.type.device, torch.int64)


def _stack_slot_setups(ts: TriSetup, slot_h: int) -> TriSetup:
    """Per-slot setups (leading slot axis) -> ONE tall-target setup: slot s
    takes rows [s * slot_h, (s + 1) * slot_h).  Only the bboxes move to
    global rows; the coefficients stay slot-local (rasterize_direct's
    band_h evaluates rows band-locally).  Each slot is padded to whole
    supers of 256 rows, so no super or chunk mixes two slots."""
    s, n = ts.coef.shape[0], ts.coef.shape[1]
    off = (torch.arange(s, device=ts.bbox.device) * slot_h)[:, None]
    bbox = ts.bbox.clone()
    bbox[..., 1] += off
    bbox[..., 3] += off
    pad = (-n) % _SUPER

    def flat(x, fill=0):
        if pad:
            x = torch.cat([x, torch.full((s, pad) + x.shape[2:], fill,
                                         dtype=x.dtype, device=x.device)], 1)
        return x.reshape((s * (n + pad),) + x.shape[2:])

    return TriSetup(coef=flat(ts.coef), iw=flat(ts.iw), ziw=flat(ts.ziw),
                    bbox=flat(bbox), valid=flat(ts.valid, False),
                    obj_id=flat(ts.obj_id), wp=flat(ts.wp), nw=flat(ts.nw),
                    uv=flat(ts.uv))


def _linearize01(z01, zn, zf):
    """Perspective NDC01 depth -> linear [0, 1] view depth:
    zn * z01 / (zf - z01 * (zf - zn)).  ESM filters linear depth (NDC01
    squeezes the far field below the exp falloff width)."""
    return zn * z01 / (zf - z01 * (zf - zn))


def render_slot_depths(geom, objects, vp_stack, size: int, caster_mask,
                       slot_enabled=None, packed=False):
    """(n, size, size) NDC01 depth of every slot of one stack (the raster
    half of lsr_tpu's _render_slot_stack, :272-381).  slot_enabled (n,)
    bool: a disabled slot's setup lanes are masked, so it stays all far."""
    n = vp_stack.shape[0]
    wmin, wmax = object_world_aabbs(objects)
    sm = caster_mask[None] & frustum_cull_objects(vp_stack, wmin, wmax)

    def raster(st, height, band_h=0):
        d, _, _ = rasterize_direct(st, size, height, 0.0, 1.0,
                                   depth_mode=DEPTH_NDC01, track_ids=False,
                                   tile_h=min(128, size),
                                   tile_w=min(128, size), band_h=band_h)
        return d

    if not packed:
        maps = []
        for s in range(n):
            st = scene_setup_depth(geom.positions, geom.indices,
                                   geom.vtx_obj, geom.tri_obj, objects.model,
                                   vp_stack[s], size, size,
                                   cull_mode=CULL_NONE, obj_visible=sm[s])
            if slot_enabled is not None:
                st = dataclasses.replace(st, valid=st.valid & slot_enabled[s])
            maps.append(raster(st, size))
        return torch.stack(maps)
    ts = scene_setup_slots_depth(geom.positions, geom.indices, geom.vtx_obj,
                                 geom.tri_obj, objects.model, vp_stack, size,
                                 cull_mode=CULL_NONE, obj_visible_slots=sm)
    if slot_enabled is not None:
        ts = dataclasses.replace(ts, valid=ts.valid & slot_enabled[:, None])
    if packed == "hybrid":
        return torch.stack([raster(TriSetup(**{
            f.name: getattr(ts, f.name)[s] for f in dataclasses.fields(ts)}),
            size) for s in range(n)])
    return raster(_stack_slot_setups(ts, size), n * size,
                  band_h=size).reshape(n, size, size)


def _slot_tables(depth, pcf_radius, filter_mode, esm_c, slot_far):
    """(n, S, S) i32 q16 tables: ESM's prefiltered soft map of the
    linearised depth (the far clear 1.0 stays 1.0), or PCF's depth."""
    if filter_mode == "esm":
        lin = _linearize01(depth, _F32(_SHADOW_NEAR), slot_far[:, None, None])
        return quantize_q16(prefilter_esm(lin, pcf_radius, esm_c))
    return quantize_q16(depth)


def render_local_shadow_maps(geom, objects, lights, spot_ids: tuple,
                             point_ids: tuple, map_size: int = 1024,
                             point_size: int | None = None,
                             pcf_radius: int = 1, bias_const: float = 2e-3,
                             bias_slope: float = 6e-3, vis_scale: int = 1,
                             vis_crop: tuple = (), caster_enabled=None,
                             filter_mode: str = "pcf", esm_c: float = 80.0,
                             atlas_packed=False) -> LocalShadowMaps:
    """Render every budgeted local shadow slot and build its table (lsr_tpu
    :453-544).  map_size: spot resolution; point_size: cube-face resolution
    (default map_size).  caster_enabled (K,) bool, spot-then-point order:
    the camera cull of the shadowed lights this frame; a culled light's
    slots stay all far and its plane is 1.0 (it is binned nowhere).
    vis_crop (lsr_tpu's crop cascade for the planes) is accepted and not
    used: the planes are evaluated on the full grid, the same function."""
    if filter_mode not in ("pcf", "esm"):
        raise ValueError(f"render_local_shadow_maps: unknown filter "
                         f"{filter_mode!r}")
    if atlas_packed not in (False, True, "hybrid"):
        raise ValueError(f"render_local_shadow_maps: atlas_packed must be "
                         f"False, True or 'hybrid', got {atlas_packed!r}")
    if point_size is None:
        point_size = map_size
    (kinds, base_slots, caster_pos, caster_range, strengths, spot_vp,
     point_vp) = plan_slot_stacks(lights, spot_ids, point_ids)
    caster_mask = objects.casts_shadow & objects.visible
    n_spot = spot_vp.shape[0]
    spot_en = point_en = None
    if caster_enabled is not None:
        caster_enabled = caster_enabled.to(torch.bool)
        spot_en = caster_enabled[:n_spot]
        point_en = caster_enabled[n_spot:].repeat_interleave(6)
    # Per-slot far planes, the light camera's far: ESM filters linear depth.
    fars = torch.clamp(caster_range, min=_FAR_MIN)

    def stack(vp, size, enabled, far):
        if not vp.shape[0]:
            return None
        depth = render_slot_depths(geom, objects, vp, size, caster_mask,
                                   enabled, atlas_packed)
        return _slot_tables(depth, pcf_radius, filter_mode, esm_c, far)

    return LocalShadowMaps(
        spot_taps=stack(spot_vp, map_size, spot_en, fars[:n_spot]),
        point_taps=stack(point_vp, point_size, point_en,
                         fars[n_spot:].repeat_interleave(6)),
        spot_viewproj=spot_vp.reshape(-1, 16),
        point_viewproj=point_vp.reshape(-1, 16),
        caster_pos=caster_pos, caster_range=caster_range,
        light_shadow_index=shadow_index_for_lights(lights, spot_ids,
                                                   point_ids),
        strength=strengths, bias_const=_F32(bias_const),
        bias_slope=_F32(bias_slope), caster_enabled=caster_enabled,
        spot_size=map_size, point_size=point_size, pcf_radius=pcf_radius,
        kinds=kinds, base_slots=base_slots, vis_scale=vis_scale,
        filter_mode=filter_mode, esm_c=float(esm_c))


# ---------------------------------------------------------------------------
# Sampling: visibility planes
# ---------------------------------------------------------------------------

def _project_rows(vp_rows, wp):
    """Project (..., 3) world points by (..., 16) row-major matrices; each
    row sums left to right.  Returns (x, y, z, w)."""
    x, y, z = wp[..., 0], wp[..., 1], wp[..., 2]

    def row(c):
        return (vp_rows[..., c] * x + vp_rows[..., c + 1] * y
                + vp_rows[..., c + 2] * z + vp_rows[..., c + 3])

    return row(0), row(4), row(8), row(12)


def _bias_ndl(sh: LocalShadowMaps, pos, world_pos, normal):
    """(K, H, W) slope-scaled bias and rel vectors / lengths for caster
    positions pos (K, 3)."""
    rel = world_pos[None] - pos[:, None, None, :]          # (K, H, W, 3)
    rel_len = m3.norm3(rel)
    l_dir = -rel / torch.clamp(rel_len, min=1e-8)[..., None]
    ndl = torch.clamp(m3.dot3(normal[None], l_dir), min=0.0)
    bias = sh.bias_const + sh.bias_slope * (1.0 - torch.clamp(ndl, 0.0, 1.0))
    return rel, rel_len, bias


def _uvz(px, py, pz, pw):
    """NDC01 (u, v, z01) of projected points, w_ok = |w| >= 1e-8."""
    w_ok = torch.abs(pw) >= 1e-8
    w_safe = torch.where(w_ok, pw, torch.ones_like(pw))
    return ((px / w_safe) * 0.5 + 0.5, (py / w_safe) * 0.5 + 0.5,
            (pz / w_safe) * 0.5 + 0.5, w_ok)


def _in_map(u, v, z01, pw, w_ok, in_reach):
    return (w_ok & in_reach & (pw > 0.0) & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (v <= 1.0) & (z01 > 0.0) & (z01 < 1.0))


def _texel(u, v, in_map, size: int):
    """The nearest texel (cx, cy) of in_map pixels (0 elsewhere), i64."""
    def c(t):
        t = torch.where(in_map, t, torch.zeros_like(t))
        return torch.clamp(torch.round(t * (size - 1)), 0, size - 1).to(
            torch.int64)

    return c(u), c(v)


def _sample(sh: LocalShadowMaps, taps, plane, cx, cy, in_map, z01, far,
            bias, strength, size: int):
    """Visibility of K planes from their q16 tables: taps (n, S, S), plane
    (K, H, W) i64 slot of each pixel's sample, texel (cx, cy), NDC01 depth
    z01 and bias (K, H, W), per-plane far and strength (K,).  ESM: one
    fetch of the soft map, on linear depth (_esm_vis); PCF: the
    (2r+1)^2 box of q16 depth tests on clamped texels (_pcf_from_rows)."""
    flat = taps.reshape(-1)
    base = plane * (size * size)
    st = torch.clamp(strength, 0.0, 1.0)[:, None, None]
    if sh.filter_mode == "esm":
        soft = flat[base + cy * size + cx].to(torch.float32) * _F32(1.0 / Q16)
        z_lin = _linearize01(z01, _F32(_SHADOW_NEAR), far[:, None, None])
        lit = esm_visibility(soft, z_lin - bias, sh.esm_c)
        vis = 1.0 + (lit - 1.0) * st
        return torch.where(in_map, vis, torch.ones_like(vis))
    r = sh.pcf_radius
    q = quantize_q16(z01 - bias)
    lit = torch.zeros_like(z01)
    for dy in range(-r, r + 1):
        y = torch.clamp(cy + dy, 0, size - 1) * size
        for dx in range(-r, r + 1):
            x = torch.clamp(cx + dx, 0, size - 1)
            lit = lit + (q <= flat[base + y + x]).to(torch.float32)
    lit = lit / float((2 * r + 1) ** 2)
    vis = 1.0 + (lit - 1.0) * st
    return torch.where(in_map, vis, torch.ones_like(vis))


def _spot_planes(sh: LocalShadowMaps, ks, world_pos, normal):
    """SPOT_2D planes of shadowed lights ks: (len(ks), H, W)
    (_spot_plane_one, :749-797)."""
    dev = world_pos.device
    kt = device_const(ks, dev, torch.int64)
    base = device_const([sh.base_slots[k] for k in ks], dev, torch.int64)
    _, _, bias = _bias_ndl(sh, sh.caster_pos[kt], world_pos, normal)
    vp = sh.spot_viewproj[base][:, None, None, :]
    px, py, pz, pw = _project_rows(vp, world_pos[None])
    u, v, z01, w_ok = _uvz(px, py, pz, pw)
    in_map = _in_map(u, v, z01, pw, w_ok, torch.ones_like(w_ok))
    s = sh.spot_size
    cx, cy = _texel(u, v, in_map, s)
    plane = base[:, None, None].expand_as(cx)
    far = torch.clamp(sh.caster_range[kt], min=_FAR_MIN)
    return _sample(sh, sh.spot_taps, plane, cx, cy, in_map, z01, far, bias,
                   sh.strength[kt], s)


def _point_planes(sh: LocalShadowMaps, ks, world_pos, normal):
    """POINT_CUBE planes of shadowed lights ks: (len(ks), H, W)
    (_point_plane_one, :838-905).  The face is the major axis of the
    light-to-pixel vector; the pixel projects by that face's own
    view-projection."""
    dev = world_pos.device
    kt = device_const(ks, dev, torch.int64)
    base = device_const([sh.base_slots[k] for k in ks], dev, torch.int64)
    rel, rel_len, bias = _bias_ndl(sh, sh.caster_pos[kt], world_pos, normal)
    ax, ay, az = (torch.abs(rel[..., i]) for i in range(3))
    one = torch.ones_like(rel_len, dtype=torch.int64)
    face_x = torch.where(rel[..., 0] >= 0, 0 * one, one)
    face_y = torch.where(rel[..., 1] >= 0, 2 * one, 3 * one)
    face_z = torch.where(rel[..., 2] >= 0, 4 * one, 5 * one)
    face = torch.where((ax >= ay) & (ax >= az), face_x,
                       torch.where(ay >= az, face_y, face_z))
    slot = base[:, None, None] + face
    px, py, pz, pw = _project_rows(sh.point_viewproj[slot], world_pos[None])
    u, v, z01, w_ok = _uvz(px, py, pz, pw)
    rng = sh.caster_range[kt]
    in_reach = (rel_len > 1e-4) & (rel_len < rng[:, None, None])
    in_map = _in_map(u, v, z01, pw, w_ok, in_reach)
    s = sh.point_size
    cx, cy = _texel(u, v, in_map, s)
    return _sample(sh, sh.point_taps, slot, cx, cy, in_map, z01,
                   torch.clamp(rng, min=_FAR_MIN), bias, sh.strength[kt], s)


def _vis_planes(sh: LocalShadowMaps, world_pos, normal):
    """(K + 1, H', W') planes on the vis_scale-strided grid (lsr_tpu's
    _vis_planes_list, :1002-1027): shadowed lights in order, then the
    constant 1.0; a light culled this frame gets 1.0."""
    sc = max(1, int(sh.vis_scale))
    wp, nm = world_pos, normal
    if sc > 1:
        wp, nm = world_pos[::sc, ::sc], normal[::sc, ::sc]
    spot_ks = [k for k in range(sh.n_shadowed)
               if sh.kinds[k] != SHADOW_POINT_CUBE]
    point_ks = [k for k in range(sh.n_shadowed)
                if sh.kinds[k] == SHADOW_POINT_CUBE]
    parts = []
    if spot_ks:
        parts.append(_spot_planes(sh, spot_ks, wp, nm))
    if point_ks:
        parts.append(_point_planes(sh, point_ks, wp, nm))
    ones = torch.ones((1,) + wp.shape[:-1], dtype=torch.float32,
                      device=wp.device)
    # plan_slot_stacks numbers the spots first, so this is plane order.
    planes = torch.cat(parts, 0) if parts else ones[:0]
    if sh.caster_enabled is not None:
        planes = torch.where(sh.caster_enabled[:, None, None], planes,
                             torch.ones_like(planes))
    return torch.cat([planes, ones], 0)


def local_shadow_vis_planes(sh: LocalShadowMaps, world_pos, normal):
    """Plane-major visibility (K + 1, H, W): the form kernel B5 takes.
    With vis_scale > 1 the planes are evaluated every vis_scale-th pixel
    and upsampled bilinearly."""
    planes = _vis_planes(sh, world_pos, normal)
    if max(1, int(sh.vis_scale)) > 1:
        planes = resize_bilinear(planes, (planes.shape[0],)
                                 + tuple(world_pos.shape[:-1]))
    return planes


def local_shadow_vis_stack(sh: LocalShadowMaps, world_pos, normal):
    """Channel-last visibility (H, W, K + 1) (lsr_tpu's
    local_shadow_vis_stack): a view of local_shadow_vis_planes."""
    return local_shadow_vis_planes(sh, world_pos, normal).permute(1, 2, 0)
