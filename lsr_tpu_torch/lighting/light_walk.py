"""Plain models of the light walk that kernels B2, B5 and B6 share
(csrc/light_walk.cuh).

A 32x8 block of the kernels lies inside one light tile and a warp owns an
8x4 pixel rectangle of it.  The walk skips a (light, pixel) pair in three
ways, each of which the plain versions compute as a term of +0:
  - list slots past min(ceil(count / chunk), cap / chunk) * chunk are not
    walked (the plain versions walk the busiest tile's chunks, and a zero
    record adds +0);
  - the box test: a warp keeps a point or spot light only if the box of its
    covered pixels' positions is in range of it (lights_near_box);
  - the vote: a warp shades a light only if one of its pixels passes
    light_reach (shade_kernel.light_live), or the light has an infinite
    color channel, whose 0 * inf term is NaN.
In a sliced walk (B2b's clustered lists) a pixel takes a slice's lights
only in its own slice: the box and the vote count the covered pixels of the
slice, and a light whose gain may be infinite or NaN (finite_gain) is kept
and voted on by every reached pixel, whose gain * 0 is NaN.
walked_pairs is the pairs the kernels evaluate, walk_counts what the walk
meets and what the tests leave of it on a frame.  local_light_skips is the
same rule for kernel G1 (light_runtime.accumulate_local_lights), which
walks every slot of a pixel's list and leaves out the pairs it proves add
+0.  Nothing here runs on a path of the renderer: chip_smoke.py logs
walk_counts and G1's pairs, the tests hold the models against the plain
versions.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import cdiv
from lsr_tpu_torch.lighting import light_runtime as lr
from lsr_tpu_torch.lighting.light_types import (
    LIGHT_RECT_AREA,
    LIGHT_SPOT,
    LIGHT_TUBE_AREA,
)
from lsr_tpu_torch.lighting.shade_kernel import (
    light_live,
    slice_lists,
    tile_planes,
    walk_chunks,
)

WARP = (8, 4)    # a warp of the kernels owns 8x4 (w x h) pixels
BLOCK = (32, 8)  # of its 32x8 block, which lies inside one tile


def rect_any(mask, th, tw, rw, rh):
    """(T, C, th * tw) bool -> (T, C, th / rh, tw / rw): any pixel of each
    rw x rh pixel rectangle of the tile."""
    t, c, _ = mask.shape
    return mask.view(t, c, th // rh, rh, tw // rw, rw).any(5).any(3)


def _warp_pixels(m, th, tw):
    """(T, C, th / 4, tw / 8) per warp rectangle -> (T, C, th * tw)."""
    (rw, rh), (t, c) = WARP, m.shape[:2]
    return m[:, :, :, None, :, None].expand(
        t, c, th // rh, rh, tw // rw, rw).reshape(t, c, th * tw)


def infinite_color(blk):
    """(T, chunk) bool: a clamped color channel of the record is infinite."""
    return ~(torch.clamp(blk[..., 13:16], min=0.0) < float("inf")).all(-1)


def finite_gain(blk):
    """(T, chunk) bool: the light's gain is finite (|intensity| <= 1e38; the
    gain is at most 1.21 * |intensity|), so gain * 0 is a zero."""
    return blk[..., 16].abs() <= 1e38


def lights_near_box(blk, px, py, pz, covered, th, tw):
    """(T, chunk, th / 4, tw / 8) bool: plain model of the walk's box test
    (warp_box and light_near_box in csrc/light_walk.cuh).  Each warp boxes
    the world positions of its covered 8x4 pixels and keeps a point or spot
    light only if the box's nearest point is in range, in the operation
    order of the per-pixel distance, so that it never drops a light that is
    in range of a pixel; rect and tube lights and lights with an infinite
    color channel are always kept."""
    (rw, rh), inf = WARP, float("inf")
    t = px.shape[0]
    ok = covered & ~(torch.isnan(px) | torch.isnan(py) | torch.isnan(pz))

    def bounds(p):
        v = p.view(t, 1, th // rh, rh, tw // rw, rw)
        m = ok.view_as(v)
        return (torch.where(m, v, inf).amin((3, 5)),
                torch.where(m, v, -inf).amax((3, 5)))

    def gap(e, lo, hi):
        e = e[..., None]                                    # (T, chunk, 1, 1)
        return torch.where(e < lo, e - lo,
                           torch.where(e > hi, e - hi, torch.zeros_like(lo)))

    tx, ty, tz = (gap(blk[..., 1 + i:2 + i], *bounds(p))
                  for i, p in enumerate((px, py, pz)))
    dist = torch.sqrt(torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-16))
    near = dist < torch.clamp(blk[..., 17], min=0.001)[..., None, None]
    ltype = blk[..., 0]
    always = (ltype == 3.0) | (ltype == 4.0) | infinite_color(blk)
    return near | always[..., None, None]


def walk_box(blk, px, py, pz, covered, th, tw, in_slice=None):
    """lights_near_box as a walk applies it: in a sliced walk (in_slice (T,
    1, th * tw)) the box of the slice's covered pixels, and a light of
    non-finite gain kept by every warp."""
    if in_slice is None:
        return lights_near_box(blk, px, py, pz, covered, th, tw)
    return (lights_near_box(blk, px, py, pz, covered & in_slice, th, tw)
            | ~finite_gain(blk)[..., None, None])


def walked_pairs(blk, px, py, pz, covered, reach, listed, th, tw,
                 in_slice=None):
    """(T, chunk, th * tw) bool: the (light, pixel) pairs whose terms the
    kernels compute, for one chunk of every tile's list (blk (T, chunk,
    32)) on the tile planes (T, 1, th * tw).  reach: light_live's verdict
    on the same pairs; listed (T, chunk): the slot lies within the tile's
    walk.  A pair is walked when its slot is listed, its warp's box test
    keeps the light and the warp's vote shades it (a pixel of the warp is
    reached, or the light's color is infinite).  A warp without a covered
    pixel thereby walks only lights of infinite color, as the kernels do.
    in_slice (T, 1, th * tw) bool: a sliced walk, whose box and vote count
    only the pixels of the list's slice, but keep a light of non-finite
    gain for every reached pixel.  Every other pair the kernels take as
    the +0 the plain versions add."""
    near = walk_box(blk, px, py, pz, covered, th, tw, in_slice)
    if in_slice is not None:
        reach = reach & (in_slice | ~finite_gain(blk)[..., None])
    vote = (rect_any(reach, th, tw, *WARP)
            | infinite_color(blk)[..., None, None])
    return _warp_pixels(near & vote & listed[..., None, None], th, tw)


def n_listed(counts, cap, chunk):
    """(T,) int64: the slots each tile walks, min(ceil(count / chunk), cap /
    chunk) chunks."""
    return torch.clamp((counts.to(torch.int64) + chunk - 1) // chunk,
                       max=cap // chunk) * chunk


def listed_slots(counts, cap, chunk, ci):
    """(T, chunk) bool: the slots of chunk ci that each tile's walk
    reaches."""
    slots = ci * chunk + torch.arange(chunk, device=counts.device)
    return slots[None] < n_listed(counts, cap, chunk)[:, None]


def walk_counts(px, py, pz, nx, ny, nz, cov, tile_rec, counts, th, tw, chunk,
                kinds, n_shadowed=0, in_slice=None):
    """What the light walk meets on one launch, counted with the plain
    models on the kernel's own inputs as (T, 1, th * tw) tile planes: the
    (pixel, listed light) pairs of the padded frame (every chunk of each
    tile's walk, zero records included), the (covered pixel, binned light)
    pairs, the live pairs (light_live) and those of them whose light has a
    local-shadow plane (record lane 28 below n_shadowed: the plane texels
    the launch must read), per 8x4 warp rectangle, 32x1 pixel
    row and 32x8 block the lights with at least one live pixel (what a vote
    over that footprint keeps), the lights the warp's box test keeps
    (lights_near_box), and the pairs the kernels evaluate after both tests
    (walked_pairs).  in_slice (T, 1, th * tw): the lists of one slice of a
    sliced walk, whose pixels alone are counted as covered."""
    cap = tile_rec.shape[1]
    n64 = counts.to(torch.int64)
    walked = n_listed(counts, cap, chunk)
    live_cov = cov if in_slice is None else cov & in_slice
    rects = {"warp": WARP, "row": (32, 1), "block": BLOCK}
    kept = {k: 0 for k in rects}
    near = shaded = live_pairs = live_shadowed = 0
    for ci, blk in enumerate(walk_chunks(tile_rec, counts, chunk)):
        reach = light_live(blk, px, py, pz, nx, ny, nz, cov, kinds)
        live = reach if in_slice is None else reach & in_slice
        live_pairs += int(live.sum())
        live_shadowed += int((live & (blk[..., 28] < n_shadowed)[..., None])
                             .sum())
        for k, (rw, rh) in rects.items():
            kept[k] = kept[k] + rect_any(live, th, tw, rw, rh).sum(1)
        listed = listed_slots(counts, cap, chunk, ci)
        near = near + (walk_box(blk, px, py, pz, cov, th, tw, in_slice)
                       & listed[..., None, None]).sum(1)
        shaded += int(walked_pairs(blk, px, py, pz, cov, reach, listed, th,
                                   tw, in_slice).sum())
    out = {"pairs_walked": int((walked * th * tw).sum()),
           "pairs_binned": int((torch.clamp(n64, max=cap)
                                * live_cov.sum((1, 2))).sum()),
           "pairs_live": live_pairs,
           "pairs_live_shadowed": live_shadowed,
           "lights_listed_per_block_mean": float(
               walked.to(torch.float64).mean())}
    for k, (rw, rh) in rects.items():
        c = torch.as_tensor(kept[k], dtype=torch.float64)  # 0: no chunk
        out[f"lights_live_per_{k}_mean"] = float(c.mean())
        out[f"lights_live_per_{k}_max"] = int(c.max())
        out[f"pairs_after_{k}_vote"] = int(c.sum()) * rw * rh
    near = torch.as_tensor(near, dtype=torch.float64)
    out["lights_near_per_warp_mean"] = float(near.mean())
    out["pairs_after_warp_box"] = int(near.sum()) * 32
    out["pairs_after_box_and_vote"] = shaded
    return out


def gbuf_walk_counts(gbuf, tile_rec, counts, th, tw, chunk, kinds,
                     n_shadowed=0, slices=0):
    """walk_counts of a B2 or B6 launch: gbuf (C, ph, pw) G-buffer planes
    with world position in 0:3, the normal in 3:6 and coverage in 6.
    slices > 0 (B2b): clustered records, each pixel's slice in plane 13;
    the counts of the slices' walks are summed (the means then count the
    (slice, light) pairs of a block or warp over the whole walk; the
    per-footprint maxima are left out)."""
    ph, pw = gbuf.shape[1:]
    g = tile_planes(gbuf[:14 if slices else 7], th, tw, ph // th, pw // tw)
    args = (g[0], g[1], g[2], g[3], g[4], g[5], g[6] > 0.0)
    if not slices:
        return walk_counts(*args, tile_rec, counts, th, tw, chunk, kinds,
                           n_shadowed)
    out: dict = {}
    for sl, rec, cnt in slice_lists(tile_rec, counts, slices):
        part = walk_counts(*args, rec, cnt, th, tw, chunk, kinds, n_shadowed,
                           in_slice=g[13] == float(sl))
        for k, v in part.items():
            if not k.endswith("_max"):
                out[k] = out.get(k, 0) + v
    return out


def walk_plan(counts, cap, chunk, slices=0):
    """[(slice, chunk index)] in the order the plain versions walk them:
    per slice (None for tiled lists) the busiest list's min(ceil(count /
    chunk), cap / chunk) chunks, as walk_chunks."""
    per_slice = counts.reshape(-1, max(slices, 1))
    plan = []
    for j in range(per_slice.shape[1]):
        n = min(cdiv(int(per_slice[:, j].max()), chunk), cap // chunk)
        plan += [(j if slices else None, ci) for ci in range(n)]
    return plan


def walked_terms(light_terms, counts, cap, chunk, th, tw, slices=0):
    """light_terms as the kernels' walk leaves it: a function with
    light_terms' arguments for the chunks of the plain versions' walk, one
    call a chunk in order, whose colors, wd and ws are +0 wherever
    walked_pairs says the kernels skip the pair, so that each skipped term
    color * wd, color * ws enters the sums as +0.  cap is the cap of one
    list; slices > 0: clustered counts (tiles * slices,), walked slice by
    slice.  The tests run the plain versions with it in place of
    light_terms and hold them to themselves bit for bit.  Its `pairs`
    attribute counts the (listed, walked) pairs of covered pixels (of the
    list's slice, when sliced)."""
    plan = walk_plan(counts, cap, chunk, slices)
    per_slice = counts.reshape(-1, max(slices, 1))

    def terms(blk, px, py, pz, nx, ny, nz, vx, vy, vz, covered, apow1, kinds,
              lvis=None, in_slice=None):
        cols, wd, ws, reach = light_terms(
            blk, px, py, pz, nx, ny, nz, vx, vy, vz, covered, apow1, kinds,
            want_reach=True, lvis=lvis, in_slice=in_slice)
        sl, ci = plan[terms.chunks]
        cnt = counts if sl is None else per_slice[:, sl]
        listed = listed_slots(cnt, cap, chunk, ci)
        keep = walked_pairs(blk, px, py, pz, covered, reach, listed, th, tw,
                            in_slice)
        terms.chunks += 1
        cov = covered if in_slice is None else covered & in_slice
        cov = cov.expand_as(keep)
        terms.pairs[0] += int((listed[..., None] & cov).sum())
        terms.pairs[1] += int((keep & cov).sum())
        zero = torch.zeros_like(wd)
        return ([torch.where(keep, c, zero) for c in cols],
                torch.where(keep, wd, zero), torch.where(keep, ws, zero))

    terms.chunks, terms.pairs = 0, [0, 0]
    return terms


def local_light_skips(lights_g, world_pos, normal):
    """The (pixel, light) pairs kernel G1 leaves out of its sums, modelled on
    eval_local_lights' inputs (the same operations, so the same values):
    (skip (..., K) bool, bounded (..., K) bool).  A pair is bounded when
    the pixel's position lies within 1e6, its normal within 2 and every
    light column within 1e6 (G1 also asks it of the camera and of the
    pixel's planes); a bounded pair is left out when its radiance is 0 or
    it is not live (at the emitter, out of range, facing away, outside a
    spot's cone, behind a rect, attenuated to 0).  G1 also leaves out a
    bounded pair whose local-shadow plane reads 0, which this model of the
    unshadowed terms does not see."""
    p = world_pos[..., None, :]
    n = normal[..., None, :]
    ltype = lights_g["type"]
    pos = lights_g["position"]
    fwd = lr._norm(lights_g["direction"])
    axis = lr._norm(lights_g["axis"])
    up_hint = lr._norm(lights_g["up"])
    right = lr._norm(torch.linalg.cross(up_hint, fwd))
    up = lr._norm(torch.linalg.cross(fwd, right))
    right = lr._norm(torch.linalg.cross(up, fwd))
    dvec = p - pos
    he = torch.clamp(lights_g["rect_half_extents"], min=0.05)
    ux = torch.clamp((dvec * right).sum(-1, keepdim=True), -he[..., :1],
                     he[..., :1])
    uy = torch.clamp((dvec * up).sum(-1, keepdim=True), -he[..., 1:2],
                     he[..., 1:2])
    half_len = torch.clamp(lights_g["tube_half_length"], min=0.1)[..., None]
    a = pos - axis * half_len
    ab = axis * (2.0 * half_len)
    denom = torch.clamp((ab * ab).sum(-1, keepdim=True), min=1e-8)
    t = torch.clamp(((p - a) * ab).sum(-1, keepdim=True) / denom, 0.0, 1.0)
    is_rect = (ltype == LIGHT_RECT_AREA)[..., None]
    is_tube = (ltype == LIGHT_TUBE_AREA)[..., None]
    emit = torch.where(is_rect, pos + right * ux + up * uy,
                       torch.where(is_tube, a + ab * t, pos))
    to_light = emit - p
    dist = torch.sqrt((to_light * to_light).sum(-1))
    l_dir = to_light / torch.clamp(dist, min=1e-8)[..., None]
    inner = torch.clamp(lights_g["inner_angle"], 0.02, lr._HALF_PI - 0.02)
    lo = inner + 0.005
    outer = torch.minimum(
        torch.maximum(torch.maximum(lo, lights_g["outer_angle"]), lo),
        torch.full_like(lo, lr._HALF_PI - 0.005))
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
    shaping = torch.where(
        ltype == LIGHT_SPOT, spot_shape,
        torch.where(ltype == LIGHT_RECT_AREA, rect_shape,
                    torch.where(ltype == LIGHT_TUBE_AREA, 0.75 + 0.35 * soft,
                                torch.ones_like(soft))))
    ndl = torch.clamp((n * l_dir).sum(-1), min=0.0)
    atten = lr.eval_distance_attenuation(
        dist, lights_g["range"], lights_g["atten_model"],
        lights_g["atten_power"], lights_g["atten_bias"],
        lights_g["atten_cutoff"]) * torch.clamp(shaping, min=0.0)
    live = (dist > 1e-4) & (ndl > 0.0) & (atten > 0.0)
    no_radiance = ((torch.clamp(lights_g["color"], min=0.0)
                    * torch.clamp(lights_g["intensity"], min=0.0)[..., None])
                   == 0.0).all(-1)
    light_ok = torch.ones_like(live)
    for name in lr._COLUMNS:
        col = lights_g[name].to(torch.float32)
        if col.ndim > ltype.ndim:
            col = col.abs().amax(-1)
        light_ok = light_ok & (col.abs() <= lr.SKIP_BOUND)
    pix_ok = ((world_pos.abs() <= lr.SKIP_BOUND).all(-1)
              & (normal.abs() <= lr.SKIP_NORMAL_BOUND).all(-1))
    bounded = light_ok & pix_ok[..., None]
    return bounded & (no_radiance | ~live), bounded
