"""Multi-device meshes and sharded render steps (port of
lsr_tpu/parallel/sharding.py).

lsr_tpu's axes, kept here:
- dp: independent cameras per rank;
- sp: horizontal framebuffer bands per rank; geometry is replicated and
  each rank rasterizes only its band (rasterize_direct's y_offset /
  full_height, kernel variant B1b), the image is the bands' concatenation;
- lp: the light set sharded, partial light sums added with psum;
- pp: a two-stage pipeline over a stream of cameras.

lsr_tpu is single-controller: one process, a jax Mesh, a shard_map'ed
function per rank and lax collectives inside it.  The port keeps that
model.  A Mesh is an array of torch devices shaped by its axes; a step
runs each rank's work in rank order, on that rank's device, and splits it
at each collective (parallel/collectives.py: all_gather, ppermute, psum over
per-rank lists).  Every tensor a rank reads is a copy on its device, made
once when the step is built, and so is everything a step would otherwise
read on the host (the shadow slots' plan).  Nothing here uses
torch.distributed.

One program a step, as lsr_tpu returns jax.jit(step) (sharding.py:320,
:368, :500, :614): where every rank of the mesh lies on one device (all
ranks on one card, devices=[torch.device("cuda", 0)] * n, or the CPU),
each make_* returns utils.jit.jit(step): on the card the whole step, every
rank's work in rank order with its collectives (and for pp the whole
camera stream), is captured once into a CUDA graph and replayed; zn / zf
and the cameras are data, so its key is only shapes (the stream length
among them).  CPU inputs run the step eagerly, as jit does; a capture
that fails raises CaptureError, never an eager step in its place.  The
undecorated step is the Jitted's .fn.  A mesh whose ranks lie on more
than one CUDA device keeps the eager step, decided from the mesh when the
step is built: a CUDA graph captures one device's stream, so per-card
graphs with device-side collectives wait for a multi-GPU cell.  There a
rank's launches are enqueued on its card while the host goes on to the
next rank, so the cards' work overlaps as far as the host's enqueueing
lets it, and the host waits only where a collective copies between cards.

Outputs come back assembled on rank (0, 0)'s device in lsr_tpu's layout:
(B, H, W, 3) u8 for dp x sp, (H, W, 3) for lp, (N, H, W, 3) for pp.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsr_tpu_torch.camera.light_camera import build_dir_light_camera
from lsr_tpu_torch.core.util import cdiv, device_const
from lsr_tpu_torch.geometry.occlusion import (
    occlusion_cull_aabbs,
    render_occluder_depth,
)
from lsr_tpu_torch.geometry.volumes import frustum_cull_objects
from lsr_tpu_torch.lighting.light_culling import cull_lights_tiled
from lsr_tpu_torch.lighting.light_runtime import accumulate_local_lights
from lsr_tpu_torch.lighting.local_shadows import (
    LocalShadowMaps,
    _slot_tables,
    local_shadow_vis_stack,
    plan_shadow_casters,
    plan_slot_stacks,
    render_slot_depths,
    shadow_index_for_lights,
)
from lsr_tpu_torch.lighting.shadow_sample import make_shadow_context
from lsr_tpu_torch.parallel.collectives import all_gather, ppermute, psum
from lsr_tpu_torch.passes.post import fxaa_pass
from lsr_tpu_torch.passes.tonemap import tonemap_pass
from lsr_tpu_torch.raster.brute import rasterize_brute
from lsr_tpu_torch.raster.interp import GBuffer, interpolate_gbuffer
from lsr_tpu_torch.raster.setup import (
    CULL_NONE,
    DEPTH_NDC01,
    scene_setup,
    scene_setup_depth,
)
from lsr_tpu_torch.raster.tiled import rasterize_direct
from lsr_tpu_torch.scene.scene import object_world_aabbs, shadow_caster_aabb
from lsr_tpu_torch.shading.common import gather_materials
from lsr_tpu_torch.shading.models import (
    SHADING_MODELS,
    _norm,
    composite_over_background,
)
from lsr_tpu_torch.utils.jit import jit

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out by named axes: devices[i, j] is rank (i, j)."""

    devices: np.ndarray      # object array of torch.device
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax's Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))


def _mesh(name, devices, n_devices, shape, axis_names):
    """devices (None: the visible CUDA devices) -> Mesh of `shape`."""
    need = int(np.prod(shape))
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())][:n_devices]
    dims = " x ".join(f"{a}={s}" for a, s in zip(axis_names, shape))
    if len(devices) < need:
        raise ValueError(
            f"{name} needs {need} devices ({dims}) but only {len(devices)} "
            f"are visible.  To run {need} ranks on one card, pass devices="
            f"[torch.device('cuda', 0)] * {need}; on the CPU, devices="
            f"[torch.device('cpu')] * {need}.")
    arr = np.empty(need, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:need]]
    return Mesh(arr.reshape(shape), tuple(axis_names))


def make_mesh(n_devices: int, dp: int | None = None, devices=None) -> Mesh:
    """A ("dp", "sp") mesh over the first n devices."""
    if dp is None:
        dp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    sp = n_devices // dp
    return _mesh("make_mesh", devices, n_devices, (dp, sp), ("dp", "sp"))


def make_mesh_lp(n_devices: int, sp: int | None = None,
                 lp: int | None = None, devices=None) -> Mesh:
    """A ("sp", "lp") mesh: framebuffer row bands x light shards."""
    if lp is None:
        lp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    if sp is None:
        sp = n_devices // lp
    return _mesh("make_mesh_lp", devices, n_devices, (sp, lp), ("sp", "lp"))


def make_mesh_pp(n_devices: int = 2, devices=None) -> Mesh:
    """A one-axis ("pp",) mesh for pipeline parallelism (2 stages)."""
    return _mesh("make_mesh_pp", devices, n_devices, (n_devices,), ("pp",))


def replicate(x, device):
    """x, a tensor or a dataclass / tuple / list / dict of them, with every
    tensor on `device` (the same object where nothing moves)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: replicate(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (tuple, list)):
        return type(x)(replicate(v, device) for v in x)
    if isinstance(x, dict):
        return {k: replicate(v, device) for k, v in x.items()}
    return x


def _replicas(mesh: Mesh, state) -> dict:
    """{device: state on it} for the mesh's devices: a step's closed-over
    state, copied once per device."""
    return {d: replicate(state, d) for d in dict.fromkeys(mesh.devices.flat)}


def _program(mesh: Mesh, step, name: str):
    """step as one program (utils.jit) when every rank of the mesh lies on
    one device; the eager step when they span several CUDA devices."""
    if len(set(mesh.devices.flat)) == 1:
        return jit(step, name)
    return step


def _band_lists(lists, tiles_x: int, row0: int, rows: int):
    """Tile rows [row0, row0 + rows) of full-frame tile lists (tiles, cap)."""
    return lists.reshape(-1, tiles_x, lists.shape[-1])[
        row0:row0 + rows].reshape(rows * tiles_x, -1)


def render_band(geom, objects, viewproj, zn, zf, shade_ctx, width: int,
                height: int, band_h: int, y_offset: int,
                model_name: str = "blinn_phong",
                background=(0.04, 0.06, 0.1), cap: int = 512,
                use_tiled: bool = True):
    """Global rows [y_offset, y_offset + band_h) of a (height, width) frame:
    setup -> raster of the band -> G-buffer at the band's rows -> shading
    model -> background -> tonemap.  (band_h, width, 3) u8 on the
    geometry's device.  use_tiled=False rasterizes with rasterize_brute at
    the band's global rows (lsr_tpu rasterizes the whole frame and slices
    it: the same values).  cap is lsr_tpu's and unused, as there."""
    setup = scene_setup(
        geom.positions, geom.normals, geom.uvs, geom.indices, geom.vtx_obj,
        geom.tri_obj, objects.model, objects.normal_mat, viewproj, width,
        height, obj_visible=objects.visible)
    if use_tiled:
        depth, tid, _ = rasterize_direct(setup, width, band_h, zn, zf,
                                         y_offset=y_offset,
                                         full_height=height)
    else:
        depth, tid = rasterize_brute(setup, width, band_h, zn, zf,
                                     y_offset=y_offset, full_height=height)
    gb = interpolate_gbuffer(setup, depth, tid, y_offset=y_offset)
    shaded = SHADING_MODELS[model_name](gb, shade_ctx)
    bg = device_const(background, shaded.device).expand(shaded.shape)
    return tonemap_pass(composite_over_background(shaded, gb, bg))


def _check_cameras(b: int, dp: int):
    if b % dp:
        raise ValueError(f"{b} cameras do not split over dp={dp}")
    return b // dp


def make_sharded_render(mesh: Mesh, geom, objects, shade_ctx, width: int,
                        height: int, model_name: str = "blinn_phong",
                        cap: int = 512):
    """step(viewprojs (B, 4, 4), zn, zf) -> (B, height, width, 3) u8 on rank
    (0, 0)'s device.  Rank (d, s) renders band s of the cameras of dp slice
    d (B / dp of them) with render_band; no collective.  One program on a
    one-device mesh (see the module docstring)."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    assert height % sp == 0, "height must divide by sp bands"
    band_h = height // sp
    reps = _replicas(mesh, (geom, objects, shade_ctx))

    def step(viewprojs, zn, zf):
        per = _check_cameras(viewprojs.shape[0], dp)
        out = []
        for d in range(dp):
            bands = []
            for s in range(sp):
                dev = mesh.devices[d, s]
                g, o, ctx = reps[dev]
                vps = viewprojs[d * per:(d + 1) * per].to(dev)
                bands.append([render_band(g, o, vp, zn, zf, ctx,
                                          width, height, band_h, s * band_h,
                                          model_name=model_name, cap=cap)
                              for vp in vps])
            out += _assemble(bands, mesh.devices[0, 0])
        return torch.stack(out)

    return _program(mesh, step, "sharded_render")


def _assemble(bands, device):
    """bands[s][b] (band rows of camera b on rank s) -> per camera the
    whole frame on `device`."""
    return [torch.cat([bands[s][b].to(device) for s in range(len(bands))])
            for b in range(len(bands[0]))]


def _slot_taps(geom, objects, vp_loc, n_real, size, caster_mask):
    """One rank's slice of a local slot stack: (per, size, size) PCF
    tables (local_shadows._slot_tables).  Slots past the stack's end (zero view-projections, padding to
    whole slices) are masked and stay all far; they are dropped after the
    gather, as lsr_tpu drops them."""
    en = torch.arange(vp_loc.shape[0], device=vp_loc.device) < n_real
    depth = render_slot_depths(geom, objects, vp_loc, size, caster_mask,
                               slot_enabled=en)
    return _slot_tables(depth, 2, "pcf", 80.0, None)


def make_sharded_flagship(mesh: Mesh, geom, objects, shade_ctx, lights,
                          width: int, height: int, shadow_size: int = 256,
                          tile_size: int = 16, model_name: str = "pbr_mr",
                          local_map: int = 128, local_point: int = 64,
                          with_local: bool = True, with_cull: bool = True):
    """The flagship frame (per-frame cull + sun shadow + local shadow atlas
    + forward+ + tonemap + FXAA) sharded over a ("dp", "sp") mesh, as
    lsr_tpu composes it (sharding.py:83-330):

    - the local atlas (the 8-spot + 2-point budget of plan_shadow_casters)
      shards its SLOTS over sp: each rank renders its slice of each stack
      (one B1 launch a slot, zero view-projections padding the last
      slice) and an all_gather over sp assembles the q16 PCF tables;
    - the sun map (shadow_size^2, PCF radius 2) is rendered in sp row
      bands (B1b, depth only) and assembled with an all_gather over sp;
    - the scene cull (frustum + occluders at a quarter of the resolution)
      runs per camera on every rank of the camera's dp slice;
    - each rank rasterizes its band of rows (B1b), interpolates it, shades
      the sun with the shading model, sums the local lights with
      accumulate_local_lights on the band's rows of the full-frame tile
      lists (cap 64), composites and tonemaps;
    - FXAA takes one-row halos from the band's neighbours with ppermute
      (the frame's top and bottom rows clamp), so any mesh gives the (1, 1)
      mesh's frame bit for bit.

    step(viewprojs (B, 4, 4), views (B, 4, 4), proj (4, 4), zn, zf,
    sun_dir (3,)) -> (B, height, width, 3) u8 on rank (0, 0)'s device, B a
    multiple of dp.  Kernel B1 launches per step: on each of the dp * sp
    ranks, cdiv(n_spot, sp) + cdiv(n_point_faces, sp) slots and one sun
    band; per camera and rank, one occluder raster (with_cull) and one
    camera band.  The shadow slots are planned once here (lsr_tpu plans
    them statically); the step is one program on a one-device mesh (see
    the module docstring)."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    assert height % sp == 0 and (height // sp) % tile_size == 0, (
        "height must split into sp bands of whole light tiles")
    assert shadow_size % sp == 0
    band_h = height // sp
    sm_band_h = shadow_size // sp
    tiles_x = cdiv(width, tile_size)
    band_tiles_y = band_h // tile_size
    spot_ids, point_ids = (plan_shadow_casters(lights) if with_local
                           else ((), ()))
    reps = _replicas(mesh, (geom, objects, shade_ctx, lights))

    def stacks(lt):
        """The LocalShadowMaps fields of the shadowed lights but their
        taps, as a dict (view-projections (n, 4, 4)); None without
        shadowed lights."""
        if not (spot_ids or point_ids):
            return None
        (kinds, base_slots, c_pos, c_rng, strengths, spot_vp,
         point_vp) = plan_slot_stacks(lt, spot_ids, point_ids)
        return dict(
            spot_viewproj=spot_vp, point_viewproj=point_vp,
            caster_pos=c_pos, caster_range=c_rng,
            light_shadow_index=shadow_index_for_lights(lt, spot_ids,
                                                       point_ids),
            strength=strengths, kinds=tuple(kinds),
            base_slots=tuple(base_slots))

    # The slots' plan per device, once: the lights are the step's state.
    plans = {dev: stacks(rep[3]) for dev, rep in reps.items()}

    def slice_of(vp_stack, s):
        """Rank s's slice of a stack, padded with zero view-projections:
        (view-projections (per, 4, 4), real slots in it)."""
        n = vp_stack.shape[0]
        per = cdiv(n, sp)
        pad = torch.zeros((per * sp - n, 4, 4), dtype=vp_stack.dtype,
                          device=vp_stack.device)
        vp_pad = torch.cat([vp_stack, pad])
        return vp_pad[s * per:(s + 1) * per], max(0, min(per, n - s * per))

    def rank_maps(dev, s, sun_dir):
        """Rank s's slot slices and sun band (before the gathers)."""
        g, o, _, lt = reps[dev]
        caster_mask = o.casts_shadow & o.visible
        parts = {}
        plan = plans[dev]
        if plan is not None:
            for key, vp, size in (("spot", plan["spot_viewproj"], local_map),
                                  ("point", plan["point_viewproj"],
                                   local_point)):
                if vp.shape[0]:
                    vp_loc, n_loc = slice_of(vp, s)
                    parts[key] = _slot_taps(g, o, vp_loc, n_loc, size,
                                            caster_mask)
        smin, smax = shadow_caster_aabb(o)
        _, _, light_vp = build_dir_light_camera(smin, smax, sun_dir.to(dev),
                                                shadow_size)
        sm_setup = scene_setup_depth(
            g.positions, g.indices, g.vtx_obj, g.tri_obj, o.model, light_vp,
            shadow_size, shadow_size, cull_mode=CULL_NONE,
            obj_visible=caster_mask)
        # Unsorted, as lsr_tpu's SORT_DEPTH_SETUP (tiled.py:236) has it;
        # depth is the same either way.
        parts["sun"], _, _ = rasterize_direct(
            sm_setup, shadow_size, sm_band_h, 0.0, 1.0,
            depth_mode=DEPTH_NDC01, track_ids=False, y_offset=s * sm_band_h,
            full_height=shadow_size)
        return parts, light_vp, plan

    def rank_ldr(dev, s, vp, view, proj, zn, zf, ctx_sh, local_sh):
        """Rank s's band of one camera, tonemapped (before FXAA)."""
        g, o, _, lt = reps[dev]
        y0 = s * band_h
        view_mask = o.visible
        if with_cull:
            wmin, wmax = object_world_aabbs(o)
            view_mask = view_mask & frustum_cull_objects(vp, wmin, wmax)
            occ = render_occluder_depth(
                g, o, vp, zn, zf, max(tile_size, width // 4),
                max(tile_size, height // 4), occluder_mask=view_mask)
            view_mask = view_mask & occlusion_cull_aabbs(occ, vp, wmin, wmax,
                                                         zn, zf)
        setup = scene_setup(
            g.positions, g.normals, g.uvs, g.indices, g.vtx_obj, g.tri_obj,
            o.model, o.normal_mat, vp, width, height, obj_visible=view_mask)
        depth, tid, _ = rasterize_direct(setup, width, band_h, zn, zf,
                                         y_offset=y0, full_height=height)
        gb = interpolate_gbuffer(setup, depth, tid, y_offset=y0,
                                 materials=ctx_sh.materials)
        base = SHADING_MODELS[model_name](gb, ctx_sh)
        # Full-frame tile lists (the unsharded culling), the band's rows.
        lists, _, _ = cull_lights_tiled(lt, view, proj, width, height,
                                        tile_size=tile_size, cap=64)
        band_lists = _band_lists(lists, tiles_x, s * band_tiles_y,
                                 band_tiles_y)
        vis_stack = shadow_idx = None
        if local_sh is not None:
            vis_stack = local_shadow_vis_stack(local_sh, gb.world_pos,
                                               _norm(gb.normal_ws))
            shadow_idx = local_sh.light_shadow_index
        diff, spec = accumulate_local_lights(
            gb.world_pos, gb.normal_ws, ctx_sh.camera_pos, lt, band_lists,
            width, band_h, tile_size=tile_size, shadow_vis_stack=vis_stack,
            light_shadow_index=shadow_idx)
        albedo = gather_materials(ctx_sh.materials, gb.obj_id,
                                  mat_rec=gb.mat)[0]
        hdr = base + torch.clamp(albedo, min=0.0) * diff + spec
        bg = device_const((0.04, 0.06, 0.1), dev).expand(hdr.shape)
        return tonemap_pass(composite_over_background(hdr, gb, bg))

    def step(viewprojs, views, proj, zn, zf, sun_dir):
        per = _check_cameras(viewprojs.shape[0], dp)
        frames = []
        for d in range(dp):
            devs = list(mesh.devices[d])
            # The slot slices and sun bands, then their gathers over sp.
            maps = [rank_maps(devs[s], s, sun_dir) for s in range(sp)]
            gathered = {k: all_gather([m[0][k] for m in maps], devs)
                        for k in maps[0][0]}
            ctxs, locals_ = [], []
            for s, dev in enumerate(devs):
                _, light_vp, plan = maps[s]
                shadow = make_shadow_context(gathered["sun"][s], light_vp,
                                             pcf_radius=2)
                ctxs.append(dataclasses.replace(reps[dev][2], shadow=shadow))
                local_sh = None
                if plan is not None:
                    n_spot = plan["spot_viewproj"].shape[0]
                    n_point = plan["point_viewproj"].shape[0]
                    local_sh = LocalShadowMaps(
                        spot_taps=(gathered["spot"][s][:n_spot]
                                   if n_spot else None),
                        point_taps=(gathered["point"][s][:n_point]
                                    if n_point else None),
                        spot_viewproj=plan["spot_viewproj"].reshape(-1, 16),
                        point_viewproj=plan["point_viewproj"].reshape(-1, 16),
                        caster_pos=plan["caster_pos"],
                        caster_range=plan["caster_range"],
                        light_shadow_index=plan["light_shadow_index"],
                        strength=plan["strength"],
                        bias_const=float(np.float32(2e-3)),
                        bias_slope=float(np.float32(6e-3)),
                        spot_size=local_map, point_size=local_point,
                        # lsr_tpu samples locals at the sun's PCF radius 2.
                        pcf_radius=2, kinds=plan["kinds"],
                        base_slots=plan["base_slots"])
                locals_.append(local_sh)
            # The bands of each camera, then FXAA with ppermute halos.
            ldr = [[rank_ldr(dev, s, vp.to(dev), view.to(dev), proj.to(dev),
                             zn, zf, ctxs[s], locals_[s])
                    for vp, view in zip(viewprojs[d * per:(d + 1) * per],
                                        views[d * per:(d + 1) * per])]
                   for s, dev in enumerate(devs)]
            out = [[None] * per for _ in range(sp)]
            for b in range(per):
                bands = [ldr[s][b] for s in range(sp)]
                up = ppermute([x[-1:] for x in bands],
                              [(i, i + 1) for i in range(sp - 1)], devs)
                down = ppermute([x[:1] for x in bands],
                                [(i + 1, i) for i in range(sp - 1)], devs)
                for s in range(sp):
                    top = bands[s][:1] if s == 0 else up[s]
                    bottom = bands[s][-1:] if s == sp - 1 else down[s]
                    padded = torch.cat([top, bands[s], bottom])
                    out[s][b] = fxaa_pass(padded)[1:-1]
            frames += _assemble(out, mesh.devices[0, 0])
        return torch.stack(frames)

    return _program(mesh, step, "sharded_flagship")


def _pad_lights(lights, lp: int):
    """lights padded to a multiple of lp with disabled lights (range 1e-3),
    which binning drops."""
    n = lights.count
    if n % lp == 0:
        return lights
    pad = lp - n % lp
    cols = {}
    for f in dataclasses.fields(lights):
        x = getattr(lights, f.name)
        if isinstance(x, torch.Tensor):
            x = torch.cat([x, torch.zeros((pad,) + x.shape[1:],
                                          dtype=x.dtype, device=x.device)])
        cols[f.name] = x
    cols["range"][n:] = 1e-3
    # The host constants of the padded set: type 0 joins, power 0 is not 1.
    cols["kinds"] = tuple(sorted(set(lights.kinds) | {0}))
    cols["apow1"] = False
    return dataclasses.replace(lights, **cols)


def _light_slice(lights, i: int, lp: int):
    per = lights.count // lp
    return dataclasses.replace(lights, **{
        f.name: getattr(lights, f.name)[i * per:(i + 1) * per]
        for f in dataclasses.fields(lights)
        if isinstance(getattr(lights, f.name), torch.Tensor)})


def make_light_sharded_forward(mesh: Mesh, geom, objects, shade_ctx, lights,
                               width: int, height: int, tile_size: int = 16,
                               cap: int = 128,
                               sun_model: str = "blinn_phong",
                               background=(0.04, 0.06, 0.1)):
    """The forward+ frame with the LIGHTS sharded over lp (lsr_tpu
    sharding.py:393-500).  Rank (s, l) rasterizes band s (B1b), bins its
    light slice (L / lp lights; the set padded with disabled lights to a
    multiple of lp) over the full tile grid, takes its band's rows and sums
    them with accumulate_local_lights; psum over lp adds the partial
    (diffuse, specular) sums in rank order on lp rank 0, which finishes
    the band (the sun term is the same on every lp rank).  Equal to the unsharded frame up to the order of the
    light sum.

    Returns (step, light_shards): step(viewproj, view, proj, zn, zf) ->
    (height, width, 3) u8 on rank (0, 0)'s device, one program on a
    one-device mesh (see the module docstring); light_shards[l] is lp rank
    l's slice of the padded lights (lsr_tpu returns the lights' sharding in
    its place)."""
    sp, lp = mesh.shape["sp"], mesh.shape["lp"]
    assert height % sp == 0 and (height // sp) % tile_size == 0, (
        "height must split into sp bands of whole light tiles")
    lights = _pad_lights(lights, lp)
    shards = [_light_slice(lights, i, lp) for i in range(lp)]
    band_h = height // sp
    tiles_x = cdiv(width, tile_size)
    band_tiles_y = band_h // tile_size
    reps = _replicas(mesh, (geom, objects, shade_ctx, shards))

    def step(viewproj, view, proj, zn, zf):
        bands = []
        for s in range(sp):
            devs = list(mesh.devices[s])
            parts = []
            for li, dev in enumerate(devs):
                g, o, ctx, sh = reps[dev]
                vp, vw, pj = viewproj.to(dev), view.to(dev), proj.to(dev)
                y0 = s * band_h
                setup = scene_setup(
                    g.positions, g.normals, g.uvs, g.indices, g.vtx_obj,
                    g.tri_obj, o.model, o.normal_mat, vp, width, height,
                    obj_visible=o.visible)
                depth, tid, _ = rasterize_direct(
                    setup, width, band_h, zn, zf, y_offset=y0,
                    full_height=height)
                gb = interpolate_gbuffer(setup, depth, tid, y_offset=y0,
                                         materials=ctx.materials)
                base = SHADING_MODELS[sun_model](gb, ctx)
                lists, _, _ = cull_lights_tiled(sh[li], vw, pj, width, height,
                                                tile_size=tile_size, cap=cap)
                band_lists = _band_lists(lists, tiles_x, s * band_tiles_y,
                                         band_tiles_y)
                diff, spec = accumulate_local_lights(
                    gb.world_pos, gb.normal_ws, ctx.camera_pos, sh[li],
                    band_lists, width, band_h, tile_size=tile_size)
                parts.append((gb, ctx, base, diff, spec))
            # After lsr_tpu's psum every lp rank finishes the same band and
            # its out_specs P("sp") keeps lp rank 0's: the sums go to lp
            # rank 0 alone, which finishes the band here.
            diff, = psum([p[3] for p in parts], devs[:1])
            spec, = psum([p[4] for p in parts], devs[:1])
            gb, ctx, base, _, _ = parts[0]
            albedo = gather_materials(ctx.materials, gb.obj_id,
                                      mat_rec=gb.mat)[0]
            hdr = base + torch.clamp(albedo, min=0.0) * diff + spec
            bg = device_const(background, hdr.device).expand(hdr.shape)
            bands.append(tonemap_pass(composite_over_background(hdr, gb,
                                                                bg)))
        return torch.cat([b.to(mesh.devices[0, 0]) for b in bands])

    return _program(mesh, step, "light_sharded_forward"), shards


def _gbuffer_zeros(height: int, width: int, device):
    """The pipeline's fill-bubble carry: an uncovered G-buffer."""
    z2 = torch.zeros((height, width), dtype=torch.float32, device=device)
    z3 = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    return GBuffer(
        world_pos=z3, normal_ws=z3, uv=z3[..., :2], depth01=z2,
        obj_id=torch.full((height, width), -1, dtype=torch.int64,
                          device=device),
        covered=torch.zeros((height, width), dtype=torch.bool, device=device),
        bary=z3, face_normal=z3,
        tri_id=torch.full((height, width), -1, dtype=torch.int32,
                          device=device),
        tangent=z3)


def make_pipelined_render(mesh: Mesh, geom, objects, shade_ctx, width: int,
                          height: int, model_name: str = "blinn_phong",
                          background=(0.04, 0.06, 0.1)):
    """A two-stage pipeline over a stream of cameras on a ("pp",) mesh of 2
    (lsr_tpu sharding.py:512-614): stage 0 on rank 0 (setup, raster,
    G-buffer), stage 1 on rank 1 (shading model, background, tonemap).
    Step i: rank 1 shades the G-buffer carried from step i - 1 while rank 0
    rasterizes camera i; ppermute then hands the new G-buffer from rank 0
    to rank 1.  Output i is therefore camera i - 1's frame, bit for bit
    render_band's of the whole frame; output 0 is the fill bubble (the
    uncovered carry: background), to be discarded.

    stream(viewprojs (N, 4, 4), zn, zf) -> (N, height, width, 3) u8 on rank
    0's device; on a one-device mesh the whole stream is one program, as
    lsr_tpu's lax.scan is (N is part of its key)."""
    assert mesh.shape["pp"] == 2, "2-stage pipeline: pp axis must be 2"
    devs = list(mesh.devices)
    reps = _replicas(mesh, (geom, objects, shade_ctx))

    def stage0(vp, zn, zf):
        g, o, _ = reps[devs[0]]
        setup = scene_setup(
            g.positions, g.normals, g.uvs, g.indices, g.vtx_obj, g.tri_obj,
            o.model, o.normal_mat, vp, width, height, obj_visible=o.visible)
        depth, tid, _ = rasterize_direct(setup, width, height, zn, zf)
        return interpolate_gbuffer(setup, depth, tid)

    def stage1(gb):
        ctx = reps[devs[1]][2]
        shaded = SHADING_MODELS[model_name](gb, ctx)
        bg = device_const(background, shaded.device).expand(shaded.shape)
        return tonemap_pass(composite_over_background(shaded, gb, bg))

    def send(gb):
        """ppermute [(0, 1)] of every G-buffer plane."""
        return dataclasses.replace(gb, **{
            f.name: ppermute([x, x], [(0, 1)], devs)[1]
            for f in dataclasses.fields(gb)
            if isinstance(x := getattr(gb, f.name), torch.Tensor)})

    def stream(viewprojs, zn, zf):
        carry = _gbuffer_zeros(height, width, devs[1])
        out = []
        for vp in viewprojs:
            out.append(stage1(carry).to(devs[0]))
            carry = send(stage0(vp.to(devs[0]), zn, zf))
        return torch.stack(out)

    return _program(mesh, stream, "pipelined_render")
