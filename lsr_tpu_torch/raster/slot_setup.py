"""Kernel F1: the "map" local-shadow atlas's front end (csrc/slot_setup.cu).

The "map" strategy (lighting/local_shadows.render_slot_depths) rasterizes
each slot of a stack with its own B1 launch.  Each launch reads the slot's
setup records, chunk boxes and per-tile super lists (raster/tiled.py:
pack_direct_records, _chunk_bboxes, _super_lists), which the per-slot chain
scene_setup_depth -> rasterize_direct builds with ~290 small torch ops a
slot.  slot_inputs builds them for every slot of the stack at once on the
card, with kernel F1 (a memset and one launch); slot_inputs_plain, its
plain version, builds them with the chain's own functions.  Slot s of the
result is bit for bit what the per-slot chain gives with
viewprojs[s], obj_visible_slots[s] and slot_enabled[s] at CULL_NONE, in
pack_direct_records' row order (no spatial sort) and on B1's 128x128 list
tiles.
"""

from __future__ import annotations

import dataclasses

import torch

from lsr_tpu_torch.core.util import cdiv
from lsr_tpu_torch.raster.setup import (
    CULL_NONE,
    TriSetup,
    scene_setup_slots_depth,
)
from lsr_tpu_torch.raster.tiled import (
    _CHUNK,
    _REC,
    _SUPER,
    _chunk_bboxes,
    _super_lists,
    pack_direct_records,
)
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

_TILE = 128        # B1's list tiles


@dataclasses.dataclass(frozen=True)
class SlotInputs:
    """B1's inputs of every slot of a stack, slot first (n slots of size^2,
    T triangles, n_pad = 256 * n_sup >= 2 T rows, tiles = ceil(size /
    128)^2).  Slot s's slices are one B1 launch's arguments."""

    rec: torch.Tensor       # (n, n_pad, 16) f32 setup records
    chunk_bb: torch.Tensor  # (n, n_pad / 16, 4) f32 chunk boxes
    lists: torch.Tensor     # (n, tiles, n_sup) i32 super lists, -1 padded
    counts: torch.Tensor    # (n, tiles) i32


def _layout(n_tris: int, size: int):
    """(n_pad, n_sup, tiles_x) of a stack."""
    n_pad = cdiv(max(2 * n_tris, 1), _SUPER) * _SUPER
    return n_pad, n_pad // _SUPER, cdiv(size, _TILE)


def slot_inputs_plain(positions, indices, vtx_obj, tri_obj, models,
                      viewprojs, size: int, obj_visible_slots,
                      slot_enabled=None) -> SlotInputs:
    """The plain version of slot_inputs: scene_setup_slots_depth over the
    stack, then slot by slot pack_direct_records (unsorted), _chunk_bboxes
    and _super_lists on B1's list tiles, stacked."""
    ts = scene_setup_slots_depth(positions, indices, vtx_obj, tri_obj,
                                 models, viewprojs, size, cull_mode=CULL_NONE,
                                 obj_visible_slots=obj_visible_slots)
    if slot_enabled is not None:
        ts = dataclasses.replace(ts, valid=ts.valid & slot_enabled[:, None])
    tiles_x = cdiv(size, _TILE)
    out = []
    for s in range(viewprojs.shape[0]):
        st = TriSetup(**{f.name: getattr(ts, f.name)[s]
                         for f in dataclasses.fields(ts)})
        rec, srt, n_pad = pack_direct_records(st, False)
        chunk_bb = _chunk_bboxes(srt, n_pad, _CHUNK)
        lists, counts, _ = _super_lists(chunk_bb, _CHUNK, tiles_x, tiles_x,
                                        _TILE, _TILE)
        out.append((rec, chunk_bb, lists, counts))
    return SlotInputs(*(torch.stack(x) for x in zip(*out)))


def _arg(name, t, dev, dtype, shape):
    """t as the kernel reads it: on dev, of dtype and shape (None: any
    extent), contiguous; raises ValueError otherwise."""
    if (t.device != dev or t.dtype != dtype or t.dim() != len(shape)
            or any(w is not None and w != g for w, g in zip(shape, t.shape))):
        raise ValueError(f"slot_inputs: {name} must be a {dtype} tensor of "
                         f"shape {shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def slot_inputs(positions, indices, vtx_obj, tri_obj, models, viewprojs,
                size: int, obj_visible_slots, slot_enabled=None) -> SlotInputs:
    """B1's inputs of every slot of a stack (SlotInputs): viewprojs (n, 4,
    4), size x size targets, obj_visible_slots (n, O) bool, slot_enabled
    (n,) bool or None (a disabled slot's rows are all invalid).  CUDA
    tensors only: kernel F1 (a memset of its ticket counters, then one
    launch, on the current stream, no host read); raises ValueError on
    what it does not take (the CPU's "map" route is the per-slot chain,
    lighting/local_shadows._slot_depths_chain)."""
    dev = viewprojs.device
    if dev.type != "cuda":
        raise ValueError(f"slot_inputs: unsupported device {dev}")
    n, t, o = viewprojs.shape[0], indices.shape[0], models.shape[0]
    v = positions.shape[0]
    if not 1 <= n <= 65535 or size < 1:
        raise ValueError(f"slot_inputs: {n} slots of {size}^2: the kernel "
                         f"takes 1 to 65535 slots of at least 1 pixel")
    i64, f32 = torch.int64, torch.float32
    args = [_arg("positions", positions, dev, f32, (v, 3)),
            _arg("indices", indices, dev, i64, (t, 3)),
            _arg("vtx_obj", vtx_obj, dev, i64, (v,)),
            _arg("tri_obj", tri_obj, dev, i64, (t,)),
            _arg("models", models, dev, f32, (o, 4, 4)),
            _arg("viewprojs", viewprojs, dev, f32, (n, 4, 4)),
            _arg("obj_visible_slots", obj_visible_slots, dev, torch.bool,
                 (n, o))]
    en = (None if slot_enabled is None else
          _arg("slot_enabled", slot_enabled, dev, torch.bool, (n,)))
    n_pad, n_sup, tiles_x = _layout(t, size)
    tiles = tiles_x * tiles_x
    out = SlotInputs(
        rec=torch.empty((n, n_pad, _REC), dtype=f32, device=dev),
        chunk_bb=torch.empty((n, n_pad // _CHUNK, 4), dtype=f32, device=dev),
        lists=torch.empty((n, tiles, n_sup), dtype=torch.int32, device=dev),
        counts=torch.empty((n, tiles), dtype=torch.int32, device=dev))
    super_bb = torch.empty((n, n_sup, 4), dtype=f32, device=dev)
    tickets = torch.empty((n,), dtype=torch.int32, device=dev)
    err = load_kernels().lsr_slot_setup(
        *(a.data_ptr() for a in args), o,
        None if en is None else en.data_ptr(), t, n,
        size, n_sup, out.rec.data_ptr(), out.chunk_bb.data_ptr(),
        out.lists.data_ptr(), out.counts.data_ptr(), super_bb.data_ptr(),
        tickets.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch("lsr_slot_setup", err)
    slot_inputs.launches += 1
    return out


slot_inputs.launches = 0
