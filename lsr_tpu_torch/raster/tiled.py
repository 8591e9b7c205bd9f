"""Tiled rasterizers: kernels B1, B3 and B4 (port of lsr_tpu/raster/tiled.py).

- B1 rasterize_direct (_direct_kernel): setup records stay resident;
  triangles are grouped in supers of 256 (_SUPER), each made of chunks of
  16.  Per 128x128 screen tile, torch ops build the list of supers whose
  bbox overlaps the tile; the CUDA kernel (csrc/direct_raster.cu) walks its
  tile's list, one super a step, and skips chunks whose bbox misses its
  16x16 pixel block.  It also renders a stack of slots (band_h, B1a) and
  a screen band of a taller frame (y_offset, full_height, B1b).
- B3 rasterize_tiled (_raster_kernel): per-tile triangle lists (bin
  triangles, capped at `cap`), walked in list order by
  csrc/tiled_raster.cu, which reads each listed row from the resident
  records (lsr_tpu gathers a per-tile copy of them).
- B4 rasterize_chunklist (_chunklist_kernel): per-tile worklists of
  overlapping 16-triangle chunks with their row bands, walked by
  csrc/chunklist_raster.cu over the resident records.
  Both kernels walk their lists per 16x16 pixel block and first drop the
  triangles that an exact test of the block's corners rules out
  (csrc/block_walk.cuh; cull_rejects is its plain model, walk_survivors
  counts what the cull keeps).  B1 walks the same way: its candidates are
  the triangles of the listed supers' chunks whose bbox meets the block
  (rasterize_direct_plain is the plain model of that walk).

All three resolve (min depth, first submitted); B1 with spatial_sort
resolves the lexicographic (depth, tid) minimum, which is the same rule.

Setup record layout (_REC = 16 f32 per triangle, lsr_tpu's):
  [0:9] A0,B0,C0,A1,B1,C1,A2,B2,C2 | [9:12] 1/w | [12:15] z_ndc/w |
  [15] triangle id as f32 (-1 = invalid; exact below 2^24 triangles)

B3's per-tile lists are built without lsr_tpu's dense (tiles, N) mask
(at 1080p on the high-poly scene it would hold 255 x 2.2 M entries): each
valid row is expanded to its (row, tile) pairs from its tile range, the
pairs are stably sorted by tile and each tile's segment gives its list,
either from the exact pair count (a host read) or from a capacity of pair
slots (bin_triangles' pairs=).  B4's worklists (chunks, 16x fewer than
rows) and B1's super lists come from lsr_tpu's dense masks.  The lists,
counts and maxima are the same integers as lsr_tpu's.

zn / zf are data, as lsr_tpu's z_ref (tiled.py:585-589): 0-d f32 tensors
(a camera's) or host numbers, made into one (2,) f32 tensor [zn, inv_range]
by brute.zparams, whose device pointer the kernels take and whose two
values their plain versions use, so a captured frame replays at any zn /
zf.  Each wrapper runs its plain PyTorch version for CPU tensors only,
walking the same lists the kernel gets; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import dataclasses

import torch

from lsr_tpu_torch.core.util import cdiv
from lsr_tpu_torch.raster.brute import rasterize_brute, zparams
from lsr_tpu_torch.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ, TriSetup
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

_SUPER = 256      # triangles per super-chunk
_REC = 16         # f32 lanes per setup record
_CHUNK = 16       # triangles per chunk of kernel B1
_PLAIN_WALK_STEP = 1024  # triangles per step of walk_survivors
_BAND_BITS = 5    # low bits of a chunk-list entry: band_start, band_count - 1
_KERNEL_BLOCK = 16  # the rasters' pixel blocks are 16x16, inside one tile
_KERNEL_WARP = (8, 4)  # a warp of such a block owns 8x4 (w x h) pixels
_PLAIN_GROUP = 64   # triangles per step of the plain B1 and B4 walks

# Setups with more rows than this take the binned kernel B3 instead of B1,
# in render_forward and in the pipeline raster (lsr_tpu's routing limit,
# render.py:125 and standard_passes.py:83).  Both read it at call time.
DIRECT_ROW_LIMIT = 150_000


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _check_depth_mode(name, depth_mode):
    if depth_mode not in (DEPTH_VIEWZ, DEPTH_NDC01):
        raise ValueError(f"{name}: unknown depth_mode {depth_mode}")


def _targets(depth_init, tid_init, height, width, dev):
    """Default (cleared) depth / tid targets."""
    if depth_init is None:
        depth_init = torch.ones((height, width), dtype=torch.float32,
                                device=dev)
    if tid_init is None:
        tid_init = torch.full((height, width), -1, dtype=torch.int32,
                              device=dev)
    return depth_init, tid_init


def _check_cuda_targets(name, dev, height, width, depth_init, tid_init):
    """Given targets must be what the kernels read; B1 also takes None."""
    for tname, t, dt in (("depth_init", depth_init, torch.float32),
                         ("tid_init", tid_init, torch.int32)):
        if t is None:
            continue
        if (t.device != dev or t.dtype != dt or t.shape != (height, width)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {tname} must be a contiguous {dt} "
                             f"({height}, {width}) tensor on {dev}")


def _check_kernel_tiles(name, tile_h, tile_w):
    if tile_h % _KERNEL_BLOCK or tile_w % _KERNEL_BLOCK:
        raise ValueError(f"{name}: the CUDA kernel needs tile_h and tile_w "
                         f"to be multiples of {_KERNEL_BLOCK}, got "
                         f"{tile_h}x{tile_w}")


def tile_order(counts):
    """(tiles,) i64: the tiles by falling list length.  Kernels B3 and B4
    start their blocks in this order, so the longest walks begin first."""
    return torch.argsort(counts, descending=True, stable=True)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _device(name, setup: TriSetup):
    """The setup's device: CPU (plain version) or CUDA (kernel)."""
    dev = setup.coef.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Kernel B1: listless (direct) raster
# ---------------------------------------------------------------------------

def _chunk_bboxes(setup: TriSetup, n_pad: int, chunk: int):
    """(n_pad/chunk, 4) f32 chunk bboxes (x0,y0,x1,y1); empty for invalid."""
    big = 1e9
    bb = setup.bbox.to(torch.float32)
    v = setup.valid

    def col(j, fill):
        x = torch.where(v, bb[:, j], torch.full_like(bb[:, j], fill))
        pad = torch.full((n_pad - x.shape[0],), fill, dtype=x.dtype,
                         device=x.device)
        return torch.cat([x, pad]).reshape(-1, chunk)

    return torch.stack([col(0, big).min(dim=1).values,
                        col(1, big).min(dim=1).values,
                        col(2, -big).max(dim=1).values,
                        col(3, -big).max(dim=1).values], dim=-1)


def _super_mask(chunk_bb, chunk: int, tiles_x: int, tiles_y: int,
                tile_w: int, tile_h: int, y_offset: int = 0):
    """(tiles, S) bool: super s overlaps tile t (super bbox from chunks).
    The tiles are the target's: tile row ty holds global rows from
    y_offset + ty * tile_h (lsr_tpu's _super_lists, tiled.py:259-270)."""
    dev = chunk_bb.device
    cps = _SUPER // chunk
    s = chunk_bb.shape[0] // cps
    sb = chunk_bb.reshape(s, cps, 4)
    sx0 = sb[..., 0].min(dim=1).values
    sy0 = sb[..., 1].min(dim=1).values - float(y_offset)
    sx1 = sb[..., 2].max(dim=1).values
    sy1 = sb[..., 3].max(dim=1).values - float(y_offset)
    tx = torch.arange(tiles_x, dtype=torch.float32, device=dev) * tile_w
    ty = torch.arange(tiles_y, dtype=torch.float32, device=dev) * tile_h
    ox = (sx0[None, :] <= tx[:, None] + (tile_w - 1)) & (sx1[None, :] >= tx[:, None])
    oy = (sy0[None, :] <= ty[:, None] + (tile_h - 1)) & (sy1[None, :] >= ty[:, None])
    return (oy[:, None, :] & ox[None, :, :]).reshape(tiles_y * tiles_x, s)


def _super_lists(chunk_bb, chunk: int, tiles_x: int, tiles_y: int,
                 tile_w: int, tile_h: int, y_offset: int = 0):
    """Per-tile overlapping-super lists from chunk bboxes; y_offset as in
    _super_mask.

    Lists are sized by the number of supers, the bound of every count, so
    no list is ever clamped (the TPU clamped them to fit its SMEM).
    Returns (lists (tiles, S) i32 -1 padded, counts (tiles,) i32,
    max_count () i32)."""
    return _mask_to_lists(_super_mask(chunk_bb, chunk, tiles_x, tiles_y,
                                      tile_w, tile_h, y_offset))


def _mask_to_lists(mask):
    """(tiles, S) bool -> order-preserving (lists (tiles, S) i32 -1 padded,
    counts (tiles,) i32, max_count () i32)."""
    ids = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    return _dense_lists(mask, ids.expand(mask.shape), mask.shape[1], -1)


def _dense_lists(mask, values, width: int, fill: int):
    """lsr_tpu's list construction from a dense (tiles, S) mask: each tile's
    list holds values[t, s] for its set s in ascending s, the first `width`
    of them (entries past it are dropped), `fill` padded.  Shapes are
    static: no host read.  Returns (lists (tiles, width) i32, counts
    (tiles,) i32 capped at width, max_count () i32 before capping)."""
    tiles = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    counts = mask.sum(dim=1, dtype=torch.int32)
    base = (torch.arange(tiles, device=mask.device) * width)[:, None]
    flat = torch.where(mask & (pos < width), base + pos,
                       torch.full_like(base, tiles * width))
    lists = torch.full((tiles * width + 1,), fill, dtype=torch.int32,
                       device=mask.device)
    lists[flat.reshape(-1)] = values.reshape(-1).to(torch.int32)
    return (lists[:-1].reshape(tiles, width), torch.clamp(counts, max=width),
            counts.max())


def pack_direct_records(setup: TriSetup, spatial_sort: bool,
                        tile_w: int = 128, tile_h: int = 128):
    """Sorted-or-not setup -> (rec (n_pad, _REC) f32, sorted setup rows).

    spatial_sort reorders rows by bbox-center tile (stable), so chunk and
    super bboxes are tight; lane 15 keeps the CALLER's triangle ids."""
    n = setup.coef.shape[0]
    dev = setup.coef.device
    ids = torch.arange(n, dtype=torch.float32, device=dev)
    coef, iw, ziw, bbox, valid = (setup.coef, setup.iw, setup.ziw,
                                  setup.bbox, setup.valid)
    if spatial_sort:
        cx = torch.div(bbox[:, 0] + bbox[:, 2], 2, rounding_mode="floor")
        cy = torch.div(bbox[:, 1] + bbox[:, 3], 2, rounding_mode="floor")
        key = (cy // tile_h) * (1 << 15) + (cx // tile_w)
        key = torch.where(valid, key, torch.full_like(key, 1 << 29))
        order = torch.argsort(key, stable=True)
        coef, iw, ziw, bbox, valid, ids = (
            coef[order], iw[order], ziw[order], bbox[order], valid[order],
            ids[order])
    n_pad = cdiv(max(n, 1), _SUPER) * _SUPER
    rec = torch.zeros((n_pad, _REC), dtype=torch.float32, device=dev)
    rec[:n, 0:9] = coef
    rec[:n, 9:12] = iw
    rec[:n, 12:15] = ziw
    rec[:, 15] = -1.0
    rec[:n, 15] = torch.where(valid, ids, torch.full_like(ids, -1.0))
    sorted_setup = TriSetup(coef=coef, iw=iw, ziw=ziw, bbox=bbox, valid=valid,
                            obj_id=setup.obj_id, wp=setup.wp, nw=setup.nw,
                            uv=setup.uv)
    return rec, sorted_setup, n_pad


def _direct_launch(lib, rec, chunk_bb, slists, counts, depth_init, tid_init,
                   width, height, zn, zf, depth_mode, track_ids, tie_tid,
                   stream, band_h=0, y_offset=0, full_height=None,
                   depth=None):
    """Launch kernel B1 through the C interface; returns (depth, tid),
    the depth written into `depth` (height, width) where given.
    depth_init / tid_init None: the kernel starts from a cleared target
    (depth 1, id -1) without reading one.  track_ids False: depth only,
    tid comes back as it went in.  tie_tid: exact depth ties go to the
    smaller id instead of the earlier row.  band_h: the stacked atlas's
    band-local rows; y_offset / full_height: a screen band (B1b) of a
    full_height frame, slists built with the same y_offset
    (rasterize_direct)."""
    full_height = height if full_height is None else full_height
    dev = rec.device
    zp = zparams(zn, zf, dev)
    if depth is None:
        depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    chunk_bb = chunk_bb.contiguous()
    err = lib.lsr_direct_raster(
        rec.data_ptr(), chunk_bb.data_ptr(), slists.data_ptr(),
        counts.data_ptr(),
        None if depth_init is None else depth_init.data_ptr(),
        None if tid_init is None else tid_init.data_ptr(),
        depth.data_ptr(), tid.data_ptr(), width, height,
        cdiv(width, 128), slists.shape[1], zp.data_ptr(),
        float(full_height - 1), depth_mode, int(track_ids), int(tie_tid),
        int(band_h), int(y_offset), stream)
    check_launch("lsr_direct_raster", err)
    return depth, tid


def rasterize_direct(setup: TriSetup, width: int, height: int, zn,
                     zf, depth_init=None, tid_init=None,
                     depth_mode: int = DEPTH_VIEWZ, tile_h: int = 128,
                     tile_w: int = 128, chunk: int = 16, y_offset: int = 0,
                     full_height: int | None = None, track_ids: bool = True,
                     band_h: int = 0, spatial_sort: bool = False):
    """Listless tiled rasterization.  Returns (depth01 (H, W) f32,
    tid (H, W) i32, max_supers_per_tile () i32).

    The kernel keeps its own blocking (128x128 super lists, 16-triangle
    chunks); tile_h / tile_w / chunk are the caller's, as in lsr_tpu: they
    set the spatial-sort key and the tile grid at which max_supers_per_tile
    is counted, and change neither depth nor tid.
    track_ids=False resolves depth only (tid comes back as tid_init).
    spatial_sort=True resolves exact z ties by min tid, which equals the
    unsorted first-submitted rule; emitted tids index the caller's rows.
    CPU tensors run the plain version (rasterize_brute); CUDA tensors launch
    kernel B1 or raise.  Without depth_init / tid_init the kernel starts
    from the cleared constants and no target is allocated for it to read.

    band_h > 0 is the stacked atlas (kernel variant B1a,
    lsr_tpu/raster/tiled.py:309-318): the target is height / band_h slots
    of band_h rows, each setup row slot-local (coefficients for rows [0,
    band_h)) but binned by a bbox in global rows.  A pixel's coverage row is
    its row inside its band and the bound max_py is band_h - 1, so every
    slot rasterizes bit for bit as it would alone.  The plain version
    rasterizes each band with the rows whose bbox meets it; the kernel's
    16x16 pixel blocks must not straddle two bands (band_h a multiple of
    16), since only its chunk-bbox test keeps one slot's triangles out of
    the next slot's pixels.  spatial_sort is refused with it, as in
    lsr_tpu (a sorted chunk would mix slots).

    y_offset / full_height (kernel variant B1b, lsr_tpu/raster/tiled.py:
    60-79, :259-270): the target is global rows [y_offset, y_offset +
    height) of a full_height frame (default height), a screen band.
    Coverage is evaluated at global rows and bounded by full_height - 1;
    the super lists are built on the band's own 128-row tiles (global rows
    less y_offset), the chunk boxes stay global.  The plain version is
    rasterize_brute at the band's global rows, whose bands of any offset
    concatenate to its whole frame bit for bit; the kernel's do too, but
    on the stray pixels of sliver triangles (ROADMAP C8), which a block
    grid off the frame's may keep or skip.  band_h with y_offset is
    refused: no caller of lsr_tpu passes both."""
    y_offset = int(y_offset)
    full_height = height if full_height is None else int(full_height)
    if band_h and spatial_sort:
        raise ValueError("rasterize_direct: spatial_sort mixes the slots of "
                         "a band_h stack")
    if band_h and height % band_h:
        raise ValueError(f"rasterize_direct: height {height} is not a whole "
                         f"number of bands of {band_h} rows")
    if band_h and (y_offset or full_height != height):
        raise ValueError("rasterize_direct: band_h (a slot stack) and a "
                         "screen band (y_offset, full_height) do not combine")
    if y_offset < 0 or y_offset + height > full_height:
        raise ValueError(f"rasterize_direct: rows [{y_offset}, "
                         f"{y_offset + height}) lie outside a frame of "
                         f"{full_height} rows")
    if _SUPER % chunk:
        raise ValueError(f"rasterize_direct: chunk {chunk} must divide "
                         f"{_SUPER}")
    _check_depth_mode("rasterize_direct", depth_mode)
    dev = _device("rasterize_direct", setup)

    rec, sorted_setup, n_pad = pack_direct_records(setup, spatial_sort,
                                                   tile_w, tile_h)
    chunk_bb = _chunk_bboxes(sorted_setup, n_pad, _CHUNK)
    slists, counts, max_sup = _super_lists(
        chunk_bb, _CHUNK, cdiv(width, 128), cdiv(height, 128), 128, 128,
        y_offset)
    if (tile_h, tile_w) != (128, 128):
        # A super's bbox spans all its 256 rows whatever the chunk size, so
        # the kernel's chunk bboxes give the caller's count too.
        max_sup = _super_mask(chunk_bb, _CHUNK, cdiv(width, tile_w),
                              cdiv(height, tile_h), tile_w, tile_h, y_offset
                              ).sum(dim=1, dtype=torch.int32).max()

    if dev.type == "cpu":
        depth_init, tid_init = _targets(depth_init, tid_init, height, width,
                                        dev)
        if band_h:
            depth, tid = _banded_brute(setup, width, height, band_h, zn, zf,
                                       depth_init, tid_init, depth_mode)
        else:
            depth, tid = rasterize_brute(setup, width, height, zn, zf,
                                         depth_init=depth_init,
                                         tid_init=tid_init,
                                         depth_mode=depth_mode,
                                         y_offset=y_offset,
                                         full_height=full_height)
        return depth, (tid if track_ids else tid_init.clone()), max_sup

    _check_cuda_targets("rasterize_direct", dev, height, width, depth_init,
                        tid_init)
    if band_h % _KERNEL_BLOCK:
        raise ValueError(f"rasterize_direct: the CUDA kernel needs band_h to "
                         f"be a multiple of {_KERNEL_BLOCK}, got {band_h}")
    # Depth only: the tid the kernel writes is tid_init (or -1 everywhere).
    depth, tid = _direct_launch(
        load_kernels(), rec, chunk_bb, slists, counts, depth_init, tid_init,
        width, height, zn, zf, depth_mode, track_ids, spatial_sort,
        _stream(dev), band_h, y_offset, full_height)
    rasterize_direct.launches += 1
    if y_offset or full_height != height:
        rasterize_direct.band_launches += 1      # of them, B1b's
    return depth, tid, max_sup


rasterize_direct.launches = 0
rasterize_direct.band_launches = 0


def rasterize_direct_records(rec, chunk_bb, slists, counts, depth):
    """Kernel B1 on a slot's inputs already built on the card: the records,
    chunk boxes and super lists of 128x128 tiles that pack_direct_records,
    _chunk_bboxes and _super_lists give an unsorted setup (the atlas's
    front end, raster/slot_setup.py, writes them for a stack of slots).
    NDC01 depth only, from a cleared target, written into `depth` (size,
    size) and returned; one launch, counted in rasterize_direct.launches.
    CUDA tensors only (the CPU's atlas runs rasterize_direct)."""
    dev = rec.device
    if dev.type != "cuda":
        raise ValueError(f"rasterize_direct_records: unsupported device "
                         f"{dev}")
    size = depth.shape[0]
    _check_cuda_targets("rasterize_direct_records", dev, size, size, depth,
                        None)
    _direct_launch(load_kernels(), rec, chunk_bb, slists, counts, None, None,
                   size, size, 0.0, 1.0, DEPTH_NDC01, False, False,
                   _stream(dev), depth=depth)
    rasterize_direct.launches += 1
    return depth


def _banded_brute(setup: TriSetup, width: int, height: int, band_h: int,
                  zn, zf, depth_init, tid_init, depth_mode):
    """rasterize_brute per band of a band_h stack: band b's rows [b * band_h,
    (b + 1) * band_h) take the setup rows whose bbox meets them, evaluated
    at band-local rows."""
    depth, tid = [], []
    y0, y1 = setup.bbox[:, 1], setup.bbox[:, 3]
    for b in range(height // band_h):
        lo, hi = b * band_h, (b + 1) * band_h
        st = dataclasses.replace(setup,
                                 valid=setup.valid & (y0 < hi) & (y1 >= lo))
        d, t = rasterize_brute(st, width, band_h, zn, zf,
                               depth_init=depth_init[lo:hi],
                               tid_init=tid_init[lo:hi],
                               depth_mode=depth_mode)
        depth.append(d)
        tid.append(t)
    return torch.cat(depth), torch.cat(tid)


# ---------------------------------------------------------------------------
# Sparse per-tile lists (B3 bins, B4 chunk worklists)
# ---------------------------------------------------------------------------

def _spans(x0, y0, x1, y1, ok, tiles_x: int, tiles_y: int, tile_w: int,
           tile_h: int):
    """Inclusive tile ranges of integer boxes, clipped to the grid.
    Returns (tx0, tx1, ty0, ty1, ok) with ok False where nothing overlaps."""
    fd = lambda a, b: torch.div(a, b, rounding_mode="floor")  # noqa: E731
    tx0, tx1, ty0, ty1 = fd(x0, tile_w), fd(x1, tile_w), fd(y0, tile_h), \
        fd(y1, tile_h)
    ok = (ok & (tx0 <= tx1) & (ty0 <= ty1) & (tx1 >= 0) & (ty1 >= 0)
          & (tx0 < tiles_x) & (ty0 < tiles_y))
    return (tx0.clamp(0, tiles_x - 1), tx1.clamp(0, tiles_x - 1),
            ty0.clamp(0, tiles_y - 1), ty1.clamp(0, tiles_y - 1), ok)


def _span_counts(spans, tiles_x: int, tiles_y: int):
    """(tiles,) i64 number of boxes overlapping each tile: a 2-D difference
    array over the tile grid, O(boxes + tiles), no host sync."""
    tx0, tx1, ty0, ty1, ok = spans
    w = ok.to(torch.int64)
    stride = tiles_x + 1
    grid = torch.zeros((tiles_y + 1) * stride, dtype=torch.int64,
                       device=w.device)
    for yy, xx, sign in ((ty0, tx0, 1), (ty0, tx1 + 1, -1),
                         (ty1 + 1, tx0, -1), (ty1 + 1, tx1 + 1, 1)):
        grid.index_add_(0, yy * stride + xx, w * sign)
    grid = grid.view(tiles_y + 1, stride).cumsum(0).cumsum(1)
    return grid[:tiles_y, :tiles_x].reshape(-1)


def _spans_to_lists(spans, counts, tiles_x: int, cap: int,
                    pairs: int | None = None):
    """Per-tile lists (tiles, cap) i32, -1 padded, of the rows of every
    (box row, tile) pair, ascending row within a tile; entries past `cap`
    are dropped.  Returns (lists, the entries each tile's list holds before
    `cap`, (tiles,) i64).

    pairs=None expands exactly the pairs there are: one host sync, their
    number.  pairs=P (the capacity route, no host read) expands P pair
    slots: slot p belongs to the row whose range of the rows' running pair
    count holds p, and slots at or past the true count take the tile key
    num_tiles, so they sort last and drop out.  While P holds every pair,
    the lists are the same as with pairs=None; past it the last rows' pairs
    are missing (the caller flags it) and the returned counts say what the
    lists hold, so no walk reads past a list."""
    tx0, tx1, ty0, ty1, ok = spans
    dev = ok.device
    nx = tx1 - tx0 + 1
    per_row = torch.where(ok, nx * (ty1 - ty0 + 1), torch.zeros_like(nx))
    ends = torch.cumsum(per_row, 0)
    num_tiles = counts.shape[0]
    if pairs is None:
        n_pairs = int(counts.sum())
        rows = torch.repeat_interleave(
            torch.arange(per_row.shape[0], device=dev), per_row,
            output_size=n_pairs)
    else:
        n_pairs = pairs
        slots = torch.arange(pairs, device=dev)
        rows = torch.searchsorted(ends, slots, right=True).clamp(
            max=per_row.shape[0] - 1)
    local = torch.arange(n_pairs, device=dev) - (ends - per_row)[rows]
    nxr = nx[rows].clamp(min=1)       # a slot past the count may sit on a
    ty = ty0[rows] + torch.div(local, nxr, rounding_mode="floor")  # dead row
    tile = ty * tiles_x + tx0[rows] + local % nxr
    if pairs is not None:
        tile = torch.where(slots < ends[-1], tile,
                           torch.full_like(tile, num_tiles))
    tile, perm = torch.sort(tile, stable=True)
    if pairs is None:
        held = counts
        starts = torch.cat([torch.cumsum(counts, 0) - counts,
                            counts.new_zeros(1)])
    else:
        # Where each tile's run of the sorted slots starts, and how long
        # it is (the dead slots' key num_tiles runs last).
        starts = torch.searchsorted(
            tile, torch.arange(num_tiles + 1, device=dev))
        held = starts[1:] - starts[:-1]
    pos = torch.arange(n_pairs, device=dev) - starts[tile]
    slot = torch.where((pos < cap) & (tile < num_tiles), tile * cap + pos,
                       torch.full_like(pos, num_tiles * cap))
    lists = torch.full((num_tiles * cap + 1,), -1, dtype=torch.int32,
                       device=dev)
    lists[slot] = rows[perm].to(torch.int32)
    return lists[:-1].view(num_tiles, cap), held


def _bbox_spans(setup: TriSetup, tiles_x, tiles_y, tile_w, tile_h,
                y_offset):
    bb = setup.bbox.to(torch.int64)
    return _spans(bb[:, 0], bb[:, 1] - y_offset, bb[:, 2], bb[:, 3] - y_offset,
                  setup.valid, tiles_x, tiles_y, tile_w, tile_h)


def fitted_cap(cap: int, max_bin: int) -> int:
    """max(cap, ceil(max_bin/256)*256): the smallest list cap of at least
    `cap` that drops no triangle, the rule of lsr_tpu's own bench
    (scripts/bench_highpoly.py:97-103)."""
    return max(cap, cdiv(max_bin, 256) * 256)


def bin_triangles(setup: TriSetup, width: int, height: int, tile_h: int,
                  tile_w: int, cap: int, y_offset: int = 0,
                  fit_cap: bool = False, pairs: int | None = None):
    """Per-tile triangle lists.  Returns (lists (tiles, cap) i32 -1 padded,
    counts (tiles,) i32 capped, max_count () i32 before capping, n_pairs
    () i64 the (row, tile) pairs there are, over () bool set where the
    lists dropped a triangle).

    Lists keep submission order (the first-wins depth tie rule); a tile
    with more than `cap` triangles keeps its first `cap`.  fit_cap=True
    first raises cap to fitted_cap(cap, max_count), so nothing is dropped;
    lists.shape[1] is the cap used.  y_offset is the global row of this
    target's first row (screen bands).

    pairs=P is the capacity route of a captured frame: no host read, the
    lists built from P (row, tile) pair slots at the given cap (fit_cap must
    be False); over is also set where n_pairs exceeds P.  Otherwise the
    lists and counts are the pairs=None route's, element for element."""
    if pairs is not None and fit_cap:
        raise ValueError("bin_triangles: fit_cap reads the largest bin on "
                         "the host; the capacity route (pairs=) takes cap "
                         "as given")
    tiles_x, tiles_y = cdiv(width, tile_w), cdiv(height, tile_h)
    spans = _bbox_spans(setup, tiles_x, tiles_y, tile_w, tile_h, y_offset)
    counts = _span_counts(spans, tiles_x, tiles_y)
    max_count = counts.max()
    if fit_cap:
        cap = fitted_cap(cap, int(max_count))
    lists, held = _spans_to_lists(spans, counts, tiles_x, cap, pairs)
    n_pairs = counts.sum()
    over = max_count > cap
    if pairs is not None:
        over = over | (n_pairs > pairs)
    return (lists, torch.clamp(held, max=cap).to(torch.int32),
            max_count.to(torch.int32), n_pairs, over)


def _chunk_lists(setup: TriSetup, n_pad: int, chunk: int, tiles_x: int,
                 tiles_y: int, tile_w: int, tile_h: int, ccap: int,
                 y_offset: int, sub_h: int):
    """Per-tile overlapping-chunk worklists with packed row-band info, built
    as lsr_tpu builds them (tiled.py:654-694): from the dense (tiles,
    chunks) overlap mask and its running count, static shapes and no host
    read, so a captured frame holds them.

    Returns (lists (tiles, ccap) i32 0 padded, counts (tiles,) i32 capped,
    max_count () i32).  Entries are id << 5 | band_start << 2 |
    (band_count - 1), bands of sub_h rows, ascending chunk id."""
    cbb = _chunk_bboxes(setup, n_pad, chunk)
    ok = cbb[:, 0] <= cbb[:, 2]               # empty chunks have x0 > x1
    box = torch.where(ok[:, None], cbb, torch.zeros_like(cbb)).to(torch.int64)
    y0, y1 = box[:, 1] - y_offset, box[:, 3] - y_offset
    tx0, tx1, ty0, ty1, ok = _spans(box[:, 0], y0, box[:, 2], y1, ok,
                                    tiles_x, tiles_y, tile_w, tile_h)
    dev = ok.device
    tx = torch.arange(tiles_x, device=dev)[:, None]
    ty = torch.arange(tiles_y, device=dev)[:, None]
    ox = (tx0 <= tx) & (tx <= tx1)                           # (tiles_x, C)
    oy = (ty0 <= ty) & (ty <= ty1) & ok                      # (tiles_y, C)
    mask = (oy[:, None] & ox[None]).reshape(tiles_y * tiles_x, -1)
    nb_max = tile_h // sub_h
    band = lambda y: torch.div(  # noqa: E731
        y[None] - ty * tile_h, sub_h, rounding_mode="floor").clamp(
            0, nb_max - 1)
    bs, be = band(y0), band(y1)                              # (tiles_y, C)
    cid = torch.arange(ok.shape[0], device=dev)[None]
    entry = (cid << _BAND_BITS) | (bs << 2) | (be - bs)
    return _dense_lists(mask, entry[:, None].expand(-1, tiles_x, -1), ccap,
                        0)


# ---------------------------------------------------------------------------
# Plain versions of B3 and B4: the same lists, vectorised over tiles
# ---------------------------------------------------------------------------

def _tri_depth(blk, fr, zn, inv_range, depth_mode: int):
    """Coverage and depth of records blk (T, K, _REC) at the pixels of the
    tiles of fr (a _TileFrame), in the operation order of
    csrc/raster_common.cuh; zn / inv_range: 0-d f32 tensors, the pair of
    zparams the kernels read.  Returns (inside, z01), each (T, K, H, W)."""
    def f(j):
        return blk[..., j][..., None, None]

    px, py = fr.px, fr.py
    bc0 = f(0) * px + f(1) * py + f(2)
    bc1 = f(3) * px + f(4) * py + f(5)
    bc2 = f(6) * px + f(7) * py + f(8)
    inside = (bc0 >= 0.0) & (bc1 >= 0.0) & (bc2 >= 0.0) & (f(15) >= 0.0)
    denom = bc0 * f(9) + bc1 * f(10) + bc2 * f(11)
    inside &= denom > 1e-10
    if depth_mode == DEPTH_VIEWZ:
        view_z = 1.0 / torch.clamp(denom, min=1e-10)
        z01 = torch.clamp((view_z - zn) * inv_range, 0.0, 1.0)
    else:
        zlin = (bc0 * f(12) + bc1 * f(13) + bc2 * f(14)) \
            / torch.clamp(denom, min=1e-10)
        z01 = torch.clamp(zlin * 0.5 + 0.5, 0.0, 1.0)
    return inside, z01


def _edge_max(a, b, c, x0, x1, y0, y1):
    """The largest f32 value of the edge function a*px + b*py + c over pixel
    centers px in [x0, x1], py in [y0, y1], in _tri_depth's operation order.
    Every step rounds to nearest and rounding is monotone, so the maximum is
    the value at the corner picked by the signs of a and b."""
    return (a * torch.where(a >= 0.0, x1, x0)
            + b * torch.where(b >= 0.0, y1, y0) + c)


def cull_rejects(blk, x0, x1, y0, y1):
    """Plain model of the kernels' exact cull (lsr::rect_reject in
    csrc/raster_common.cuh): True where no pixel center of the rectangle
    [x0, x1] x [y0, y1] can pass _tri_depth's coverage test, because an
    edge function is negative at its largest corner or the id lane marks
    the record invalid.  A NaN corner compares False and keeps the record.
    blk is (..., _REC); the bounds broadcast against blk[..., 0] and are the
    very floats the rectangle's pixels use as centers."""
    worst = [_edge_max(blk[..., e], blk[..., e + 1], blk[..., e + 2],
                       x0, x1, y0, y1) for e in (0, 3, 6)]
    return ((worst[0] < 0.0) | (worst[1] < 0.0) | (worst[2] < 0.0)
            | (blk[..., 15] < 0.0))


def _rect_keep(blk, fr, bw, bh, bands=None, sub_h=None):
    """(T, K, th // bh, tw // bw) bool: record k of tile t survives the cull
    against each bw x bh pixel rectangle of the tile and, with bands (T, K)
    packed as start << 2 | (count - 1) in rows of sub_h, its bands meet the
    rectangle's rows (band_hit in csrc/block_walk.cuh)."""
    keep = ~cull_rejects(blk[:, :, None, None, :],
                         fr.px[..., ::bw], fr.px[..., bw - 1::bw],
                         fr.py[:, :, ::bh], fr.py[:, :, bh - 1::bh])
    if bands is not None:
        row0 = torch.arange(0, fr.th, bh, device=blk.device)
        bs = ((bands >> 2) & 3)[..., None]
        be = bs + (bands & 3)[..., None]
        hit = ((row0 + bh - 1) // sub_h >= bs) & (row0 // sub_h <= be)
        keep = keep & hit[..., None]
    return keep


def _per_pixel(per_block, bh, bw):
    """(..., H / bh, W / bw) -> (..., H, W): each rectangle's value at its
    pixels."""
    return per_block.repeat_interleave(bh, dim=-2).repeat_interleave(
        bw, dim=-1)


def _walk_keep(blk, fr, bands=None, sub_h=None):
    """(T, K, H, W) bool: at each pixel, whether record k of tile t reaches
    the pixel's evaluation in kernels B3 and B4: it survives the cull
    against the pixel's 16x16 block and against its warp's 8x4 rectangle,
    and (B4) its bands meet the rows of both."""
    _check_kernel_tiles("block cull", fr.th, fr.tw)
    keep = None
    for bw, bh in ((_KERNEL_BLOCK, _KERNEL_BLOCK), _KERNEL_WARP):
        level = _per_pixel(_rect_keep(blk, fr, bw, bh, bands, sub_h), bh, bw)
        keep = level if keep is None else keep & level
    return keep


def _chunk_triangles(e, chunk):
    """Worklist entries e (T, g) i64 -> (setup rows, packed bands), each
    (T, g * chunk): the triangles of the listed chunks, in list order."""
    k = torch.arange(chunk, device=e.device)
    rows = ((e >> _BAND_BITS)[..., None] * chunk + k).flatten(1)
    bands = (e & ((1 << _BAND_BITS) - 1))[..., None].expand(
        -1, -1, chunk).flatten(1)
    return rows, bands


class _TileFrame:
    """The padded (tiles_y*tile_h, tiles_x*tile_w) target as (T, th, tw)
    tiles, with each tile's pixel centers (px, py) and coverage bound."""

    def __init__(self, width, height, tile_w, tile_h, y_offset, full_height,
                 dev, band_h=0):
        self.w, self.h, self.tw, self.th = width, height, tile_w, tile_h
        self.tx, self.ty = cdiv(width, tile_w), cdiv(height, tile_h)
        t = torch.arange(self.tx * self.ty, device=dev)
        xs = (t % self.tx)[:, None] * tile_w + torch.arange(tile_w, device=dev)
        ys = (t // self.tx)[:, None] * tile_h \
            + torch.arange(tile_h, device=dev) + y_offset
        # gy: the rows the lists and chunk bboxes are in; py: the rows the
        # coverage is evaluated at (band-local in a band_h stack).
        self.gy = ys.to(torch.float32)[:, None, :, None]
        if band_h:
            ys = ys % band_h
            full_height = band_h
        self.px = xs.to(torch.float32)[:, None, None, :] + 0.5
        self.py = ys.to(torch.float32)[:, None, :, None] + 0.5
        self.ndc_ok = ((self.px <= float(width - 1))
                       & (self.py <= float(full_height - 1)))[:, 0]

    def split(self, img, fill):
        pad = torch.full((self.ty * self.th, self.tx * self.tw), fill,
                         dtype=img.dtype, device=img.device)
        pad[:self.h, :self.w] = img
        return pad.view(self.ty, self.th, self.tx, self.tw).permute(
            0, 2, 1, 3).reshape(-1, self.th, self.tw)

    def join(self, tiles):
        return tiles.view(self.ty, self.tx, self.th, self.tw).permute(
            0, 2, 1, 3).reshape(self.ty * self.th, self.tx * self.tw)[
                :self.h, :self.w]


def _resolve(inside, z01, ids, d, t, track_ids: bool, tie_tid: bool = False):
    """Fold one group of candidates (T, K, H, W), in list order, into the
    (T, H, W) depth / tid: (min depth, first in the group), strict '<'
    against the target.  Equals a sequential strict walk.  tie_tid: exact
    depth ties, inside the group and against the target, go to the smaller
    id instead (kernel B1 on spatially sorted rows)."""
    cand = torch.where(inside, z01, torch.full_like(z01, float("inf")))
    best, k = torch.min(cand, dim=1)      # first minimum = first in list
    upd = best < d
    if track_ids and tie_tid:
        tied = inside & (cand == best[:, None])
        win = torch.where(tied, ids[..., None, None],
                          torch.full_like(z01, float("inf"))).min(dim=1).values
        upd = upd | ((best == d) & (win < t))
    else:
        win = torch.gather(ids, 1, k.flatten(1)).view_as(k)
    d = torch.where(upd, best, d)
    if track_ids:
        t = torch.where(upd, win.to(torch.int32), t)
    return d, t


def _super_chunks(sup, chunk_bb, fr):
    """Listed supers sup (T, g) i64 -> (setup rows (T, g * 256), hit
    (T, g * 16, th / 16, tw / 16) bool): the triangles of the supers' chunks
    in row order, and whether each chunk's bbox meets each 16x16 pixel block
    of the tile, the test of kernel B1 (inclusive pixel indices against the
    block's first and last pixel)."""
    dev = sup.device
    cps = _SUPER // _CHUNK
    chunks = (sup[..., None] * cps + torch.arange(cps, device=dev)).flatten(1)
    rows = (chunks[..., None] * _CHUNK
            + torch.arange(_CHUNK, device=dev)).flatten(1)
    bb = chunk_bb[chunks]                                    # (T, g*16, 4)
    b = _KERNEL_BLOCK
    x0 = (fr.px[:, 0, 0, ::b] - 0.5)[:, None, None, :]       # (T, 1, 1, bx)
    y0 = fr.gy[:, 0, ::b, 0][:, None, :, None]               # (T, 1, by, 1)
    lane = lambda j: bb[..., j][..., None, None]  # noqa: E731
    hit = ((lane(0) <= x0 + (b - 1)) & (lane(2) >= x0)
           & (lane(1) <= y0 + (b - 1)) & (lane(3) >= y0))
    return rows, hit


def rasterize_direct_plain(rec, chunk_bb, slists, counts, depth_init,
                           tid_init, width: int, height: int, zn,
                           zf, depth_mode: int = DEPTH_VIEWZ,
                           track_ids: bool = True, tie_tid: bool = False,
                           block_cull: bool = False, band_h: int = 0,
                           y_offset: int = 0, full_height: int | None = None):
    """Plain model of kernel B1's walk on the kernel's own inputs: every
    128x128 tile walks its first counts[t] listed supers in list order and
    evaluates a triangle at a pixel only where its chunk's bbox meets the
    pixel's 16x16 block (rasterize_brute, the plain version the wrapper runs
    for CPU tensors, evaluates every triangle everywhere; the two differ
    only where a sliver's edge functions cover a pixel outside its chunk's
    bbox).  block_cull=True also masks out the pairs that the kernel's cull
    against the block and against the warp's 8x4 rectangle rejects; the
    cull is exact, so the result is the same.  tie_tid as in _resolve.
    band_h: B1a, coverage at band-local rows, the chunk-bbox test at global
    rows (band_h a multiple of 16, as the kernel needs).  y_offset /
    full_height: B1b, a screen band (slists built with the same y_offset):
    the blocks and list tiles are the band's own, coverage and the
    chunk-bbox test at global rows."""
    dev = rec.device
    zp = zparams(zn, zf, dev)
    zn_f, inv_range = zp[0], zp[1]
    fr = _TileFrame(width, height, 128, 128, y_offset,
                    height if full_height is None else full_height, dev,
                    band_h)
    d, t = fr.split(depth_init, 1.0), fr.split(tid_init, -1)
    b, per_step = _KERNEL_BLOCK, _PLAIN_GROUP // _CHUNK
    for i in range(int(counts.max()) if counts.numel() else 0):
        sup = torch.clamp(slists[:, i:i + 1], min=0).to(torch.int64)
        rows, hit = _super_chunks(sup, chunk_bb, fr)
        hit = hit & (i < counts)[:, None, None, None]
        for c0 in range(0, hit.shape[1], per_step):
            if not bool(hit[:, c0:c0 + per_step].any()):
                continue          # no block of any tile meets these chunks
            blk = rec[rows[:, c0 * _CHUNK:(c0 + per_step) * _CHUNK]]
            inside, z01 = _tri_depth(blk, fr, zn_f, inv_range, depth_mode)
            inside &= _per_pixel(hit[:, c0:c0 + per_step], b, b) \
                .repeat_interleave(_CHUNK, dim=1) & fr.ndc_ok[:, None]
            if block_cull:
                inside &= _walk_keep(blk, fr)
            d, t = _resolve(inside, z01, blk[..., 15], d, t, track_ids,
                            tie_tid)
    return fr.join(d), fr.join(t)


def direct_chunk_hits(chunk_bb, slists, counts, width: int, height: int):
    """(T, 8, 8) i64: of tile t's first counts[t] listed supers, the chunks
    whose bbox meets each 16x16 pixel block.  Kernel B1 evaluated all 16
    triangles of such a chunk at all 256 pixels of the block before it
    culled per triangle."""
    fr = _TileFrame(width, height, 128, 128, 0, height, chunk_bb.device)
    n = counts.to(torch.int64)
    hits = torch.zeros((n.numel(), 128 // _KERNEL_BLOCK, 128 // _KERNEL_BLOCK),
                       dtype=torch.int64, device=chunk_bb.device)
    for i in range(int(n.max()) if n.numel() else 0):
        sup = torch.clamp(slists[:, i:i + 1], min=0).to(torch.int64)
        _, hit = _super_chunks(sup, chunk_bb, fr)
        hits += (hit & (i < n)[:, None, None, None]).sum(1)
    return hits


def rasterize_tiled_plain(rec, lists, counts, depth_init, tid_init,
                          width: int, height: int, zn, zf,
                          depth_mode: int = DEPTH_VIEWZ, tile_h: int = 32,
                          tile_w: int = 128, chunk: int = 8,
                          y_offset: int = 0, full_height: int | None = None,
                          block_cull: bool = False):
    """Plain version of kernel B3: walks each tile's first counts[t] list
    entries (rows of rec) in chunks of `chunk`, all tiles at once.
    block_cull=True masks out the (record, pixel) pairs that kernel B3
    never evaluates, those its cull against the pixel's 16x16 block or its
    warp's 8x4 rectangle rejects; the cull is exact, so the result is the
    same."""
    dev = rec.device
    zp = zparams(zn, zf, dev)
    zn_f, inv_range = zp[0], zp[1]
    fr = _TileFrame(width, height, tile_w, tile_h, y_offset,
                    height if full_height is None else full_height, dev)
    d, t = fr.split(depth_init, 1.0), fr.split(tid_init, -1)
    n_max = int(counts.max()) if counts.numel() else 0
    for s in range(0, n_max, chunk):
        ent = lists[:, s:s + chunk]
        blk = rec[torch.clamp(ent, min=0).to(torch.int64)]
        inside, z01 = _tri_depth(blk, fr, zn_f, inv_range, depth_mode)
        live = torch.arange(s, s + ent.shape[1], device=dev)[None] \
            < counts[:, None]
        inside &= live[..., None, None] & fr.ndc_ok[:, None]
        if block_cull:
            inside &= _walk_keep(blk, fr)
        d, t = _resolve(inside, z01, blk[..., 15], d, t, True)
    return fr.join(d), fr.join(t)


def rasterize_chunklist_plain(rec, clists, counts, depth_init, tid_init,
                              width: int, height: int, zn, zf,
                              depth_mode: int = DEPTH_VIEWZ,
                              tile_h: int = 128, tile_w: int = 128,
                              chunk: int = 16, sub_h: int = 32,
                              y_offset: int = 0,
                              full_height: int | None = None,
                              track_ids: bool = True,
                              block_cull: bool = False):
    """Plain version of kernel B4: walks each tile's first counts[t]
    worklist entries, all tiles at once, _PLAIN_GROUP triangles per step;
    an entry only touches the rows of its bands.  block_cull as in
    rasterize_tiled_plain; kernel B4 also skips an entry whose bands miss
    the block's or the warp's rows, which the mask models too."""
    dev = rec.device
    zp = zparams(zn, zf, dev)
    zn_f, inv_range = zp[0], zp[1]
    fr = _TileFrame(width, height, tile_w, tile_h, y_offset,
                    height if full_height is None else full_height, dev)
    d, t = fr.split(depth_init, 1.0), fr.split(tid_init, -1)
    row_band = torch.arange(tile_h, device=dev) // sub_h
    step = max(1, _PLAIN_GROUP // chunk)
    n_max = int(counts.max()) if counts.numel() else 0
    for s in range(0, n_max, step):
        e = clists[:, s:s + step].to(torch.int64)            # (T, g)
        g = e.shape[1]
        live = torch.arange(s, s + g, device=dev)[None] < counts[:, None]
        bs = (e >> 2) & 3
        be = bs + (e & 3)
        rows_ok = ((row_band >= bs[..., None]) & (row_band <= be[..., None])
                   & live[..., None])                        # (T, g, th)
        rows, bands = _chunk_triangles(e, chunk)
        blk = rec[rows]
        inside, z01 = _tri_depth(blk, fr, zn_f, inv_range, depth_mode)
        mask = rows_ok[:, :, None, :].expand(-1, -1, chunk, -1).flatten(1, 2)
        inside &= mask[..., None] & fr.ndc_ok[:, None]
        if block_cull:
            inside &= _walk_keep(blk, fr, bands, sub_h)
        d, t = _resolve(inside, z01, blk[..., 15], d, t, track_ids)
    return fr.join(d), fr.join(t)


def walk_survivors(rec, lists, counts, width: int, height: int,
                   tile_h: int, tile_w: int, chunk: int | None = None,
                   sub_h: int | None = None, y_offset: int = 0,
                   full_height: int | None = None, chunk_bb=None):
    """What kernels B1, B3 and B4 keep of their walks, counted with the
    plain model of their cull on the kernels' own inputs.  chunk=None: lists
    are B3's (setup rows); otherwise B4's worklists of packed entries,
    `chunk` triangles each, in bands of sub_h rows.  With chunk_bb, lists
    are B1's super lists on 128x128 tiles and a triangle is a candidate of a
    block only where its chunk's bbox meets the block.

    Returns (per_block (T, tile_h/16, tile_w/16), per_warp (T, tile_h/4,
    tile_w/8)) i64: of tile t's first counts[t] entries, the triangles that
    survive the cull against each 16x16 pixel block (and whose bands meet
    its rows), and those that also survive it against each 8x4 warp
    rectangle, whose 32 pixels evaluate them."""
    dev = rec.device
    _check_kernel_tiles("walk_survivors", tile_h, tile_w)
    fr = _TileFrame(width, height, tile_w, tile_h, y_offset,
                    height if full_height is None else full_height, dev)
    (ww, wh), b = _KERNEL_WARP, _KERNEL_BLOCK
    n = counts.to(torch.int64)
    per_block = torch.zeros((n.numel(), tile_h // b, tile_w // b),
                            dtype=torch.int64, device=dev)
    per_warp = torch.zeros((n.numel(), tile_h // wh, tile_w // ww),
                           dtype=torch.int64, device=dev)
    per_entry = _SUPER if chunk_bb is not None else (chunk or 1)
    step = _PLAIN_WALK_STEP // per_entry
    for s in range(0, int(n.max()) if n.numel() else 0, step):
        e = lists[:, s:s + step].to(torch.int64)
        live = torch.arange(s, s + e.shape[1], device=dev)[None] < n[:, None]
        live = live[..., None].expand(-1, -1, per_entry).flatten(1)
        bands = None
        if chunk_bb is not None:
            rows, hit = _super_chunks(torch.clamp(e, min=0), chunk_bb, fr)
            live = live[:, :, None, None] \
                & hit.repeat_interleave(_CHUNK, dim=1)
        elif chunk is None:
            rows, live = torch.clamp(e, min=0), live[:, :, None, None]
        else:
            rows, bands = _chunk_triangles(e, chunk)
            live = live[:, :, None, None]
        blk = rec[rows]
        kb = _rect_keep(blk, fr, b, b, bands, sub_h) & live
        kw = _rect_keep(blk, fr, ww, wh, bands, sub_h) \
            & _per_pixel(kb, b // wh, b // ww)
        per_block += kb.sum(1)
        per_warp += kw.sum(1)
    return per_block, per_warp


def listed_rows(lists, counts, chunk: int | None = None):
    """How many distinct setup rows the first counts[t] entries of the
    lists name: what a walk has to read of the records.  chunk as in
    walk_survivors (a listed chunk names `chunk` rows)."""
    live = torch.arange(lists.shape[1], device=lists.device)[None] \
        < counts[:, None]
    e = lists[live]
    if chunk is None:
        return int(torch.unique(e).numel())
    return int(torch.unique(e >> _BAND_BITS).numel()) * chunk


# ---------------------------------------------------------------------------
# Kernel B3: binned raster
# ---------------------------------------------------------------------------

def _tiled_launch(lib, rec, lists, counts, depth_init, tid_init, width,
                  height, zn, zf, depth_mode, tile_h, tile_w, y_offset,
                  full_height, stream, order=None):
    """Launch kernel B3 through the C interface; returns (depth, tid).
    The kernel walks min(counts[t], cap) entries of tile t's list, the
    tiles with the longest walks first (order: tile_order(counts), sorted
    here when not given)."""
    dev = rec.device
    zp = zparams(zn, zf, dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    if order is None:
        order = tile_order(counts)
    err = lib.lsr_tiled_raster(
        rec.data_ptr(), lists.data_ptr(), counts.data_ptr(), order.data_ptr(),
        depth_init.data_ptr(), tid_init.data_ptr(), depth.data_ptr(),
        tid.data_ptr(), width, height, tile_w, tile_h, cdiv(width, tile_w),
        cdiv(height, tile_h), lists.shape[1], zp.data_ptr(), int(y_offset),
        float(full_height - 1), depth_mode, stream)
    check_launch("lsr_tiled_raster", err)
    return depth, tid


def tiled_inputs(setup: TriSetup, width: int, height: int, tile_h: int,
                 tile_w: int, cap: int, chunk: int, y_offset: int = 0,
                 fit_cap: bool = False, pairs: int | None = None):
    """What kernel B3 and its plain version take: (records (n_pad, _REC),
    lists (tiles, cap) i32, entries to walk per tile (tiles,) i32, max_bin
    () i32, n_pairs, over).  fit_cap, pairs, n_pairs and over as in
    bin_triangles."""
    rec, _, _ = pack_direct_records(setup, False)
    lists, counts, max_bin, n_pairs, over = bin_triangles(
        setup, width, height, tile_h, tile_w, cap, y_offset, fit_cap, pairs)
    # lsr_tpu's kernel walks min(ceil(count/chunk), cap//chunk) chunks;
    # counts <= cap already, so no tile walks past its list.
    n_walk = torch.clamp(counts, max=lists.shape[1] // chunk * chunk)
    return rec, lists, n_walk, max_bin, n_pairs, over


def rasterize_tiled(setup: TriSetup, width: int, height: int, zn,
                    zf, depth_init=None, tid_init=None,
                    depth_mode: int = DEPTH_VIEWZ, tile_h: int = 32,
                    tile_w: int = 128, cap: int = 512, chunk: int = 8,
                    y_offset: int = 0, full_height: int | None = None,
                    fit_cap: bool = False, pairs: int | None = None):
    """Tile-parallel binned rasterization.  Returns (depth01 (H, W),
    tid (H, W), max_bin, n_pairs, over).

    max_bin is the largest per-tile triangle count BEFORE capping: if it
    exceeds `cap`, triangles were dropped.  fit_cap=True raises the cap to
    fitted_cap(cap, max_bin) first, so none is.  pairs=P is the capacity
    route of a captured frame (bin_triangles): no host read.  n_pairs ()
    i64 counts the (row, tile) pairs binned, and over () bool is set where
    a triangle was dropped.  y_offset / full_height render global rows
    [y_offset, y_offset + height) of a full_height framebuffer.
    CPU tensors run rasterize_tiled_plain; CUDA tensors launch kernel B3
    (csrc/tiled_raster.cu) or raise."""
    _check_depth_mode("rasterize_tiled", depth_mode)
    full_height = height if full_height is None else full_height
    dev = _device("rasterize_tiled", setup)
    rec, lists, n_walk, max_bin, n_pairs, over = tiled_inputs(
        setup, width, height, tile_h, tile_w, cap, chunk, y_offset, fit_cap,
        pairs)
    depth_init, tid_init = _targets(depth_init, tid_init, height, width, dev)
    if dev.type == "cpu":
        depth, tid = rasterize_tiled_plain(
            rec, lists, n_walk, depth_init, tid_init, width, height, zn, zf,
            depth_mode, tile_h, tile_w, chunk, y_offset, full_height)
        return depth, tid, max_bin, n_pairs, over
    _check_kernel_tiles("rasterize_tiled", tile_h, tile_w)
    _check_cuda_targets("rasterize_tiled", dev, height, width, depth_init,
                        tid_init)
    depth, tid = _tiled_launch(
        load_kernels(), rec, lists, n_walk, depth_init, tid_init, width,
        height, zn, zf, depth_mode, tile_h, tile_w, y_offset, full_height,
        _stream(dev))
    rasterize_tiled.launches += 1
    return depth, tid, max_bin, n_pairs, over


rasterize_tiled.launches = 0


# ---------------------------------------------------------------------------
# Kernel B4: chunk-worklist raster
# ---------------------------------------------------------------------------

def _chunklist_launch(lib, rec, clists, counts, depth_init, tid_init, width,
                      height, zn, zf, depth_mode, tile_h, tile_w, chunk,
                      sub_h, y_offset, full_height, track_ids, stream,
                      order=None):
    """Launch kernel B4 through the C interface; returns (depth, tid).
    The tiles with the longest worklists start first (order:
    tile_order(counts), sorted here when not given)."""
    dev = rec.device
    zp = zparams(zn, zf, dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    if order is None:
        order = tile_order(counts)
    err = lib.lsr_chunklist_raster(
        rec.data_ptr(), clists.data_ptr(), counts.data_ptr(),
        order.data_ptr(), depth_init.data_ptr(), tid_init.data_ptr(),
        depth.data_ptr(),
        tid.data_ptr(), width, height, tile_w, tile_h, cdiv(width, tile_w),
        cdiv(height, tile_h), clists.shape[1], chunk, sub_h, zp.data_ptr(),
        int(y_offset), float(full_height - 1), depth_mode, int(track_ids),
        stream)
    check_launch("lsr_chunklist_raster", err)
    return depth, tid


def chunklist_inputs(setup: TriSetup, width: int, height: int, tile_h: int,
                     tile_w: int, chunk: int, ccap: int | None, sub_h: int,
                     y_offset: int = 0):
    """What kernel B4 and its plain version take: (records (n_pad, _REC),
    worklists (tiles, ccap) i32, counts (tiles,) i32, max_count () i32).
    ccap=None sizes the worklists by the number of chunks."""
    rec, _, n_pad = pack_direct_records(setup, False)
    ccap = max(8, n_pad // chunk if ccap is None else ccap)
    return (rec,) + _chunk_lists(setup, n_pad, chunk, cdiv(width, tile_w),
                                 cdiv(height, tile_h), tile_w, tile_h, ccap,
                                 y_offset, sub_h)


def rasterize_chunklist(setup: TriSetup, width: int, height: int, zn,
                        zf, depth_init=None, tid_init=None,
                        depth_mode: int = DEPTH_VIEWZ, tile_h: int = 128,
                        tile_w: int = 128, chunk: int = 16,
                        ccap: int | None = None, sub_h: int = 32,
                        y_offset: int = 0, full_height: int | None = None,
                        track_ids: bool = True):
    """Chunk-worklist tiled rasterization.  Returns (depth01, tid,
    max_chunks_per_tile).

    ccap=None sizes every worklist by the number of chunks, so none can
    overflow (lsr_tpu also clamped it to its SMEM budget; the port does
    not).  An explicit ccap keeps lsr_tpu's semantics: a tile's entries past
    ccap are dropped and max_chunks_per_tile reports it.
    track_ids=False resolves depth only (tid comes back as tid_init).
    Nothing is read on the host (a captured frame holds it).
    CPU tensors run rasterize_chunklist_plain; CUDA tensors launch kernel B4
    (csrc/chunklist_raster.cu) or raise."""
    if tile_h % sub_h or tile_h // sub_h > 4:
        raise ValueError("rasterize_chunklist: band encoding uses 2 bits: "
                         "tile_h must be a multiple of sub_h and "
                         "tile_h/sub_h <= 4")
    if _SUPER % chunk:
        raise ValueError(f"rasterize_chunklist: chunk {chunk} must divide "
                         f"{_SUPER}")
    _check_depth_mode("rasterize_chunklist", depth_mode)
    full_height = height if full_height is None else full_height
    dev = _device("rasterize_chunklist", setup)
    rec, clists, counts, max_cnt = chunklist_inputs(
        setup, width, height, tile_h, tile_w, chunk, ccap, sub_h, y_offset)
    depth_init, tid_init = _targets(depth_init, tid_init, height, width, dev)
    if dev.type == "cpu":
        depth, tid = rasterize_chunklist_plain(
            rec, clists, counts, depth_init, tid_init, width, height, zn, zf,
            depth_mode, tile_h, tile_w, chunk, sub_h, y_offset, full_height,
            track_ids)
    else:
        _check_kernel_tiles("rasterize_chunklist", tile_h, tile_w)
        _check_cuda_targets("rasterize_chunklist", dev, height, width,
                            depth_init, tid_init)
        depth, tid = _chunklist_launch(
            load_kernels(), rec, clists, counts, depth_init, tid_init, width,
            height, zn, zf, depth_mode, tile_h, tile_w, chunk, sub_h,
            y_offset, full_height, track_ids, _stream(dev))
        rasterize_chunklist.launches += 1
    return depth, (tid if track_ids else tid_init.clone()), max_cnt


rasterize_chunklist.launches = 0
