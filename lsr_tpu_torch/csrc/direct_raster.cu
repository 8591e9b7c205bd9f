// Kernel B1: listless tiled visibility rasterizer.
//
// Replaces lsr_tpu/raster/tiled.py:_direct_kernel (wrapper rasterize_direct,
// pallas_call at tiled.py:623).
//
// Input: the packed setup records (n_pad, 16) f32, resident, grouped in
// supers of 256 rows made of 16-row chunks; the chunks' bboxes; per 128x128
// screen tile the list of supers whose bbox overlaps it, in row order;
// optional depth / tid targets (H, W).
//
// What bounds it on this card: redundant (triangle, pixel) tests and the
// latency of a short dependent walk, not memory (the frame writes 16.6 MB
// of depth and tid and reads 3.4 MB of records).  A chunk whose bbox meets
// a 16x16 block had all 16 triangles evaluated at all 256 pixels: 7.06e7
// pairs on the 1080p flagship view (1.50e8 on its 2048^2 sun map) for
// 2.70e6 (3.50e6) pairs inside valid bboxes, through a walk in which every
// thread read list entry, chunk bbox and records one dependent load after
// another.  A tile lists 2.9 supers on average (at most 13), so a block's
// walk is a few steps long and what is left is mostly its latency: with
// the walk compiled out the launch takes 0.007 ms (0.012 ms at 2048^2).
//
// What the design does about it: B1 is a third source of the
// cull-and-evaluate walk of block_walk.cuh.  One step takes one listed
// super: thread k takes its triangle k, the 16 threads of a chunk share
// the chunk's bbox test against the block (kept at the block's grain, so
// the set of (triangle, pixel) pairs that can win is what it always was),
// then the exact per-triangle cull against the block (lsr::rect_reject),
// the survivors queued in row order in shared memory (9.6e6 pairs; 2.2e7
// on the sun map), culled once more per 8x4 warp rectangle (3.1e6; 5.7e6)
// and evaluated per pixel in registers, strict '<' for the unsorted rows,
// (depth, id) order for spatially sorted ones.  List entry and chunk bbox
// are prefetched two steps ahead, the cull lanes one.  Without targets
// from the caller the walk starts from depth 1 / id -1 and reads none.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (kernel ms by CUDA events;
// torch.profiler's device time agrees): 0.065 ms on the camera view, 0.122
// ms on the sun map (0.296 / 0.563 before the cull).  A queue of 256
// records instead of 512 gave 0.069 / 0.124, the same: B1's lists are
// short and a block queues 4.3 survivors on average, so the choices
// measured for B3 and B4 (tiled_raster.cu) are kept as they are.
//
// Numerics: lsr::tri_depth and lsr::rect_reject (raster_common.cuh), in the
// operation order of lsr_tpu's kernel (tiled.py:374-391), so coverage,
// depth and ids match the plain PyTorch version (rasterize_brute) bit for
// bit wherever the winner lies inside its chunk's bbox.
//
// The stacked shadow atlas (variant B1a, band_h; lsr_tpu tiled.py:309-318)
// renders n slots of band_h rows in one launch.  Each slot's setup rows are
// slot-local and padded to whole supers, only their bboxes are shifted to
// the slot's global rows.  A 16x16 block lies inside one band, evaluates at
// its band-local rows and takes a chunk only if the chunk's global bbox
// meets it, so no slot's triangle reaches another slot's pixels, and each
// slot is bit for bit its own launch.  A 128-row list tile may span two
// bands of 64 rows: it then lists both slots' supers, which the chunk test
// skips.
//
// A screen band (variant B1b, y_offset; lsr_tpu tiled.py:60-79, :259-270)
// renders global rows [y_offset, y_offset + height) of a frame of
// full_height rows.  The grid, the 16x16 blocks and the 128-row list tiles
// are the band's own (a block never leaves the band, whatever the offset,
// so 1080 / 4 = 270-row bands need no alignment); the super lists were
// built on those tiles from the global chunk boxes less y_offset; a pixel
// evaluates coverage at its global row, bounded by full_height - 1, and a
// block tests the chunk boxes at its global rows.  Every pixel thus sees
// the candidates and arithmetic of the whole frame's launch, so the bands
// concatenate to it bit for bit (off the stray sliver pixels a chunk box
// misses, which the two launches' blocks may cover differently).  Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 26, kernel ms
// by CUDA events): 0.022-0.055 ms a 270-row band of the 1080p camera,
// 0.026-0.058 a 512-row band of the 2048^2 sun map; four bands take 1.5-2.8x
// one whole-frame launch, each paying the walk's latency again.

#include <cuda_runtime.h>

#include "block_walk.cuh"

namespace {

constexpr int kTile = 128;           // screen tile of the super lists
constexpr int kSuper = lsr::kStep;   // triangles per super: one walk step
constexpr int kChunk = 16;           // triangles per chunk
constexpr int kChunksPerSuper = kSuper / kChunk;

// Candidate i of a tile is triangle i % 256 of listed super i / 256, if the
// bbox of its 16-triangle chunk meets the block's 16x16 pixels (the first
// and last pixel, as the chunk bboxes are stored: inclusive pixel indices).
struct SuperSource {
  const int* __restrict__ list;
  const float4* __restrict__ chunk_bb;
  float x0, x1, y0, y1;
  __device__ __forceinline__ void operator()(int i, int& row,
                                             int& bands) const {
    const int s = __ldg(list + i / kSuper), k = i % kSuper;
    const float4 bb = __ldg(chunk_bb + s * kChunksPerSuper + k / kChunk);
    if (bb.x <= x1 && bb.z >= x0 && bb.y <= y1 && bb.w >= y0)
      row = s * kSuper + k;
  }
};

template <bool kTieTid>
__global__ void __launch_bounds__(lsr::kThreads)
direct_raster_kernel(const float4* __restrict__ rec,      // (n_pad, 16) f32
                     const float4* __restrict__ chunk_bb, // (n_chunks, 4) f32
                     const int* __restrict__ slists,      // (tiles, scap)
                     const int* __restrict__ counts,      // (tiles,)
                     const float* __restrict__ depth_in,  // or null: 1.0
                     const int* __restrict__ tid_in,      // or null: -1
                     float* __restrict__ depth_out,
                     int* __restrict__ tid_out,
                     int width, int height, int tiles_x, int scap,
                     const float* __restrict__ zparams,  // (2,) zn, inv_range
                     float max_py, int depth_mode, int track_ids, int band_h,
                     int y_offset) {
  // The z params are data (lsr_tpu's z_ref): one broadcast load a warp.
  const float zn = __ldg(zparams), inv_range = __ldg(zparams + 1);
  const int bx = blockIdx.x * lsr::kBlock, by = blockIdx.y * lsr::kBlock;
  // A band_h stack (B1a): the block's coverage rows are its rows inside its
  // band (band_h is a multiple of the block), bounded by band_h - 1; its
  // lists and chunk bboxes stay in global rows.  A screen band (B1b): the
  // coverage rows are the global rows by + y_offset + ..., bounded by
  // max_py = full_height - 1.  The two never combine (the launcher refuses
  // it), so one of band_off and y_offset is 0.
  const int band_off = band_h ? -(by / band_h) * band_h : y_offset;
  const lsr::WalkPixel p = lsr::walk_pixel(
      bx, by, width, band_off, band_h ? (float)(band_h - 1) : max_py);
  const bool in_img = p.x < width && p.y < height;
  float d = 1.0f;
  int t = -1;
  if (in_img) {
    if (depth_in) d = depth_in[(size_t)p.y * width + p.x];
    if (tid_in) t = tid_in[(size_t)p.y * width + p.x];
  }
  const int t_init = t;

  // The list tile is the band's own (lists built less y_offset); the
  // chunk boxes are global, so the block tests them at its global rows.
  const int tile = (by / kTile) * tiles_x + bx / kTile;
  const int gy = by + y_offset;
  const SuperSource src{slists + (size_t)tile * scap, chunk_bb, (float)bx,
                        (float)(bx + lsr::kBlock - 1), (float)gy,
                        (float)(gy + lsr::kBlock - 1)};
  lsr::block_walk<false, kTieTid>(src, counts[tile] * kSuper, rec, p, 0, 0, 0,
                                  depth_mode, zn, inv_range, d, t);
  if (in_img) {
    depth_out[(size_t)p.y * width + p.x] = d;
    tid_out[(size_t)p.y * width + p.x] = track_ids ? t : t_init;
  }
}

}  // namespace

// depth_in / tid_in may be null: the walk then starts from a cleared target
// (depth 1, id -1).  track_ids 0: depth only, tid_out gets the ids the walk
// started from.  tie_tid: an exact depth tie goes to the smaller id
// (spatially sorted rows); else to the earlier row.  band_h > 0: a stack of
// height / band_h slots (a multiple of 16, unsorted rows), each evaluated at
// its band-local rows.  y_offset: the target is global rows [y_offset,
// y_offset + height) of a frame whose last row center max_py bounds
// (full_height - 1); slists are the band's.  band_h and y_offset together
// are refused.
extern "C" int lsr_direct_raster(const void* rec, const void* chunk_bb,
                                 const void* slists, const void* counts,
                                 const void* depth_in, const void* tid_in,
                                 void* depth_out, void* tid_out,
                                 int width, int height, int tiles_x, int scap,
                                 const void* zparams, float max_py,
                                 int depth_mode, int track_ids, int tie_tid,
                                 int band_h, int y_offset, void* stream) {
  if (band_h % lsr::kBlock || (band_h && tie_tid) || (band_h && y_offset)
      || y_offset < 0)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = lsr::walk_smem_bytes(false);
  dim3 grid((width + lsr::kBlock - 1) / lsr::kBlock,
            (height + lsr::kBlock - 1) / lsr::kBlock);
  auto kern = track_ids && tie_tid ? direct_raster_kernel<true>
                                   : direct_raster_kernel<false>;
  kern<<<grid, lsr::kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)rec, (const float4*)chunk_bb, (const int*)slists,
      (const int*)counts, (const float*)depth_in, (const int*)tid_in,
      (float*)depth_out, (int*)tid_out, width, height, tiles_x, scap,
      (const float*)zparams, max_py, depth_mode, track_ids, band_h, y_offset);
  return (int)cudaGetLastError();
}
