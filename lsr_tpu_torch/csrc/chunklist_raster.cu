// Kernel B4: chunk-worklist visibility rasterizer.
//
// Replaces lsr_tpu/raster/tiled.py:_chunklist_kernel (wrapper
// rasterize_chunklist, pallas_call at tiled.py:912).
//
// Input: the packed setup records (n_pad, 16) f32, resident; per screen tile
// a worklist of the chunks whose bbox overlaps it, in ascending chunk id,
// each entry packed as id << 5 | band_start << 2 | (band_count - 1) with
// bands of sub_h rows; depth/tid (H, W).
//
// What bounds it on this card: redundant (triangle, pixel) tests, not
// memory.  Every triangle of a listed chunk would be tested at every pixel
// of the entry's row bands, across the whole tile width (2.95e9 pairs at
// 1080p on the 1.1M-triangle scene; 6.3e6 lie inside bboxes), while the
// listed entries, the records they name and the targets are 50 MB, 0.015 ms
// at the card's memory rate.  After the cull 3.62e8 pairs reach a block's
// queue and 6.0e7 a pixel's evaluation; what limits the kernel then is the
// survivors' handling and the longest worklist (2,760 entries against a
// mean of 277), as in B3 (tiled_raster.cu).
//
// What the design does about it (block_walk.cuh): a block of 256 threads
// owns 16x16 pixels of one tile.  Its candidates are the triangles of the
// listed chunks, 256 a step (16 entries of 16 triangles), one per thread;
// an entry whose bands miss the block's rows yields none, the block-uniform
// work skip the TPU kernel got from band_body (tiled.py:759-798), and
// costs no record read.  Each candidate is culled against the block with
// the exact corner test lsr::rect_reject; survivors are queued in shared
// memory in list order with their bands, culled once more per warp (8x4
// pixels, and its bands) and then evaluated by the pixels whose row lies in
// the entry's bands, with a strict '<' in registers: first submitted wins,
// no atomics.  One barrier per step, not two per entry.  track_ids=0 keeps
// depth only.  The launcher orders the tiles by falling worklist length.
// The measured choices are listed in tiled_raster.cu.
//
// Numerics: lsr::tri_depth and lsr::rect_reject (raster_common.cuh),
// bit-exact with the plain version rasterize_chunklist_plain.

#include <cuda_runtime.h>

#include "block_walk.cuh"

namespace {

constexpr int kBandBits = 5;

// Candidate i of a tile is triangle i % chunk of worklist entry i / chunk
// (chunk is a power of two).  An entry whose bands miss the block's rows
// [band_lo, band_hi] yields no candidates: the block-uniform work skip the
// TPU kernel got from band_body (tiled.py:759-798).
struct ChunkSource {
  const int* __restrict__ list;
  int chunk_log2, band_lo, band_hi;
  __device__ __forceinline__ void operator()(int i, int& row,
                                             int& bands) const {
    const int e = __ldg(list + (i >> chunk_log2));
    if (!lsr::band_hit(e, band_lo, band_hi)) return;
    bands = e & ((1 << kBandBits) - 1);
    row = (int)(((unsigned)e >> kBandBits) << chunk_log2)
          + (i & ((1 << chunk_log2) - 1));
  }
};

__global__ void __launch_bounds__(lsr::kThreads)
chunklist_raster_kernel(const float4* __restrict__ rec,   // (n_pad, 16)
                        const int* __restrict__ clists,   // (tiles, ccap)
                        const int* __restrict__ counts,   // (tiles,)
                        const long long* __restrict__ order,  // (tiles,)
                        const float* __restrict__ depth_in,
                        const int* __restrict__ tid_in,
                        float* __restrict__ depth_out,
                        int* __restrict__ tid_out,
                        int width, int height, int tile_w, int tile_h,
                        int tiles_x, int ccap, int chunk_log2, int sub_h,
                        const float* __restrict__ zparams,  // zn, inv_range
                        int y_offset, float max_py, int depth_mode,
                        int track_ids) {
  // The z params are data (lsr_tpu's z_ref): one broadcast load a warp.
  const float zn = __ldg(zparams), inv_range = __ldg(zparams + 1);
  // The block lies inside one tile (tile_w, tile_h are multiples of 16).
  int bx, by;
  const int tile = lsr::walk_block(order, tile_w, tile_h, tiles_x, bx, by);
  const lsr::WalkPixel p = lsr::walk_pixel(bx, by, width, y_offset, max_py);
  const bool in_img = p.x < width && p.y < height;
  float d = 1.0f;
  int t = -1;
  if (in_img) {
    d = depth_in[(size_t)p.y * width + p.x];
    t = tid_in[(size_t)p.y * width + p.x];
  }

  // The block's rows, its warps' rows and each pixel's row fall into bands
  // of the tile.
  const int row0 = by % tile_h;
  const int warp_row0 = row0 + (threadIdx.x >> 5) / 2 * lsr::kWarpH;
  const ChunkSource src{clists + (size_t)tile * ccap, chunk_log2,
                        row0 / sub_h, (row0 + lsr::kBlock - 1) / sub_h};
  lsr::block_walk<true, false>(src, counts[tile] << chunk_log2, rec, p,
                               (row0 + p.y % lsr::kBlock) / sub_h,
                               warp_row0 / sub_h,
                               (warp_row0 + lsr::kWarpH - 1) / sub_h,
                               depth_mode, zn, inv_range, d, t);
  if (in_img) {
    depth_out[(size_t)p.y * width + p.x] = d;
    if (track_ids) tid_out[(size_t)p.y * width + p.x] = t;
  }
}

}  // namespace

extern "C" int lsr_chunklist_raster(const void* rec, const void* clists,
                                    const void* counts, const void* order,
                                    const void* depth_in, const void* tid_in,
                                    void* depth_out, void* tid_out, int width,
                                    int height,
                                    int tile_w, int tile_h, int tiles_x,
                                    int tiles_y, int ccap, int chunk,
                                    int sub_h, const void* zparams,
                                    int y_offset, float max_py,
                                    int depth_mode, int track_ids,
                                    void* stream) {
  int chunk_log2 = 0;
  while ((1 << chunk_log2) < chunk) ++chunk_log2;
  if ((1 << chunk_log2) != chunk) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = lsr::walk_smem_bytes(true);
  const int grid = tiles_x * tiles_y * (tile_w / lsr::kBlock)
                   * (tile_h / lsr::kBlock);
  chunklist_raster_kernel<<<grid, lsr::kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const float4*)rec, (const int*)clists, (const int*)counts,
      (const long long*)order, (const float*)depth_in, (const int*)tid_in,
      (float*)depth_out,
      (int*)tid_out, width, height, tile_w, tile_h, tiles_x, ccap, chunk_log2,
      sub_h, (const float*)zparams, y_offset, max_py, depth_mode, track_ids);
  return (int)cudaGetLastError();
}
