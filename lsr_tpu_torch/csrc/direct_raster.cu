// Kernel B1: listless tiled visibility rasterizer.
//
// Replaces lsr_tpu/raster/tiled.py:_direct_kernel (wrapper rasterize_direct,
// pallas_call at tiled.py:623).
//
// What bounds it on this card: per (triangle, pixel) pair it does ~20 f32
// operations plus one IEEE division, against 64 bytes of setup record per
// triangle that every pixel of a block reads.  At 1080p with ~51K setup
// rows the work is the pairs that survive the chunk-bbox test, so it is
// bound by issue rate (ALU + the record loads through L1), not by device
// memory: the frame writes 16 MB of depth/tid and reads the setup once per
// block from L2.
//
// What the design does about it: one thread per pixel, one 16x16 block per
// 256 pixels.  The block walks its 128x128 tile's super list (built by torch
// ops, ordered by super id) and tests each 16-triangle chunk's bbox against
// the block's 16x16 footprint, so a chunk costs one uniform branch unless it
// overlaps.  Records are read with 16-byte loads that all threads of a warp
// share (a broadcast from L1).  Each thread owns its pixel, so the resolve is
// a sequential compare in registers: no atomics, no shared memory.
//
// Numerics: the per-(triangle, pixel) arithmetic is lsr::tri_depth
// (raster_common.cuh), in the operation order of lsr_tpu's kernel
// (tiled.py:374-391), so coverage, depth and ids match the plain PyTorch
// version (rasterize_brute) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kTile = 128;   // screen tile of the super lists
constexpr int kBlock = 16;   // pixel block edge (16x16 threads)
constexpr int kChunk = 16;   // triangles per chunk
constexpr int kChunksPerSuper = 16;  // 256-triangle supers

__global__ void __launch_bounds__(kBlock * kBlock)
direct_raster_kernel(const float4* __restrict__ rec,      // (n_pad, 16) f32
                     const float4* __restrict__ chunk_bb, // (n_chunks, 4) f32
                     const int* __restrict__ slists,      // (tiles, scap)
                     const int* __restrict__ counts,      // (tiles,)
                     const float* __restrict__ depth_in,
                     const int* __restrict__ tid_in,
                     float* __restrict__ depth_out,
                     int* __restrict__ tid_out,
                     int width, int height, int tiles_x, int scap,
                     float zn, float inv_range, float max_py,
                     int depth_mode, int track_ids, int tie_tid) {
  const int x = blockIdx.x * kBlock + threadIdx.x;
  const int y = blockIdx.y * kBlock + threadIdx.y;
  const bool in_img = x < width && y < height;
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const bool ndc_ok = px <= (float)(width - 1) && py <= max_py;

  float d = 1.0f;
  int t = -1;
  if (in_img) {
    d = depth_in[y * width + x];
    t = tid_in[y * width + x];
  }

  const float bx0 = (float)(blockIdx.x * kBlock);
  const float bx1 = bx0 + (float)(kBlock - 1);
  const float by0 = (float)(blockIdx.y * kBlock);
  const float by1 = by0 + (float)(kBlock - 1);
  const int tile = (blockIdx.y * kBlock / kTile) * tiles_x
                   + blockIdx.x * kBlock / kTile;
  const int n_sup = counts[tile];
  const int* list = slists + (size_t)tile * scap;

  // Pixels outside the coverage bound (last row/column, padding) never
  // change; they skip the walk.  No barrier follows, so divergence is safe.
  for (int i = 0; ndc_ok && i < n_sup; ++i) {
    const int s = list[i];
    for (int j = 0; j < kChunksPerSuper; ++j) {
      const int c = s * kChunksPerSuper + j;
      const float4 bb = chunk_bb[c];
      if (!(bb.x <= bx1 && bb.z >= bx0 && bb.y <= by1 && bb.w >= by0)) continue;
      for (int k = 0; k < kChunk; ++k) {
        const float4* r = rec + (size_t)(c * kChunk + k) * lsr::kRecVec;
        const float4 r3 = __ldg(r + 3);  // ziw0 ziw1 ziw2 tid
        float z01;
        if (!lsr::tri_depth(__ldg(r), __ldg(r + 1), __ldg(r + 2), r3, px, py,
                            depth_mode, zn, inv_range, z01))
          continue;
        const int tri = (int)r3.w;
        bool upd = z01 < d;
        if (track_ids && tie_tid) upd = upd || (z01 == d && tri < t);
        if (upd) {
          d = z01;
          t = tri;
        }
      }
    }
  }
  if (in_img) {
    depth_out[y * width + x] = d;
    if (track_ids) tid_out[y * width + x] = t;
  }
}

}  // namespace

extern "C" int lsr_direct_raster(const void* rec, const void* chunk_bb,
                                 const void* slists, const void* counts,
                                 const void* depth_in, const void* tid_in,
                                 void* depth_out, void* tid_out,
                                 int width, int height, int tiles_x, int scap,
                                 float zn, float inv_range, float max_py,
                                 int depth_mode, int track_ids, int tie_tid,
                                 void* stream) {
  dim3 block(kBlock, kBlock);
  dim3 grid((width + kBlock - 1) / kBlock, (height + kBlock - 1) / kBlock);
  direct_raster_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float4*)rec, (const float4*)chunk_bb, (const int*)slists,
      (const int*)counts, (const float*)depth_in, (const int*)tid_in,
      (float*)depth_out, (int*)tid_out, width, height, tiles_x, scap, zn,
      inv_range, max_py, depth_mode, track_ids, tie_tid);
  return (int)cudaGetLastError();
}
