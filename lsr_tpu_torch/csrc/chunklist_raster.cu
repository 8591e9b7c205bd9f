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
// What bounds it on this card: per (triangle, pixel) pair ~20 f32
// operations and one IEEE division, over the pairs whose chunk overlaps the
// pixel's row band: issue rate.  Device memory moves each listed chunk's
// 1 KB of records once per 16x16 block that evaluates it, plus the lists
// (4 B an entry) that every block of a tile reads.
//
// What the design does about it: one thread per pixel, 16x16 blocks inside
// one tile.  A block walks its tile's worklist in order and skips an entry
// whose band range misses its 16 rows (a block-uniform test, the work skip
// the TPU kernel got from band_body, tiled.py:759-798); otherwise it stages
// the chunk's records in shared memory and every thread whose row lies in
// the entry's bands resolves them with a strict '<' in registers: first
// submitted wins, no atomics.  track_ids=0 keeps depth only.
//
// Numerics: lsr::tri_depth (raster_common.cuh), bit-exact with the plain
// version rasterize_chunklist_plain.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

constexpr int kBlock = 16;  // pixel block edge (16x16 threads)
constexpr int kBandBits = 5;

__global__ void __launch_bounds__(kBlock * kBlock)
chunklist_raster_kernel(const float4* __restrict__ rec,   // (n_pad, 16)
                        const int* __restrict__ clists,   // (tiles, ccap)
                        const int* __restrict__ counts,   // (tiles,)
                        const float* __restrict__ depth_in,
                        const int* __restrict__ tid_in,
                        float* __restrict__ depth_out,
                        int* __restrict__ tid_out,
                        int width, int height, int tile_w, int tile_h,
                        int tiles_x, int ccap, int chunk, int sub_h,
                        float zn, float inv_range, int y_offset, float max_py,
                        int depth_mode, int track_ids) {
  extern __shared__ float4 srec[];  // chunk records, kRecVec float4 each
  const int x = blockIdx.x * kBlock + threadIdx.x;
  const int y = blockIdx.y * kBlock + threadIdx.y;
  const int lane = threadIdx.y * kBlock + threadIdx.x;
  const bool in_img = x < width && y < height;
  const float px = (float)x + 0.5f;
  const float py = (float)(y + y_offset) + 0.5f;
  const bool ndc_ok = px <= (float)(width - 1) && py <= max_py;

  float d = 1.0f;
  int t = -1;
  if (in_img) {
    d = depth_in[(size_t)y * width + x];
    t = tid_in[(size_t)y * width + x];
  }

  // The block lies inside one tile (tile_w, tile_h are multiples of 16);
  // its rows span bands [band_lo, band_hi] of that tile.
  const int row0 = blockIdx.y * kBlock % tile_h;
  const int band_lo = row0 / sub_h;
  const int band_hi = (row0 + kBlock - 1) / sub_h;
  const int my_band = (row0 + (int)threadIdx.y) / sub_h;
  const int tile = (blockIdx.y * kBlock / tile_h) * tiles_x
                   + blockIdx.x * kBlock / tile_w;
  const int n = counts[tile];
  const int* list = clists + (size_t)tile * ccap;
  const int n_vec = chunk * lsr::kRecVec;

  for (int i = 0; i < n; ++i) {
    const int e = list[i];
    const int bs = (e >> 2) & 3;
    const int be = bs + (e & 3);
    if (band_hi < bs || band_lo > be) continue;  // uniform across the block
    const float4* src = rec + (size_t)((unsigned)e >> kBandBits) * n_vec;
    __syncthreads();  // the previous entry's records are no longer read
    for (int j = lane; j < n_vec; j += kBlock * kBlock) srec[j] = src[j];
    __syncthreads();
    if (!ndc_ok || my_band < bs || my_band > be) continue;
    for (int k = 0; k < chunk; ++k) {
      const float4* r = srec + lsr::kRecVec * k;
      float z01;
      if (lsr::tri_depth(r[0], r[1], r[2], r[3], px, py, depth_mode, zn,
                         inv_range, z01)
          && z01 < d) {
        d = z01;
        t = (int)r[3].w;
      }
    }
  }
  if (in_img) {
    depth_out[(size_t)y * width + x] = d;
    if (track_ids) tid_out[(size_t)y * width + x] = t;
  }
}

}  // namespace

extern "C" int lsr_chunklist_raster(const void* rec, const void* clists,
                                    const void* counts, const void* depth_in,
                                    const void* tid_in, void* depth_out,
                                    void* tid_out, int width, int height,
                                    int tile_w, int tile_h, int tiles_x,
                                    int tiles_y, int ccap, int chunk,
                                    int sub_h, float zn, float inv_range,
                                    int y_offset, float max_py,
                                    int depth_mode, int track_ids,
                                    void* stream) {
  dim3 block(kBlock, kBlock);
  dim3 grid(tiles_x * tile_w / kBlock, tiles_y * tile_h / kBlock);
  const size_t smem = (size_t)chunk * lsr::kRecVec * sizeof(float4);
  chunklist_raster_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float4*)rec, (const int*)clists, (const int*)counts,
      (const float*)depth_in, (const int*)tid_in, (float*)depth_out,
      (int*)tid_out, width, height, tile_w, tile_h, tiles_x, ccap, chunk,
      sub_h, zn, inv_range, y_offset, max_py, depth_mode, track_ids);
  return (int)cudaGetLastError();
}
