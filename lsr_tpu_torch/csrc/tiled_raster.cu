// Kernel B3: binned visibility rasterizer over per-tile triangle lists.
//
// Replaces lsr_tpu/raster/tiled.py:_raster_kernel (wrapper rasterize_tiled,
// pallas_call at tiled.py:1019).
//
// Input: the packed setup records (n_pad, 16) f32, resident (lane 15 = setup
// row id, -1 = invalid); per screen tile its list of setup rows in
// submission order (tiles, cap) i32 and the number of entries to walk
// (tiles,); depth/tid (H, W).  lsr_tpu gathers a (tiles, cap, 16) copy of
// the records for the TPU's VMEM; here each block reads its tile's rows
// through the list, so nothing is gathered or padded.
//
// What bounds it on this card: every pixel of a tile tests every entry of
// the tile's list, so the work is sum(tile count) x tile pixels, ~20 f32
// operations and one IEEE division per pair; at 1080p on the high-poly
// scene that is billions of pairs: issue rate.  Device memory traffic is
// small: each 16x16 block reads its tile's list (4 B an entry) and those
// records (64 B each, from L2 after the first block of the tile) once, and
// writes 2 KB of depth/tid.
//
// What the design does about it: one thread per pixel, 16x16 blocks, each
// block inside one tile of the caller's shape.  The block stages the
// records of 16 list entries (1 KB) in shared memory, one 16-byte load per
// thread, then every thread walks them in list order with a strict '<'
// resolve in registers.  That sequential walk equals lsr_tpu's per-chunk
// (min depth, first in chunk) then strict-across-chunks rule, with no
// atomics.  Culling whole chunks per warp is left for a later change.
//
// Numerics: lsr::tri_depth (raster_common.cuh), bit-exact with the plain
// version rasterize_tiled_plain.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

constexpr int kBlock = 16;  // pixel block edge (16x16 threads)
constexpr int kStage = 16;  // records staged in shared memory per step

__global__ void __launch_bounds__(kBlock * kBlock)
tiled_raster_kernel(const float4* __restrict__ rec,   // (n_pad, 16) f32
                    const int* __restrict__ lists,    // (tiles, cap)
                    const int* __restrict__ counts,   // (tiles,)
                    const float* __restrict__ depth_in,
                    const int* __restrict__ tid_in,
                    float* __restrict__ depth_out,
                    int* __restrict__ tid_out,
                    int width, int height, int tile_w, int tile_h,
                    int tiles_x, int cap, float zn, float inv_range,
                    int y_offset, float max_py, int depth_mode) {
  __shared__ float4 srec[kStage * lsr::kRecVec];
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

  // The block lies inside one tile (tile_w, tile_h are multiples of 16).
  const int tile = (blockIdx.y * kBlock / tile_h) * tiles_x
                   + blockIdx.x * kBlock / tile_w;
  const int n = min(counts[tile], cap);  // never past the tile's own list
  const int* list = lists + (size_t)tile * cap;

  for (int s = 0; s < n; s += kStage) {
    const int m = min(kStage, n - s);
    __syncthreads();  // the previous step's records are no longer read
    if (lane < m * lsr::kRecVec) {
      const int row = list[s + lane / lsr::kRecVec];
      srec[lane] = rec[(size_t)row * lsr::kRecVec + lane % lsr::kRecVec];
    }
    __syncthreads();
    if (!ndc_ok) continue;
    for (int k = 0; k < m; ++k) {
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
    tid_out[(size_t)y * width + x] = t;
  }
}

}  // namespace

extern "C" int lsr_tiled_raster(const void* rec, const void* lists,
                                const void* counts, const void* depth_in,
                                const void* tid_in, void* depth_out,
                                void* tid_out, int width, int height,
                                int tile_w, int tile_h, int tiles_x,
                                int tiles_y, int cap, float zn,
                                float inv_range, int y_offset, float max_py,
                                int depth_mode, void* stream) {
  dim3 block(kBlock, kBlock);
  dim3 grid(tiles_x * tile_w / kBlock, tiles_y * tile_h / kBlock);
  tiled_raster_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float4*)rec, (const int*)lists, (const int*)counts,
      (const float*)depth_in, (const int*)tid_in, (float*)depth_out,
      (int*)tid_out, width, height, tile_w, tile_h, tiles_x, cap, zn,
      inv_range, y_offset, max_py, depth_mode);
  return (int)cudaGetLastError();
}
