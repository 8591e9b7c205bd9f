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
// What bounds it on this card: redundant (triangle, pixel) tests, not
// memory.  A tile's pixels would test every entry of its list (4.47e9 pairs
// at 1080p on the 1.1M-triangle scene, whose triangles cover a pixel or
// two: 6.3e6 pairs lie inside bboxes); the listed entries, the records they
// name and the targets are 52 MB, 0.015 ms at the card's memory rate.
// After the cull the limits are the survivors (3.98e8 pairs reach a block's
// queue and 6.3e7 a pixel's evaluation after the warp cull: thin triangles
// survive in every block that straddles the lines of their two long edges,
// also far from the triangle, and 8.9% of a tile's entries survive per
// block instead of the 4% their size suggests), the L2 reads of the cull
// (each of a tile's 32 blocks reads the tile's records), and the longest
// list (29,406 entries against a mean of 2,142).
//
// What the design does about it (block_walk.cuh): a block of 256 threads
// owns 16x16 pixels of one tile and culls its tile's list, 256 entries a
// step, against its own footprint with an exact test of the footprint's
// corners (lsr::rect_reject); survivors are queued in shared memory in list
// order, culled once more per warp (8x4 pixels) and only then evaluated by
// every pixel, with a strict '<' in registers: first submitted wins, no
// atomics.  The launcher orders the tiles by falling list length, so the
// blocks of the longest lists start first.
//
// The choices, measured on an NVIDIA H100 80GB HBM3 at 700 W at the shapes
// above while the walk was designed: each alternative was built, held
// against the plain versions bit for bit and timed by CUDA events in one
// run (ms of B3 / B4, the sort of the tile order included; the design
// without the cull took 7.615 / 5.430 in the same run).  Only the first row
// is kept in the source:
//   as built (256 entries a step, queue of 512 staged records,
//   warp cull, prefetch, longest list first)              0.393 / 0.554
//   no second cull level per warp                         0.789 / 0.974
//   queue of 256 (evaluate after every step) / of 1024    0.435 / 0.611,
//                                                         0.406 / 0.598
//   queue of row ids instead of staged records            0.496 / 0.616
//   no prefetch of the next step's records                0.422 / 0.553
//   512 entries a step (queue 512 / 1024)                 0.440 / 0.783,
//                                                         0.407 / 0.718
//   1024 entries a step, no prefetch                      0.456 / 0.763
//   blocks in raster order                                0.453 / 0.624
// Larger steps cost registers (80-107 against 60-64) and gain nothing: the
// walk is bound by the evaluation, not by the barriers.  With every list
// clamped to 1,837 entries B3 takes 0.175 ms: most of the time is the few
// long lists, which is why their blocks go first.  The prefetch is a
// register pipeline (the next step's ten cull lanes and the list entries of
// the step after it); cp.async into shared memory would stage the same
// bytes and was not needed.
//
// Numerics: lsr::tri_depth and lsr::rect_reject (raster_common.cuh),
// bit-exact with the plain version rasterize_tiled_plain.

#include <cuda_runtime.h>

#include "block_walk.cuh"

namespace {

// Candidate i of a tile is entry i of its list.
struct ListSource {
  const int* __restrict__ list;
  __device__ __forceinline__ void operator()(int i, int& row,
                                             int& bands) const {
    row = __ldg(list + i);
    bands = 0;
  }
};

__global__ void __launch_bounds__(lsr::kThreads)
tiled_raster_kernel(const float4* __restrict__ rec,   // (n_pad, 16) f32
                    const int* __restrict__ lists,    // (tiles, cap)
                    const int* __restrict__ counts,   // (tiles,)
                    const long long* __restrict__ order,  // (tiles,)
                    const float* __restrict__ depth_in,
                    const int* __restrict__ tid_in,
                    float* __restrict__ depth_out,
                    int* __restrict__ tid_out,
                    int width, int height, int tile_w, int tile_h,
                    int tiles_x, int cap,
                    const float* __restrict__ zparams,  // (2,) zn, inv_range
                    int y_offset, float max_py, int depth_mode) {
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

  const int n = min(counts[tile], cap);  // never past the tile's own list
  const ListSource src{lists + (size_t)tile * cap};
  lsr::block_walk<false, false>(src, n, rec, p, 0, 0, 0, depth_mode, zn,
                                inv_range, d, t);
  if (in_img) {
    depth_out[(size_t)p.y * width + p.x] = d;
    tid_out[(size_t)p.y * width + p.x] = t;
  }
}

}  // namespace

extern "C" int lsr_tiled_raster(const void* rec, const void* lists,
                                const void* counts, const void* order,
                                const void* depth_in, const void* tid_in,
                                void* depth_out,
                                void* tid_out, int width, int height,
                                int tile_w, int tile_h, int tiles_x,
                                int tiles_y, int cap, const void* zparams,
                                int y_offset, float max_py,
                                int depth_mode, void* stream) {
  constexpr size_t smem = lsr::walk_smem_bytes(false);
  const int grid = tiles_x * tiles_y * (tile_w / lsr::kBlock)
                   * (tile_h / lsr::kBlock);
  tiled_raster_kernel<<<grid, lsr::kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)rec, (const int*)lists, (const int*)counts,
      (const long long*)order, (const float*)depth_in, (const int*)tid_in,
      (float*)depth_out,
      (int*)tid_out, width, height, tile_w, tile_h, tiles_x, cap,
      (const float*)zparams, y_offset, max_py, depth_mode);
  return (int)cudaGetLastError();
}
