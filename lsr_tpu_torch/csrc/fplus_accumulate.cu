// Kernel B6: Forward+ local-light accumulation over binned screen tiles:
// per pixel, the diffuse and specular sums of the tile's lights (no sun; the
// caller combines them with albedo).
//
// Replaces lsr_tpu/lighting/fplus_kernel.py:_fplus_kernel (wrapper
// accumulate_lights_pallas, pallas_call at fplus_kernel.py:298).
//
// What bounds it on this card: arithmetic, as for B2: ~60 f32 operations
// with two square roots and two powf per (pixel, light), against 28 bytes
// read and 24 written per pixel.
//
// What the design does about it: B2's layout.  One thread per pixel, 32x8
// blocks inside one light tile (the callers' 64x128, 32x128 or 16x128), the
// tile's light records staged in shared memory one chunk (8 or 16 lights) at
// a time and read as broadcasts; the per-light math is light_loop.cuh's,
// with the attenuation pow always applied, as lsr_tpu's kernel applies it.
// Each tile walks min(ceil(count/chunk), cap/chunk) chunks
// (fplus_kernel.py:218-219); each chunk is summed in light order, then
// added to the running sums, as the plain version does.

#include <cuda_runtime.h>

#include "light_loop.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kMaxChunk = 16;
using lsr::kRec;

__global__ void __launch_bounds__(kThreads)
fplus_accumulate_kernel(const float* __restrict__ gbuf,      // (8, ph, pw)
                        const float* __restrict__ tile_rec,  // (tiles,cap,32)
                        const int* __restrict__ counts,      // (tiles,)
                        const float* __restrict__ uni,       // (3,)
                        float* __restrict__ diffuse,         // (H, W, 3)
                        float* __restrict__ specular,        // (H, W, 3)
                        int width, int height, int ph, int pw, int tile_h,
                        int tile_w, int tiles_x, int cap, int chunk) {
  __shared__ float lrec[kMaxChunk * kRec];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int lane = threadIdx.y * kBlockX + threadIdx.x;
  const size_t plane = (size_t)ph * pw;
  const size_t o = (size_t)y * pw + x;

  const float px = gbuf[0 * plane + o], py = gbuf[1 * plane + o],
              pz = gbuf[2 * plane + o];
  const float nx = gbuf[3 * plane + o], ny = gbuf[4 * plane + o],
              nz = gbuf[5 * plane + o];
  const bool covered = gbuf[6 * plane + o] > 0.0f;
  float vx = uni[0] - px, vy = uni[1] - py, vz = uni[2] - pz;
  lsr::unit3(vx, vy, vz);

  const int tile = (y / tile_h) * tiles_x + x / tile_w;  // uniform per block
  const int n_chunks = min((counts[tile] + chunk - 1) / chunk, cap / chunk);
  const float* trec = tile_rec + (size_t)tile * cap * kRec;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ci = 0; ci < n_chunks; ++ci) {
    __syncthreads();
    lsr::stage_chunk(lrec, trec + (size_t)ci * chunk * kRec, chunk * kRec,
                     lane, kThreads);
    __syncthreads();
    float part[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int li = 0; li < chunk; ++li) {
      const float* f = lrec + li * kRec;
      float wd, ws;
      lsr::local_light(f, px, py, pz, nx, ny, nz, vx, vy, vz, covered, 0, wd,
                       ws);
      const float col[3] = {fmaxf(f[13], 0.0f), fmaxf(f[14], 0.0f),
                            fmaxf(f[15], 0.0f)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        part[c] += col[c] * wd;
        part[3 + c] += col[c] * ws;
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[c] += part[c];
  }

  if (x < width && y < height) {
    const size_t q = ((size_t)y * width + x) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      diffuse[q + c] = acc[c];
      specular[q + c] = acc[3 + c];
    }
  }
}

}  // namespace

extern "C" int lsr_fplus_accumulate(const void* gbuf, const void* tile_rec,
                                    const void* counts, const void* uni,
                                    void* diffuse, void* specular, int width,
                                    int height, int ph, int pw, int tile_h,
                                    int tile_w, int tiles_x, int cap,
                                    int chunk, void* stream) {
  if (tile_h % kBlockY || tile_w % kBlockX || chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  dim3 block(kBlockX, kBlockY);
  dim3 grid(pw / kBlockX, ph / kBlockY);
  fplus_accumulate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)gbuf, (const float*)tile_rec, (const int*)counts,
      (const float*)uni, (float*)diffuse, (float*)specular, width, height,
      ph, pw, tile_h, tile_w, tiles_x, cap, chunk);
  return (int)cudaGetLastError();
}
