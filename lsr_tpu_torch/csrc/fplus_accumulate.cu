// Kernel B6: Forward+ local-light accumulation over binned screen tiles:
// per pixel, the diffuse and specular sums of the tile's lights (no sun; the
// caller combines them with albedo).
//
// Replaces lsr_tpu/lighting/fplus_kernel.py:_fplus_kernel (wrapper
// accumulate_lights_pallas, pallas_call at fplus_kernel.py:298).
//
// What bounds it on this card: operations executed for (pixel, light) pairs
// that add nothing, as for B2 and B5: ~60 f32 operations with two square
// roots and two powf per pair against 28 bytes read and 24 written per
// pixel, and most pairs of a tile's list are out of range, outside a cone
// or facing away.
//
// What the design does about it: B5's light walk (light_walk.cuh), as B2
// takes it.  One thread per pixel, 32x8 blocks inside one light tile (the
// callers' 64x128, 32x128 or 16x128), a warp on an 8x4 rectangle; the
// block takes the tile's list 32 lights at a time, each warp tests them
// against the box of its covered pixels' positions, a group no warp wants
// is not staged, the others are prepared once per light into shared
// memory, and a warp skips light_shade for a light none of its pixels can
// see.  The attenuation pow is always applied, as lsr_tpu's kernel applies
// it.  Each tile walks min(ceil(count/chunk), cap/chunk) chunks
// (fplus_kernel.py:218-219), chunk 8 or 16 (a group is four or two
// chunks); each chunk is summed in light order, then added to the running
// sums, as the plain version does, a skipped light entering as its +0.
//
// The choices, each timed as a patched copy of this source (kernel ms on
// an NVIDIA H100 80GB HBM3 at 700 W, one call, the cut flagship frame's
// G-buffer at 1920x1080, medians of 4, every variant's output equal bit
// for bit to the shipped kernel's and the one before; registers / spilled
// bytes from -Xptxas -v):
//   variant                                   64x128, chunk 16  16x128, 8
//   as built: a copy of the light math per
//   kind, (256, 4): 64 registers, 12 B spilled         0.220      0.184
//   one generic copy of the light math                 0.225      0.188
//   (256, 3): 71 registers, no spill                   0.238      0.203
//   no register bound (64 / 12 B)                      0.220      0.184
//   before this design (every pixel prepares and
//   shades every light; 64 / 16 B)                     0.998      0.774

#include <cuda_runtime.h>

#include "light_walk.cuh"

namespace {

using lsr::kFullMask;
using lsr::kGroup;
using lsr::kRec;
using lsr::kWalkH;
using lsr::kWalkThreads;
using lsr::kWalkW;

template <int CHUNK>
__global__ void __launch_bounds__(kWalkThreads, 4)
fplus_accumulate_kernel(const float* __restrict__ gbuf,      // (8, ph, pw)
                        const float* __restrict__ tile_rec,  // (tiles,cap,32)
                        const int* __restrict__ counts,      // (tiles,)
                        const float* __restrict__ uni,       // (3,)
                        float* __restrict__ diffuse,         // (H, W, 3)
                        float* __restrict__ specular,        // (H, W, 3)
                        int width, int height, int ph, int pw, int tile_h,
                        int tile_w, int tiles_x, int cap) {
  __shared__ lsr::Light lights[kGroup];
  int x, y;
  lsr::walk_pixel(x, y);
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
  const int n_listed =
      min((counts[tile] + CHUNK - 1) / CHUNK, cap / CHUNK) * CHUNK;
  const float* trec = tile_rec + (size_t)tile * cap * kRec;
  const bool warp_covered = __any_sync(kFullMask, covered);
  const lsr::Box box = lsr::warp_box(covered, px, py, pz);
  const lsr::Pixel pix = {px, py, pz, nx, ny, nz, vx, vy, vz, covered};
  const lsr::Planes none = {nullptr, 0, 0, 0, 0};
  auto term = [&](const lsr::Light& L, float v[6]) {
    return lsr::light_terms_of_kind<false>(L, pix, 0, none, v);
  };

  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int g0 = 0; g0 < n_listed; g0 += kGroup) {
    unsigned wm;
    if (!lsr::stage_group(trec, n_listed, g0, warp_covered, box, lights, wm))
      continue;
#pragma unroll 1
    for (int c0 = 0; c0 < kGroup; c0 += CHUNK)
      lsr::add_chunk_in_order<CHUNK>((wm >> c0) & ((1u << CHUNK) - 1u),
                                     lights + c0, acc, term);
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
  if (tile_h % kWalkH || tile_w % kWalkW || (chunk != 8 && chunk != 16)
      || cap % chunk)
    return (int)cudaErrorInvalidValue;
  dim3 grid(pw / kWalkW, ph / kWalkH);
  auto kern = chunk == 16 ? fplus_accumulate_kernel<16>
                          : fplus_accumulate_kernel<8>;
  kern<<<grid, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const float*)gbuf, (const float*)tile_rec, (const int*)counts,
      (const float*)uni, (float*)diffuse, (float*)specular, width, height,
      ph, pw, tile_h, tile_w, tiles_x, cap);
  return (int)cudaGetLastError();
}
