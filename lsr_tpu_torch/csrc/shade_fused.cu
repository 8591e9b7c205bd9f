// Kernel B2: fused sun BRDF + binned local lights.
//
// Replaces lsr_tpu/lighting/shade_kernel.py:_shade_kernel (wrapper
// shade_fused_pallas, pallas_call at shade_kernel.py:510).
//
// What bounds it on this card: arithmetic.  Per (pixel, light) it runs ~60
// f32 operations with two square roots, one or two powf and, for spots, two
// cosf; at 1080p with up to 256 binned lights per 64x128 tile that is far
// above the 13 G-buffer planes (2 MB each) it reads and the 25 MB it writes.
//
// What the design does about it: one thread per pixel; a 32x8 block lies
// inside one 64x128 light tile, so every thread of a block walks the same
// list.  The block stages each chunk of 8 light records (8 x 32 f32 = 1 KB)
// in shared memory, one float per thread, then all threads read each field
// as a shared-memory broadcast.  Light-type branches are uniform across the
// block (same light for every thread), so they cost no divergence, and
// absent types cost nothing.  The walk is min(ceil(count/8), cap/8) chunks,
// as in lsr_tpu (shade_kernel.py:342-346); list slots past the count hold
// zero records and add exactly zero.  The sun term and the per-light math
// live in light_loop.cuh, shared with B5 and B6.
//
// Local-shadow planes (variant B2a; lsr_tpu shade_kernel.py:270-294): record
// lane 28 holds the light's plane, plane K the constant 1.0 of unshadowed
// lights.  lsr_tpu sums a one-hot select over all K + 1 planes for every
// light of a chunk that holds a shadowed one; here a shadowed light (plane
// < K) reads its own plane's texel, once per pixel, and the gain of every
// other light is multiplied by 1.0, which leaves it as it is.

#include <cuda_runtime.h>

#include "light_loop.cuh"

namespace {

constexpr int kTileH = 64;
constexpr int kTileW = 128;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kChunk = 8;
using lsr::kRec;

// kPlanes: the launch has local-shadow planes; planeless launches take a
// copy without the plane code.  Four blocks an SM (64 registers).  Kernel
// ms from `python -m lsr_tpu_torch.utils.b2_variants` on an NVIDIA H100
// 80GB HBM3 at 700 W, one call, 1920x1080, medians of 4:
//   variant                   ESM, planes  ESM, none  cut frame  high-poly
//   two copies, (256, 4)            0.507      0.477      0.477      0.243
//   one kernel, (256, 4)            0.507      0.506      0.507      0.258
//   two copies, no bound            0.525      0.475      0.476      0.245
//   one kernel, no bound (79 reg)   0.526      0.525      0.527      0.238
// One kernel costs planeless launches 6%, so the copy stays; the bound
// saves the planes launch 3.5% and the copy nothing.
template <bool kPlanes>
__global__ void __launch_bounds__(kBlockX * kBlockY, 4)
shade_fused_kernel(const float* __restrict__ gbuf,      // (16, ph, pw)
                   const float* __restrict__ tile_rec,  // (tiles, cap, 32)
                   const int* __restrict__ counts,      // (tiles,)
                   const float* __restrict__ uni,       // (9,)
                   const float* __restrict__ vis,       // (K + 1, H, W)
                   int n_shadowed,                      // K
                   float* __restrict__ out,             // (H, W, 3)
                   int width, int height, int ph, int pw, int tiles_x,
                   int cap, int sun_model, int apow1) {
  __shared__ float lrec[kChunk * kRec];
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
  const float ar = gbuf[7 * plane + o], ag = gbuf[8 * plane + o],
              ab = gbuf[9 * plane + o];
  const float metal = lsr::clampf(gbuf[10 * plane + o], 0.0f, 1.0f);
  const float rough = gbuf[11 * plane + o];
  const float sun_vis = gbuf[12 * plane + o];
  const bool inb = x < width && y < height;
  const size_t ovis = (size_t)y * width + x, vis_plane = (size_t)width * height;

  float vx = uni[0] - px, vy = uni[1] - py, vz = uni[2] - pz;
  lsr::unit3(vx, vy, vz);

  // --- sun term (L = -sun_dir, unit) ---------------------------------------
  float dr, dg, db;
  lsr::sun_term(sun_model, nx, ny, nz, vx, vy, vz, -uni[3], -uni[4], -uni[5],
                ar, ag, ab, metal, rough, uni[6], uni[7], uni[8], dr, dg, db);
  dr = dr * sun_vis;
  dg = dg * sun_vis;
  db = db * sun_vis;

  // --- local lights of this block's tile -----------------------------------
  const int tile = (y / kTileH) * tiles_x + x / kTileW;  // uniform per block
  const int count = counts[tile];
  const int n_chunks = min((count + kChunk - 1) / kChunk, cap / kChunk);
  const float* trec = tile_rec + (size_t)tile * cap * kRec;

  float ldr = 0.0f, ldg = 0.0f, ldb = 0.0f;
  float lsr_ = 0.0f, lsg = 0.0f, lsb = 0.0f;
  for (int ci = 0; ci < n_chunks; ++ci) {
    __syncthreads();
    lrec[lane] = trec[ci * kChunk * kRec + lane];  // 256 threads, 256 floats
    __syncthreads();
    float cdr = 0.0f, cdg = 0.0f, cdb = 0.0f;
    float csr = 0.0f, csg = 0.0f, csb = 0.0f;
#pragma unroll 1
    for (int li = 0; li < kChunk; ++li) {
      const float* f = lrec + li * kRec;
      const float sidx = f[28];
      const float lvis = kPlanes && inb && sidx < (float)n_shadowed
                             ? vis[(size_t)sidx * vis_plane + ovis]
                             : 1.0f;
      float wd, ws;
      lsr::local_light(f, px, py, pz, nx, ny, nz, vx, vy, vz, covered, apow1,
                       wd, ws, lvis);
      const float colr = fmaxf(f[13], 0.0f), colg = fmaxf(f[14], 0.0f),
                  colb = fmaxf(f[15], 0.0f);
      cdr += colr * wd;
      cdg += colg * wd;
      cdb += colb * wd;
      csr += colr * ws;
      csg += colg * ws;
      csb += colb * ws;
    }
    ldr += cdr;
    ldg += cdg;
    ldb += cdb;
    lsr_ += csr;
    lsg += csg;
    lsb += csb;
  }

  if (inb) {
    const float covf = covered ? 1.0f : 0.0f;
    float* po = out + ((size_t)y * width + x) * 3;
    po[0] = (dr + ar * ldr + lsr_) * covf;
    po[1] = (dg + ag * ldg + lsg) * covf;
    po[2] = (db + ab * ldb + lsb) * covf;
  }
}

}  // namespace

// vis may be null (n_shadowed 0): no local-shadow planes.
extern "C" int lsr_shade_fused(const void* gbuf, const void* tile_rec,
                               const void* counts, const void* uni,
                               const void* vis, int n_shadowed, void* out,
                               int width, int height, int ph, int pw,
                               int tiles_x, int cap, int sun_model, int apow1,
                               void* stream) {
  if (n_shadowed && !vis) return (int)cudaErrorInvalidValue;
  dim3 block(kBlockX, kBlockY);
  dim3 grid(pw / kBlockX, ph / kBlockY);
  auto kern =
      n_shadowed ? shade_fused_kernel<true> : shade_fused_kernel<false>;
  kern<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)gbuf, (const float*)tile_rec, (const int*)counts,
      (const float*)uni, (const float*)vis, n_shadowed, (float*)out, width,
      height, ph, pw, tiles_x, cap, sun_model, apow1);
  return (int)cudaGetLastError();
}
