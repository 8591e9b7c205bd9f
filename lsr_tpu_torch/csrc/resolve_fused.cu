// Kernel B5: the fused resolve, visibility buffer -> lit HDR in one pass:
// barycentrics, world position and normal, material, sun BRDF x sun
// visibility, the binned local-light loop, fake-IBL ambient, emissive and
// the background.
//
// Replaces lsr_tpu/lighting/resolve_kernel.py:_resolve_kernel (wrapper
// resolve_fused_pallas, pallas_call at resolve_kernel.py:537).
//
// What bounds it on this card: arithmetic, as for B2: ~60 f32 operations
// with two square roots and one or two powf per (pixel, light), over up to
// 256 binned lights per 64x128 tile, against ~40 bytes read and 12 written
// per pixel.
//
// What the design does about it: one thread per pixel, 32x8 blocks inside
// one 64x128 light tile, the tile's light records staged in shared memory
// one chunk (8 or 16 lights, 1-2 KB) at a time and read as broadcasts, as in
// B2.  Records through tid: lsr_tpu gathers a (H, W, 56) record per pixel
// in XLA first (465 MB at 1080p) because a TPU kernel cannot gather; here
// each covered thread reads the 31 lanes it needs of its triangle's row of
// pack_interp_records' (rows, 56) table directly, and neighbouring pixels
// share rows in cache.  An uncovered pixel reads row 0, as lsr_tpu's
// gather of a clamped tid does, and gets the background.  Each chunk's
// eight or sixteen per-light terms are summed as lsr_tpu's pairwise tree
// (_sum0, resolve_kernel.py:50-62), then added to the running sums; the
// plain version uses the same order.

#include <cuda_runtime.h>

#include "light_loop.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kRecLanes = 56;
using lsr::kRec;

// Fake-IBL environment: ground + ((horizon + (zenith - horizon) * up) -
// ground) * up, with lsr_tpu's constants (zenith - horizon is folded in
// double, as Python folds it, then rounded to f32).
__device__ __forceinline__ float env(float up, float g, float h, float zh) {
  return g + ((h + zh * up) - g) * up;
}

template <int CHUNK>
__global__ void __launch_bounds__(kThreads)
resolve_fused_kernel(const float* __restrict__ table,     // (rows, 56)
                     const int* __restrict__ tid,         // (H, W)
                     const float* __restrict__ sun_vis,   // (H, W)
                     const float* __restrict__ tex,       // (H, W, 3)
                     const float* __restrict__ tile_rec,  // (tiles, cap, 32)
                     const int* __restrict__ counts,      // (tiles,)
                     const float* __restrict__ uni,       // (12,)
                     float* __restrict__ out,             // (H, W, 3)
                     int width, int height, int tile_h, int tile_w,
                     int tiles_x, int cap, int sun_model) {
  constexpr int kLevels = CHUNK == 16 ? 5 : 4;  // log2(CHUNK) + 1
  __shared__ float lrec[CHUNK * kRec];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int lane = threadIdx.y * kBlockX + threadIdx.x;
  const bool inb = x < width && y < height;
  const size_t o = (size_t)y * width + x;

  const int t = inb ? tid[o] : -1;
  const bool covered = t >= 0;
  const float* r = table + (size_t)(covered ? t : 0) * kRecLanes;

  // --- interp: weights from the coef lanes at this pixel's centre ----------
  const float sx = (float)x + 0.5f, sy = (float)y + 0.5f;
  float w0 = (r[0] * sx + r[1] * sy + r[2]) * r[9];
  float w1 = (r[3] * sx + r[4] * sy + r[5]) * r[10];
  float w2 = (r[6] * sx + r[7] * sy + r[8]) * r[11];
  const float inv_den = 1.0f / fmaxf(w0 + w1 + w2, 1e-12f);
  w0 = w0 * inv_den;
  w1 = w1 * inv_den;
  w2 = w2 * inv_den;
  const float px = w0 * r[12] + w1 * r[15] + w2 * r[18];
  const float py = w0 * r[13] + w1 * r[16] + w2 * r[19];
  const float pz = w0 * r[14] + w1 * r[17] + w2 * r[20];
  float nx = w0 * r[21] + w1 * r[24] + w2 * r[27];
  float ny = w0 * r[22] + w1 * r[25] + w2 * r[28];
  float nz = w0 * r[23] + w1 * r[26] + w2 * r[29];
  {
    const float nl = lsr::rsqrt_rn(fmaxf(nx * nx + ny * ny + nz * nz, 1e-24f));
    nx = nx * nl;
    ny = ny * nl;
    nz = nz * nl;
  }

  // --- material: lanes 40:56 (pack_material_records) x texture albedo -----
  const float tr = inb ? tex[o * 3 + 0] : 0.0f;
  const float tg = inb ? tex[o * 3 + 1] : 0.0f;
  const float tb = inb ? tex[o * 3 + 2] : 0.0f;
  const float ar = fmaxf(r[40], 0.0f) * tr;
  const float ag = fmaxf(r[41], 0.0f) * tg;
  const float ab = fmaxf(r[42], 0.0f) * tb;
  const float metal = lsr::clampf(r[43], 0.0f, 1.0f);
  const float rough = r[44];
  const float ao = lsr::clampf(r[45], 0.0f, 1.0f);
  const float svis = inb ? sun_vis[o] : 0.0f;

  float vx = uni[0] - px, vy = uni[1] - py, vz = uni[2] - pz;
  lsr::unit3(vx, vy, vz);

  // --- sun term ------------------------------------------------------------
  float dr, dg, db;
  lsr::sun_term(sun_model, nx, ny, nz, vx, vy, vz, -uni[3], -uni[4], -uni[5],
                ar, ag, ab, metal, rough, uni[6], uni[7], uni[8], dr, dg, db);
  dr = dr * svis;
  dg = dg * svis;
  db = db * svis;

  // --- local lights of this block's tile -----------------------------------
  const int tile = (y / tile_h) * tiles_x + x / tile_w;  // uniform per block
  const int n_chunks = min((counts[tile] + CHUNK - 1) / CHUNK, cap / CHUNK);
  const float* trec = tile_rec + (size_t)tile * cap * kRec;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ci = 0; ci < n_chunks; ++ci) {
    __syncthreads();
    lsr::stage_chunk(lrec, trec + (size_t)ci * CHUNK * kRec, CHUNK * kRec,
                     lane, kThreads);
    __syncthreads();
    // Pairwise tree over the chunk as a binary counter: st[b] holds the sum
    // of the last complete block of 2^b lights.
    float st[kLevels][6];
#pragma unroll
    for (int li = 0; li < CHUNK; ++li) {
      const float* f = lrec + li * kRec;
      float wd, ws;
      lsr::local_light(f, px, py, pz, nx, ny, nz, vx, vy, vz, covered, 0, wd,
                       ws);
      const float colr = fmaxf(f[13], 0.0f), colg = fmaxf(f[14], 0.0f),
                  colb = fmaxf(f[15], 0.0f);
      float v[6] = {colr * wd, colg * wd, colb * wd,
                    colr * ws, colg * ws, colb * ws};
      int level = 0;
#pragma unroll
      for (int b = 0; b < kLevels - 1; ++b) {
        if (!((li >> b) & 1)) break;
#pragma unroll
        for (int c = 0; c < 6; ++c) v[c] = st[b][c] + v[c];
        level = b + 1;
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) st[level][c] = v[c];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[c] = acc[c] + st[kLevels - 1][c];
  }

  // --- fake-IBL ambient (eval_fake_ibl) ------------------------------------
  const float ndv_c = nx * vx + ny * vy + nz * vz;
  const float rvy = 2.0f * ndv_c * ny - vy;
  const float up_n = lsr::clampf(ny * 0.5f + 0.5f, 0.0f, 1.0f);
  const float up_r = lsr::clampf(rvy * 0.5f + 0.5f, 0.0f, 1.0f);
  const float zh_r = (float)(0.32 - 0.62), zh_g = (float)(0.46 - 0.66),
              zh_b = (float)(0.72 - 0.72);
  const float env_n[3] = {env(up_n, 0.16f, 0.62f, zh_r),
                          env(up_n, 0.15f, 0.66f, zh_g),
                          env(up_n, 0.14f, 0.72f, zh_b)};
  const float env_r[3] = {env(up_r, 0.16f, 0.62f, zh_r),
                          env(up_r, 0.15f, 0.66f, zh_g),
                          env(up_r, 0.14f, 0.72f, zh_b)};
  const float rgh = lsr::clampf(rough, 0.0f, 1.0f);
  const float fres_a = powf(1.0f - fmaxf(ndv_c, 0.0f), 5.0f);
  const float spec_str = 0.02f + (1.0f - rgh) * 0.18f;
  const float alb[3] = {ar, ag, ab};
  const float sun[3] = {dr, dg, db};

  if (inb) {
    const float covf = covered ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float f0 = 0.04f + (fmaxf(alb[c], 0.0f) - 0.04f) * metal;
      const float fa = f0 + (1.0f - f0) * fres_a;
      const float amb = ((1.0f - fa) * (1.0f - metal) * alb[c] * env_n[c]
                         * 0.12f + env_r[c] * fa * spec_str) * ao;
      out[o * 3 + c] = (sun[c] + alb[c] * acc[c] + acc[3 + c]
                        + (amb + r[46 + c])) * covf
                       + uni[9 + c] * (1.0f - covf);
    }
  }
}

}  // namespace

extern "C" int lsr_resolve_fused(const void* table, const void* tid,
                                 const void* sun_vis, const void* tex,
                                 const void* tile_rec, const void* counts,
                                 const void* uni, void* out, int width,
                                 int height, int tile_h, int tile_w,
                                 int tiles_x, int tiles_y, int cap, int chunk,
                                 int sun_model, void* stream) {
  if (tile_h % kBlockY || tile_w % kBlockX || (chunk != 8 && chunk != 16))
    return (int)cudaErrorInvalidValue;
  dim3 block(kBlockX, kBlockY);
  dim3 grid(tiles_x * tile_w / kBlockX, tiles_y * tile_h / kBlockY);
  auto kern = chunk == 16 ? resolve_fused_kernel<16> : resolve_fused_kernel<8>;
  kern<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)tid, (const float*)sun_vis,
      (const float*)tex, (const float*)tile_rec, (const int*)counts,
      (const float*)uni, (float*)out, width, height, tile_h, tile_w, tiles_x,
      cap, sun_model);
  return (int)cudaGetLastError();
}
