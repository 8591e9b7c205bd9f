// Kernel B5: the fused resolve, visibility buffer -> lit HDR in one pass:
// barycentrics, world position and normal, material, sun BRDF x sun
// visibility, the binned local-light loop, fake-IBL ambient, emissive and
// the background.
//
// Replaces lsr_tpu/lighting/resolve_kernel.py:_resolve_kernel (wrapper
// resolve_fused_pallas, pallas_call at resolve_kernel.py:537).
//
// What bounds it on this card: operations executed for (pixel, light) pairs
// that add nothing, not memory (~40 bytes read and 12 written per pixel).
// A tile's list is binned for 64x128 pixels.  On the 1080p flagship frame
// (256 spot and point lights, up to 127 a tile) the walk meets 82.1 M
// (pixel, listed light) pairs, 56.3 M of them on covered pixels, and only
// 6.0 M are live: in range, inside the cone, facing the light.  An 8x4
// pixel rectangle has a live pixel for 3.2 of the 39.3 lights its tile
// lists on average (at most 34), a 32x1 row for 3.7, a 32x8 block for 4.1.
// A pair cost about 400 machine operations whether live or not (a square
// root and a division for the light's axis, two cosf for a spot, two powf,
// IEEE divisions: no fast math, no FMA contraction, to round like the plain
// version).
//
// What the design does about it: one thread per pixel, 32x8 blocks inside
// one light tile, a warp on an 8x4 rectangle, and the light walk it shares
// with B2 and B6 (light_walk.cuh).
//  - A light's own work once per light: the block takes the list 32 lights
//    at a time; one thread per light runs lsr::light_prepare (unit axis,
//    cone cosines, rect frame, tube segment) into shared memory, and every
//    pixel reads the derived fields as broadcasts.
//  - Lights that cannot reach a warp are never evaluated.  First each warp
//    boxes the world positions of its covered pixels and lane k tests
//    light k of the group against the box (light_near_box, provably
//    conservative in f32, see there); a group no warp wants is not even
//    prepared.  Then, for a light that passed, the warp votes after the
//    distance, cone and N.L tests (lsr::light_reach) and skips the
//    attenuation, half vector and both powf when no lane can be lit.  A
//    warp without a covered pixel walks only lights of infinite color.
//  - Sums unchanged: a skipped light enters lsr_tpu's pairwise chunk tree
//    (_sum0, resolve_kernel.py:50-62) as the +0 it would have added, at
//    its own position, so grouping and result are those of the plain
//    version.  The tree is a binary counter over named registers, and the
//    loop over a chunk is not unrolled.
//  - Records through tid: lsr_tpu gathers a (H, W, 56) record per pixel in
//    XLA first (465 MB at 1080p) because a TPU kernel cannot gather; here
//    each thread reads the 31 lanes it needs of its triangle's row of
//    pack_interp_records' (rows, 56) table with eleven 16-byte loads, and
//    neighbouring pixels share rows in cache.  An uncovered pixel reads row
//    0, as lsr_tpu's gather of a clamped tid does, runs the per-pixel part
//    like any other and gets the background.
//
// The choices, measured on an NVIDIA H100 80GB HBM3 at 700 W on that frame
// (kernel ms by CUDA events, chunk 8 / chunk 16, every variant within
// 1.9e-6 of the plain version, one run; the kernel before this design took
// 1.444 / -).  Only the first row is kept in the source:
//   as built (80 registers by __launch_bounds__(256, 3),
//   376 / 496 bytes spilled)                               0.378 / 0.432
//   no register bound (107 / 118 registers, no spill)      0.407 / 0.464
//   64 registers (__launch_bounds__(256, 4))               0.370 / 0.471
//   chunk loop fully unrolled                              0.419 / 0.620
//   a warp on a 32x1 row instead of 8x4                    0.450 / 0.475
//   no box test (votes only)                               0.645 / 0.711
//   no vote (box test only)                                0.435 / 0.494
//   neither, uncovered warps still skipped                 1.130 / 1.235
//   neither, and every warp walks the list                 1.423 / 1.572
//   the same with light_prepare per pixel (the old work
//   in the new layout)                                     1.590 / 1.757
//   light_prepare per pixel, all skips kept                0.447 / 0.500
//   31 scalar record loads instead of 11 float4            0.411 / 0.468
//   per-warp prepare of the wanted lights, no block
//   barrier (32 KB of shared memory)                       0.412 / 0.466
//   the sun term after the light loop / no `top` copy      0.408, 0.434
//   one copy of light_reach and light_shade per light
//   kind, as B2 and B6 had then (light_loop.cuh)           0.370 / -
// With every light rejected the kernel takes 0.170 ms and with an empty
// list 0.064 ms: the box tests (dependent loads of eight record fields a
// lane per group) are about 0.1 ms and the evaluation of the 4.6 lights a
// warp keeps on average about 0.2 ms, at three blocks an SM.
//
// Local-shadow planes (variant B5a; lsr_tpu resolve_kernel.py:339-345):
// record lane 28 is the light's plane, plane K the constant 1.0.  A plane
// multiplies the gain of a light that is live and never makes a dead light
// live, so the box test and the vote stay exact; a shadowed light (plane <
// K) that passes both reads one texel of its plane, every other light's
// gain is multiplied by 1.0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "light_walk.cuh"

namespace {

constexpr int kRecLanes = 56;
using lsr::kFullMask;
using lsr::kGroup;
using lsr::kRec;
using lsr::kWalkH;
using lsr::kWalkThreads;
using lsr::kWalkW;

// Fake-IBL environment: ground + ((horizon + (zenith - horizon) * up) -
// ground) * up, with lsr_tpu's constants (zenith - horizon is folded in
// double, as Python folds it, then rounded to f32).
__device__ __forceinline__ float env(float up, float g, float h, float zh) {
  return g + ((h + zh * up) - g) * up;
}

template <int CHUNK>
__global__ void __launch_bounds__(kWalkThreads, 3)
resolve_fused_kernel(const float* __restrict__ table,     // (rows, 56)
                     const int* __restrict__ tid,         // (H, W)
                     const float* __restrict__ sun_vis,   // (H, W)
                     const float* __restrict__ tex,       // (H, W, 3)
                     const float* __restrict__ tile_rec,  // (tiles, cap, 32)
                     const int* __restrict__ counts,      // (tiles,)
                     const float* __restrict__ uni,       // (12,)
                     const float* __restrict__ vis,       // (K + 1, H, W)
                     int n_shadowed,                      // K
                     float* __restrict__ out,             // (H, W, 3)
                     int width, int height, int tile_h, int tile_w,
                     int tiles_x, int cap, int sun_model) {
  constexpr int kLevels = CHUNK == 16 ? 4 : 3;  // log2(CHUNK)
  __shared__ lsr::Light lights[kGroup];
  int x, y;
  lsr::walk_pixel(x, y);
  const bool inb = x < width && y < height;
  const size_t o = (size_t)y * width + x;

  const int t = inb ? tid[o] : -1;
  const bool covered = t >= 0;
  // The 31 lanes the pixel needs of its triangle's row, as 16-byte loads
  // (a row is 224 bytes): lanes 0:32 and 40:52.
  const float4* r4 = reinterpret_cast<const float4*>(
      table + (size_t)(covered ? t : 0) * kRecLanes);
  const float4 q0 = __ldg(r4), q1 = __ldg(r4 + 1), q2 = __ldg(r4 + 2),
               q3 = __ldg(r4 + 3), q4 = __ldg(r4 + 4), q5 = __ldg(r4 + 5),
               q6 = __ldg(r4 + 6), q7 = __ldg(r4 + 7), q10 = __ldg(r4 + 10),
               q11 = __ldg(r4 + 11), q12 = __ldg(r4 + 12);

  // --- interp: weights from the coef lanes at this pixel's centre ----------
  const float sx = (float)x + 0.5f, sy = (float)y + 0.5f;
  float w0 = (q0.x * sx + q0.y * sy + q0.z) * q2.y;
  float w1 = (q0.w * sx + q1.x * sy + q1.y) * q2.z;
  float w2 = (q1.z * sx + q1.w * sy + q2.x) * q2.w;
  const float inv_den = 1.0f / fmaxf(w0 + w1 + w2, 1e-12f);
  w0 = w0 * inv_den;
  w1 = w1 * inv_den;
  w2 = w2 * inv_den;
  const float px = w0 * q3.x + w1 * q3.w + w2 * q4.z;
  const float py = w0 * q3.y + w1 * q4.x + w2 * q4.w;
  const float pz = w0 * q3.z + w1 * q4.y + w2 * q5.x;
  float nx = w0 * q5.y + w1 * q6.x + w2 * q6.w;
  float ny = w0 * q5.z + w1 * q6.y + w2 * q7.x;
  float nz = w0 * q5.w + w1 * q6.z + w2 * q7.y;
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
  const float ar = fmaxf(q10.x, 0.0f) * tr;
  const float ag = fmaxf(q10.y, 0.0f) * tg;
  const float ab = fmaxf(q10.z, 0.0f) * tb;
  const float metal = lsr::clampf(q10.w, 0.0f, 1.0f);
  const float rough = q11.x;
  const float ao = lsr::clampf(q11.y, 0.0f, 1.0f);
  const float emis[3] = {q11.z, q11.w, q12.x};
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
  const int n_listed =
      min((counts[tile] + CHUNK - 1) / CHUNK, cap / CHUNK) * CHUNK;
  const float* trec = tile_rec + (size_t)tile * cap * kRec;
  const bool warp_covered = __any_sync(kFullMask, covered);
  const lsr::Box box = lsr::warp_box(covered, px, py, pz);
  const lsr::Pixel pix = {px, py, pz, nx, ny, nz, vx, vy, vz, covered};
  const lsr::Planes pl = {vis, inb ? n_shadowed : 0, o, width, height};
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int g0 = 0; g0 < n_listed; g0 += kGroup) {
    unsigned wm;
    if (!lsr::stage_group(trec, n_listed, g0, warp_covered, box, lights, wm))
      continue;
#pragma unroll 1
    for (int c0 = 0; c0 < kGroup; c0 += CHUNK) {
      const unsigned cm = (wm >> c0) & ((1u << CHUNK) - 1u);
      // A chunk of skipped lights sums to +0, and acc + 0 is acc.
      if (cm == 0u) continue;
      // Pairwise tree over the chunk as a binary counter: st[b] holds the
      // sum of the last complete block of 2^b lights; a skipped light
      // enters as the +0 it would have added.
      float st[kLevels][6];
      float top[6];
#pragma unroll 1
      for (int li = 0; li < CHUNK; ++li) {
        float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if ((cm >> li) & 1u)
          lsr::light_terms<true>(lights[c0 + li], pix, 0, pl, v);
        bool placed = false;
#pragma unroll
        for (int b = 0; b < kLevels; ++b) {
          if (placed) continue;
          if ((li >> b) & 1) {
#pragma unroll
            for (int c = 0; c < 6; ++c) v[c] = st[b][c] + v[c];
          } else {
#pragma unroll
            for (int c = 0; c < 6; ++c) st[b][c] = v[c];
            placed = true;
          }
        }
        if (!placed) {
#pragma unroll
          for (int c = 0; c < 6; ++c) top[c] = v[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[c] = acc[c] + top[c];
    }
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
                        + (amb + emis[c])) * covf
                       + uni[9 + c] * (1.0f - covf);
    }
  }
}

}  // namespace

// vis may be null (n_shadowed 0): no local-shadow planes.
extern "C" int lsr_resolve_fused(const void* table, const void* tid,
                                 const void* sun_vis, const void* tex,
                                 const void* tile_rec, const void* counts,
                                 const void* uni, const void* vis,
                                 int n_shadowed, void* out, int width,
                                 int height, int tile_h, int tile_w,
                                 int tiles_x, int tiles_y, int cap, int chunk,
                                 int sun_model, void* stream) {
  if (tile_h % kWalkH || tile_w % kWalkW || (chunk != 8 && chunk != 16)
      || (n_shadowed && !vis))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16)
    return (int)cudaErrorInvalidValue;  // rows are read with 16-byte loads
  dim3 grid(tiles_x * tile_w / kWalkW, tiles_y * tile_h / kWalkH);
  auto kern = chunk == 16 ? resolve_fused_kernel<16> : resolve_fused_kernel<8>;
  kern<<<grid, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)tid, (const float*)sun_vis,
      (const float*)tex, (const float*)tile_rec, (const int*)counts,
      (const float*)uni, (const float*)vis, n_shadowed, (float*)out, width,
      height, tile_h, tile_w, tiles_x, cap, sun_model);
  return (int)cudaGetLastError();
}
