// Kernel B2: fused sun BRDF + binned local lights.
//
// Replaces lsr_tpu/lighting/shade_kernel.py:_shade_kernel (wrapper
// shade_fused_pallas, pallas_call at shade_kernel.py:510).
//
// What bounds it on this card: operations executed for (pixel, light) pairs
// that add nothing, not memory (13 G-buffer planes read, 12 bytes written a
// pixel).  A tile's list is binned for 64x128 pixels, and on the 1080p
// flagship frame only 6.0 M of its 56.3 M (covered pixel, binned light)
// pairs are live; an 8x4 pixel rectangle has a live pixel for 3.2 of the
// 39.3 lights its tile lists (resolve_fused.cu's header has the counts).  A
// pair costs some 60 f32 operations with two square roots, a division, one
// or two powf and, for a spot, two cosf, without fast math or FMA
// contraction, so that it rounds like the plain version.
//
// What the design does about it: B5's light walk (light_walk.cuh).  One
// thread per pixel, 32x8 blocks inside one 64x128 tile, a warp on an 8x4
// rectangle; the block takes its tile's list 32 lights at a time.  Each
// warp boxes the world positions of its covered pixels (G-buffer planes
// 0-2) and lane k tests light k of the group against the box; a group no
// warp wants is neither staged nor prepared; otherwise one thread a light
// runs light_prepare into shared memory once.  For each light of its mask
// a warp runs light_reach and skips light_shade where no lane can be lit.
// A warp without a covered pixel walks only lights of infinite color.  The
// walk is min(ceil(count/8), cap/8) chunks of 8, as in lsr_tpu
// (shade_kernel.py:342-346); each chunk is summed in light order, then
// added to the running sums, and a skipped light enters its chunk's sum as
// the +0 it would have added.  The sun term, coverage and the output write
// are per pixel, as before; an uncovered pixel writes (...) * 0.
//
// Local-shadow planes (variant B2a; lsr_tpu shade_kernel.py:270-294): record
// lane 28 holds the light's plane, plane K the constant 1.0 of unshadowed
// lights.  lsr_tpu sums a one-hot select over all K + 1 planes for every
// light of a chunk that holds a shadowed one; here a shadowed light (plane
// < K) that a warp shades reads its own plane's texel, and the gain of
// every other light is multiplied by 1.0, which leaves it as it is.
//
// The choices, each timed as a patched copy of this source (kernel ms on
// an NVIDIA H100 80GB HBM3 at 700 W, one call, 1920x1080, medians of 4,
// every variant's output equal to the shipped kernel's and to the kernel's
// before this design bit for bit; registers / spilled bytes planeless and
// with planes from -Xptxas -v):
//   variant                          ESM, planes  ESM, none  cut   high-poly
//   as built: box test, vote, a copy
//   per light kind, a planeless copy,
//   (256, 4): 64 / 84 B, 64 / 116 B      0.198       0.190   0.190   0.105
//   no box test (votes only)             0.256       0.249   0.248   0.141
//   no vote (box test only)              0.216       0.208   0.207   0.113
//   neither                              0.488       0.455   0.455   0.243
//   one kernel for both launches         0.198       0.197   0.197   0.108
//   one generic copy of the light math   0.201       0.195   0.195   0.107
//   (256, 3): 76 / 0 B, 75 / 0 B         0.214       0.206   0.206   0.105
//   no register bound: 64 / 96, 64 / 108 0.197       0.190   0.189   0.104
//   before this design (every pixel
//   prepares and shades every light):
//   64 / 100 B, 64 / 196 B               0.506       0.477   0.475   0.241
// The bound is explicit, as the compiler picks 64 registers itself.  With
// the box test and the vote off the walk still skips uncovered warps and
// prepares each light once.
//
// Clustered slices (variant B2b; lsr_tpu shade_kernel.py:295-300, :325-341,
// :420-447, :477-478): the lights are binned per (tile, log-Z slice), the
// records are (tiles, slices * cap, 32) and the counts (tiles * slices,),
// and G-buffer plane 13 holds each pixel's slice.  The block walks slice
// sl's list (base tile * slices * cap + sl * cap, count counts[tile *
// slices + sl]) for sl = 0 .. slices - 1, each as the tiled walk above,
// with min(ceil(count/8), cap/8) chunks, the sums carried from slice to
// slice.  A pixel keeps a light's term only in its own slice; lsr_tpu
// multiplies the other pixels' gain by 0.  So a lane is live for slice sl
// when it is covered and its plane equals sl, and the warp's box, its
// uncovered-warp rule and its vote take only the live lanes
// (light_walk.cuh's SLICED walk): a warp stages and shades a slice's light
// only where a pixel of that slice can take it.  A lane of another slice
// that runs the light anyway multiplies its gain by 0 as lsr_tpu does.
// slices is a run-time argument; kSliced picks the walk.

#include <cuda_runtime.h>

#include "light_walk.cuh"

namespace {

constexpr int kTileH = 64;
constexpr int kTileW = 128;
constexpr int kChunk = 8;
using lsr::kFullMask;
using lsr::kGroup;
using lsr::kRec;
using lsr::kWalkH;
using lsr::kWalkThreads;
using lsr::kWalkW;

// kPlanes: the launch has local-shadow planes (a planeless launch runs a
// copy without the plane code).  kSliced: clustered records and slices > 0
// slices per tile (a tiled launch runs a copy without the slice walk).
template <bool kPlanes, bool kSliced>
__global__ void __launch_bounds__(kWalkThreads, 4)
shade_fused_kernel(const float* __restrict__ gbuf,      // (16, ph, pw)
                   const float* __restrict__ tile_rec,  // (tiles, [slices *]
                                                        //  cap, 32)
                   const int* __restrict__ counts,      // (tiles [* slices],)
                   const float* __restrict__ uni,       // (9,)
                   const float* __restrict__ vis,       // (K + 1, H, W)
                   int n_shadowed,                      // K
                   float* __restrict__ out,             // (H, W, 3)
                   int width, int height, int ph, int pw, int tiles_x,
                   int cap, int slices, int sun_model, int apow1) {
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
  const float ar = gbuf[7 * plane + o], ag = gbuf[8 * plane + o],
              ab = gbuf[9 * plane + o];
  const float metal = lsr::clampf(gbuf[10 * plane + o], 0.0f, 1.0f);
  const float rough = gbuf[11 * plane + o];
  const float sun_vis = gbuf[12 * plane + o];
  const bool inb = x < width && y < height;

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
  const lsr::Pixel pix = {px, py, pz, nx, ny, nz, vx, vy, vz, covered};
  const lsr::Planes pl = {vis, inb ? n_shadowed : 0, (size_t)y * width + x,
                          width, height};
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (!kSliced) {
    const int n_listed =
        min((counts[tile] + kChunk - 1) / kChunk, cap / kChunk) * kChunk;
    const float* trec = tile_rec + (size_t)tile * cap * kRec;
    const bool warp_covered = __any_sync(kFullMask, covered);
    const lsr::Box box = lsr::warp_box(covered, px, py, pz);
    auto term = [&](const lsr::Light& L, float v[6]) {
      return lsr::light_terms_of_kind<kPlanes>(L, pix, apow1, pl, v);
    };
    for (int g0 = 0; g0 < n_listed; g0 += kGroup) {
      unsigned wm;
      if (!lsr::stage_group(trec, n_listed, g0, warp_covered, box, lights,
                            wm))
        continue;
#pragma unroll 1
      for (int c0 = 0; c0 < kGroup; c0 += kChunk)
        lsr::add_chunk_in_order<kChunk>((wm >> c0) & 0xffu, lights + c0, acc,
                                        term);
    }
  } else {
    const float my_slice = gbuf[13 * plane + o];
#pragma unroll 1
    for (int sl = 0; sl < slices; ++sl) {
      const int cl = tile * slices + sl;  // uniform per block
      const int n_listed =
          min((counts[cl] + kChunk - 1) / kChunk, cap / kChunk) * kChunk;
      if (n_listed == 0) continue;
      const float* srec = tile_rec + (size_t)cl * cap * kRec;
      const bool in_slice = my_slice == (float)sl;
      const bool live = covered && in_slice;
      const bool warp_live = __any_sync(kFullMask, live);
      const lsr::Box box = lsr::warp_box(live, px, py, pz);
      auto term = [&](const lsr::Light& L, float v[6]) {
        return lsr::light_terms_of_kind<kPlanes, true>(L, pix, apow1, pl, v,
                                                       in_slice);
      };
      for (int g0 = 0; g0 < n_listed; g0 += kGroup) {
        unsigned wm;
        if (!lsr::stage_group<true>(srec, n_listed, g0, warp_live, box,
                                    lights, wm))
          continue;
#pragma unroll 1
        for (int c0 = 0; c0 < kGroup; c0 += kChunk)
          lsr::add_chunk_in_order<kChunk>((wm >> c0) & 0xffu, lights + c0,
                                          acc, term);
      }
    }
  }

  if (inb) {
    const float covf = covered ? 1.0f : 0.0f;
    float* po = out + pl.at * 3;
    po[0] = (dr + ar * acc[0] + acc[3]) * covf;
    po[1] = (dg + ag * acc[1] + acc[4]) * covf;
    po[2] = (db + ab * acc[2] + acc[5]) * covf;
  }
}

}  // namespace

namespace {

int launch(const void* gbuf, const void* tile_rec, const void* counts,
           const void* uni, const void* vis, int n_shadowed, void* out,
           int width, int height, int ph, int pw, int tiles_x, int cap,
           int slices, int sun_model, int apow1, void* stream) {
  if ((n_shadowed && !vis) || ph % kTileH || pw % kTileW || cap % kChunk
      || slices < 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(pw / kWalkW, ph / kWalkH);
  auto kern = slices ? (n_shadowed ? shade_fused_kernel<true, true>
                                   : shade_fused_kernel<false, true>)
                     : (n_shadowed ? shade_fused_kernel<true, false>
                                   : shade_fused_kernel<false, false>);
  kern<<<grid, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const float*)gbuf, (const float*)tile_rec, (const int*)counts,
      (const float*)uni, (const float*)vis, n_shadowed, (float*)out, width,
      height, ph, pw, tiles_x, cap, slices, sun_model, apow1);
  return (int)cudaGetLastError();
}

}  // namespace

// vis may be null (n_shadowed 0): no local-shadow planes.
extern "C" int lsr_shade_fused(const void* gbuf, const void* tile_rec,
                               const void* counts, const void* uni,
                               const void* vis, int n_shadowed, void* out,
                               int width, int height, int ph, int pw,
                               int tiles_x, int cap, int sun_model, int apow1,
                               void* stream) {
  return launch(gbuf, tile_rec, counts, uni, vis, n_shadowed, out, width,
                height, ph, pw, tiles_x, cap, 0, sun_model, apow1, stream);
}

// Clustered mode (B2b): slices > 0 lists per tile of cap records each, the
// pixels' slices in G-buffer plane 13.
extern "C" int lsr_shade_fused_clustered(
    const void* gbuf, const void* tile_rec, const void* counts,
    const void* uni, const void* vis, int n_shadowed, void* out, int width,
    int height, int ph, int pw, int tiles_x, int cap, int slices,
    int sun_model, int apow1, void* stream) {
  if (slices <= 0) return (int)cudaErrorInvalidValue;
  return launch(gbuf, tile_rec, counts, uni, vis, n_shadowed, out, width,
                height, ph, pw, tiles_x, cap, slices, sun_model, apow1,
                stream);
}
