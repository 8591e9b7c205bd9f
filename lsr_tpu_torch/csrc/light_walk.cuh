// The light walk shared by kernels B2 (shade_fused.cu), B5
// (resolve_fused.cu) and B6 (fplus_accumulate.cu): how a 32x8 block of
// pixels, one thread a pixel and a warp on an 8x4 rectangle, goes through
// the light list of its tile without evaluating lights that cannot reach
// its pixels.
//
// The block takes the list 32 lights at a time (a group):
//  1. each warp boxes the world positions of its covered pixels once
//     (warp_box) and lane k tests light k of the group against the box
//     (light_near_box, conservative in f32); the warp's ballot is its mask
//     of the group's lights;
//  2. a group that no warp of the block wants is neither staged nor
//     prepared (__syncthreads_or);
//  3. otherwise one thread a light runs light_prepare into shared memory
//     and every pixel reads the derived fields as broadcasts;
//  4. for each light of its mask a warp runs light_reach and votes
//     (warp_shades): it pays for light_shade only where a lane can be lit.
// A warp without a covered pixel tests no box and walks nothing, unless a
// light has an infinite color channel: there the skipped term would be
// color * 0 = NaN, not +0, so such a light is walked by every warp, covered
// or not, as the plain versions evaluate it (an uncovered warp reads the
// three color fields of each listed record to find out).
//
// A skipped light is a term the plain version computes as +0; each kernel
// keeps its own summation and lets a skipped light enter it as the +0 it
// would have added, at its own place (B5: lsr_tpu's pairwise chunk tree;
// B2 and B6: chunk sums in light order, add_chunk_in_order below).
//
// The list is a base pointer and a count, so a walk over several lists (a
// slice's own list and trip count, as lsr_tpu's clustered B2 has) can call
// the same steps once per list.
//
// Sliced walks (B2b, SLICED = true): a list belongs to one log-Z slice and
// a pixel takes its lights only when the pixel lies in that slice; the
// gain of every other pixel is multiplied by 0, as lsr_tpu does.  The box,
// the uncovered-warp rule and the vote then count only the lanes of the
// slice, with one more exception besides an infinite color: a light whose
// gain may be infinite or NaN (|intensity| above 1e38 or NaN: the gain is
// at most 1.21 * |intensity|) gives NaN at a reached pixel of another
// slice, so it is walked by every warp and voted on by every reached lane.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "light_loop.cuh"

namespace lsr {

constexpr int kGroup = 32;  // lights tested and prepared per barrier pair
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWalkW = 32, kWalkH = 8;  // a block's pixels, inside one tile
constexpr int kWalkThreads = kWalkW * kWalkH;
constexpr int kWarpW = 8, kWarpH = 4;   // a warp's pixels

// This thread's pixel in a 1-D block of kWalkThreads: warp w owns the 8x4
// pixels at (8 * (w % 4), 4 * (w / 4)) of the block's 32x8.
__device__ __forceinline__ void walk_pixel(int& x, int& y) {
  const int w = threadIdx.x >> 5, wl = threadIdx.x & 31;
  x = blockIdx.x * kWalkW + (w & 3) * kWarpW + (wl & (kWarpW - 1));
  y = blockIdx.y * kWalkH + (w >> 2) * kWarpH + wl / kWarpW;
}

// The box of the world positions of a warp's covered pixels (empty: lo =
// +inf, hi = -inf; fminf / fmaxf drop a NaN position, whose pixel no light
// reaches anyway).
struct Box {
  float x0, x1, y0, y1, z0, z1;
};

__device__ __forceinline__ Box warp_box(bool covered, float px, float py,
                                        float pz) {
  Box b = {covered ? px : CUDART_INF_F, covered ? px : -CUDART_INF_F,
           covered ? py : CUDART_INF_F, covered ? py : -CUDART_INF_F,
           covered ? pz : CUDART_INF_F, covered ? pz : -CUDART_INF_F};
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    b.x0 = fminf(b.x0, __shfl_xor_sync(kFullMask, b.x0, d));
    b.x1 = fmaxf(b.x1, __shfl_xor_sync(kFullMask, b.x1, d));
    b.y0 = fminf(b.y0, __shfl_xor_sync(kFullMask, b.y0, d));
    b.y1 = fmaxf(b.y1, __shfl_xor_sync(kFullMask, b.y1, d));
    b.z0 = fminf(b.z0, __shfl_xor_sync(kFullMask, b.z0, d));
    b.z1 = fmaxf(b.z1, __shfl_xor_sync(kFullMask, b.z1, d));
  }
  return b;
}

// The offset from the nearest point of [lo, hi] to e along one axis, as the
// per-pixel code subtracts (emitter - pixel).
__device__ __forceinline__ float axis_gap(float e, float lo, float hi) {
  return e < lo ? e - lo : (e > hi ? e - hi : 0.0f);
}

// The eight fields of a packed light record that the box test reads.
struct BoxRec {
  float ltype, x, y, z, colr, colg, colb, rng;
};

__device__ __forceinline__ BoxRec load_box_rec(const float* f) {
  return {f[0], f[1], f[2], f[3], f[13], f[14], f[15], f[17]};
}

// Whether every clamped color channel is finite (light_prepare's zero_ok).
__device__ __forceinline__ bool finite_color(float r, float g, float b) {
  return fmaxf(r, 0.0f) < CUDART_INF_F && fmaxf(g, 0.0f) < CUDART_INF_F
         && fmaxf(b, 0.0f) < CUDART_INF_F;
}

// Whether gain * 0 is a zero for this light's intensity: the gain is
// intensity * atten * vis with atten <= 1.21 and vis in [0, 1], so it is
// finite when |intensity| <= 1e38 (false for NaN).
__device__ __forceinline__ bool finite_gain(float intensity) {
  return fabsf(intensity) <= 1e38f;
}

// False only when the light cannot be in range of any pixel of the box.
// For a point or a spot the emitter is the light's position, and
// light_reach computes dist = sqrt(max(tx*tx + ty*ty + tz*tz, 1e-16)) with
// t = emitter - pixel and asks dist < rng.  Every step rounds to nearest,
// and rounding is monotone: along each axis |emitter - pixel| is at least
// |axis_gap| for every pixel of the box, so each square, each sum, the
// square root and therefore dist are at least the values computed here in
// the same order, and dist < rng fails at every pixel when it fails here.
// Rect and tube emitters move with the pixel and a light with an infinite
// color channel must reach the sum as 0 * inf: both are always kept.
__device__ __forceinline__ bool light_near_box(const BoxRec& f,
                                               const Box& b) {
  if (f.ltype == 3.0f || f.ltype == 4.0f) return true;
  if (!finite_color(f.colr, f.colg, f.colb)) return true;
  const float tx = axis_gap(f.x, b.x0, b.x1);
  const float ty = axis_gap(f.y, b.y0, b.y1);
  const float tz = axis_gap(f.z, b.z0, b.z1);
  const float dist = sqrtf(fmaxf(tx * tx + ty * ty + tz * tz, 1e-16f));
  return dist < fmaxf(f.rng, 0.001f);
}

// Steps 1-3 for the group of lights [g0, g0 + 32) of a list of n_listed
// records.  Every thread of the (1-D) block calls it with the same list,
// g0 and n_listed.  Returns false when no warp of the block wants a light
// of the group (nothing is staged); else lights[0:32] holds the group's
// prepared lights and wm this warp's mask of them.  The first barrier also
// keeps the previous group's lights until every warp is done with them.
// SLICED: warp_covered and box are those of the warp's covered pixels in
// the list's slice, and a light of non-finite gain is kept by every warp.
template <bool SLICED = false>
__device__ __forceinline__ bool stage_group(const float* list, int n_listed,
                                            int g0, bool warp_covered,
                                            const Box& box, Light* lights,
                                            unsigned& wm) {
  const int thread = threadIdx.x, lane = thread & 31;
  bool near = false;
  if (g0 + lane < n_listed) {
    const float* f = list + (size_t)(g0 + lane) * kRec;
    if (SLICED && !finite_gain(f[16]))
      near = true;
    else if (warp_covered)
      near = light_near_box(load_box_rec(f), box);
    else
      near = !finite_color(f[13], f[14], f[15]);
  }
  wm = __ballot_sync(kFullMask, near);
  if (!__syncthreads_or(wm != 0u)) return false;
  if (thread < kGroup && g0 + thread < n_listed)
    lights[thread] = light_prepare(list + (size_t)(g0 + thread) * kRec);
  __syncthreads();
  return true;
}

// Step 4, uniform in the warp: whether the warp must run light_shade for L,
// given each lane's light_reach verdict `may`.  Where no lane may be lit
// every gain is 0 and the six terms are color * (0 * finite) = +0, unless
// a color channel is infinite.
__device__ __forceinline__ bool warp_shades(const Light& L, bool may) {
  return __any_sync(kFullMask, may) || L.zero_ok == 0.0f;
}

// What the light terms read of a pixel: world position, unit normal, unit
// view vector and coverage.
struct Pixel {
  float px, py, pz, nx, ny, nz, vx, vy, vz;
  bool covered;
};

// The pixel's local-shadow texels: plane k's at vis[k * width * height +
// at], for the planes k < n_shadowed (a pixel outside the image passes 0).
// The image's width and height, not their product, so that a kernel's own
// arguments fill the struct and cost no register of their own.
struct Planes {
  const float* vis;
  int n_shadowed;
  size_t at;
  int width, height;
};

// Step 4 for light L of a warp's mask at this thread's pixel: light_reach,
// the vote, then light_shade.  Fills v with color * wd (0:3) and color * ws
// (3:6) and returns true, or returns false when the warp skips the light.
// PLANES: a light with a local-shadow plane (L.sidx < pl.n_shadowed) reads
// its texel there (B2a, B5a).  A plane multiplies the gain of a live light
// and never makes a dead light live, so the box test and the vote stay
// exact.  SLICED: in_slice says whether the pixel lies in the list's slice;
// a pixel of another slice votes only for a light of non-finite gain, and
// its gain is multiplied by 0 through the visibility factor: lsr_tpu's
// (gain * plane) * 0 and gain * (plane * 0) are both a zero for a finite
// gain (a plane is in [0, 1]) and both NaN for an infinite one.  apow1 as
// in light_shade; KIND as in light_prepare.
template <bool PLANES, int KIND = 0, bool SLICED = false>
__device__ __forceinline__ bool light_terms(const Light& L, const Pixel& p,
                                            int apow1, const Planes& pl,
                                            float v[6], bool in_slice = true) {
  Reach r;
  bool may = light_reach<KIND>(L, p.px, p.py, p.pz, p.nx, p.ny, p.nz,
                               p.covered, r);
  if (SLICED && !in_slice) may = may && !finite_gain(L.intensity);
  if (!warp_shades(L, may)) return false;
  float lvis = PLANES && L.sidx < (float)pl.n_shadowed
                   ? pl.vis[(size_t)L.sidx * pl.width * pl.height + pl.at]
                   : 1.0f;
  if (SLICED) lvis = lvis * (in_slice ? 1.0f : 0.0f);
  float wd, ws;
  light_shade<KIND>(L, r, p.nx, p.ny, p.nz, p.vx, p.vy, p.vz, p.covered,
                    apow1, wd, ws, lvis);
  v[0] = L.colr * wd;
  v[1] = L.colg * wd;
  v[2] = L.colb * wd;
  v[3] = L.colr * ws;
  v[4] = L.colg * ws;
  v[5] = L.colb * ws;
  return true;
}

// light_terms in the copy of L's kind (2 spot, 3 rect, 4 tube, else a
// point light): a branch uniform in the warp, after which no copy carries
// another kind's fields or branches.
template <bool PLANES, bool SLICED = false>
__device__ __forceinline__ bool light_terms_of_kind(const Light& L,
                                                    const Pixel& p,
                                                    int apow1,
                                                    const Planes& pl,
                                                    float v[6],
                                                    bool in_slice = true) {
  if (L.ltype == 2.0f)
    return light_terms<PLANES, 2, SLICED>(L, p, apow1, pl, v, in_slice);
  if (L.ltype == 3.0f)
    return light_terms<PLANES, 3, SLICED>(L, p, apow1, pl, v, in_slice);
  if (L.ltype == 4.0f)
    return light_terms<PLANES, 4, SLICED>(L, p, apow1, pl, v, in_slice);
  return light_terms<PLANES, 1, SLICED>(L, p, apow1, pl, v, in_slice);
}

// One chunk of a group summed in light order, as B2 and B6 (and lsr_tpu's
// fori_loop bodies, shade_kernel.py:339-346, fplus_kernel.py:218-221) sum
// it: part starts at +0, each light adds its six terms, and the part is
// added to acc.  cm is the warp's mask of the chunk's lights; term(L, v)
// fills v with a light's terms and returns false when the warp skips it.
// A skipped light adds nothing where the plain version adds +0, which
// leaves part as it is: x + (+0) is x for every x but -0, and part is never
// -0 (it starts at +0, and a rounded sum is -0 only when both addends are).
// A chunk with every light skipped adds nothing to acc for the same reason.
template <int CHUNK, class Term>
__device__ __forceinline__ void add_chunk_in_order(unsigned cm,
                                                   const Light* chunk,
                                                   float acc[6], Term term) {
  if (cm == 0u) return;
  float part[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int li = 0; li < CHUNK; ++li) {
    if (!((cm >> li) & 1u)) continue;
    float v[6];
    if (!term(chunk[li], v)) continue;
#pragma unroll
    for (int c = 0; c < 6; ++c) part[c] = part[c] + v[c];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = acc[c] + part[c];
}

}  // namespace lsr
