// Kernel G1: the general lighting branch's binned local-light sum, per
// pixel the diffuse and specular sums of its screen tile's (or cluster's)
// -1-padded light list, with the local-shadow plane of each light.
//
// Replaces no pallas_call: lsr_tpu computes this sum in XLA
// (lsr_tpu/lighting/light_runtime.py: accumulate_local_lights, called by
// the general branch of its lighting passes and forward_plus, and by the
// sharded steps).  Plain version: accumulate_local_lights_plain in
// lighting/light_runtime.py (torch ops, 16 chunks of ~150 elementwise
// kernels over (tiles, 256, 8[, 3]) tensors at 1280x720 with 128-light
// lists), which this kernel equals bit for bit on the card:
//  - eval_local_lights' operations in its order, built with -fmad=false,
//    no fast math, IEEE sqrtf and divisions, powf and cosf as PyTorch's
//    CUDA kernels call them; clamp, maximum and minimum with torch's NaN
//    rules; only the light's own kind is evaluated (torch.where drops the
//    other kinds' values, whatever they are);
//  - PyTorch's CUDA `sum` (ATen's Reduce.cuh), as measured on the card
//    (tests/test_torch_local_lights.py::test_torch_orders_on_the_card):
//    over a contiguous last dimension of 3, two lanes split the input
//    (lane 0 takes x0 and x2, lane 1 x1, each starting from the identity
//    0) and a shuffle adds lane 1 to lane 0: ((x0 + x2) + 0) + x1 (sum3);
//    over the chunk dimension (stride 3, every output one thread) the
//    thread keeps four accumulators, slot j going to accumulator j % 4,
//    then ((a0 + a1) + a2) + a3; each chunk's sum is added to the running
//    sum, as `diff = diff + d.sum(-2)` does;
//  - torch.linalg.cross as PyTorch's CUDA kernel rounds it (its
//    a1 * b2 - a2 * b1 contracted into one fma: fmaf(a1, b2, -(a2 * b1)),
//    measured by the same test).
//
// What bounds it on this card: f32 operations on (pixel, light) pairs.  At
// 1280x720 with 16-px tiles of 128 lights a pixel meets 128 pairs (118M a
// frame); a live pair costs ~60 operations with two powf, three sqrtf and
// four IEEE divisions, a pair out of reach ~25.  The bytes are small: the
// G-buffer's world position and normal (24 bytes a pixel), the planes
// (4 (K + 1) bytes a pixel), the lists, 24 bytes written a pixel.
//
// What the design does about it: one block per screen tile, one thread
// per pixel (at most 256 threads; a larger tile loops over its pixels),
// reading the G-buffer and the planes in place from their (H, W, .) strides
// and writing (H, W, 3) diffuse and specular, so none of the plain
// version's tiled copies exist.  Everything of a light that does not
// depend on the pixel (unit forward, rect frame, tube segment, cone
// cosines, clamps, color times intensity, the plane index) is prepared
// once per list slot into shared memory, 64 slots per barrier pair, and
// read as broadcasts.  A pair is left out only where the plain version
// provably adds +0 (or -0, which leaves a sum that starts at +0 unchanged)
// to the slot's accumulator: the slot's radiance is 0 (a -1 slot, a zero
// intensity), the pixel is out of range or at the emitter, faces away,
// lies outside a spot's cone or behind a rect, or its plane reads 0.  That
// needs every term to be finite, so it is decided only for a "bounded"
// pair: the pixel's position and the camera within 1e6, its normal within
// 2, its planes finite, and every field of the light's record (the
// intensity as masked) within 1e6; any other pair is evaluated in full, as
// the plain version does.  The rule's plain model is local_light_skips in
// lighting/light_walk.py (the bounds: light_runtime.SKIP_BOUND and
// SKIP_NORMAL_BOUND).
// Clustered lists (slices > 1) pick the list row per pixel, so each thread
// prepares its own slot's light in registers.
//
// The choices (kernel ms of patched copies of this file, each built alone
// and timed against the others in alternating rounds on an NVIDIA H100
// 80GB HBM3 at 700 W, the forward_classic+ssao call at 1280x720 with 384
// lights, 128-slot lists and 11 planes, medians of 4 in one process, every
// copy bit for bit the shipped kernel; registers / spilled bytes of the
// tiled kernel from -Xptxas -v; chip_smoke.py times the shipped kernel on
// the same call):
//   as built: tiled lists at 4 blocks an SM (64 / 94 B), the
//   plane's texel read before the shaping and attenuation      1.128
//   the same with the running sums in shared memory (64 / 46 B)  1.126
//   tiled at 4 blocks, the texel read after the attenuation    1.142
//   at 3 blocks an SM (80 / 0), or with no register bound (80) 1.195, 1.190
//   the first G1: 2 blocks an SM (88 / 0), the texel late      1.403
//   the same staging 128 slots a barrier pair                  1.407
// Clustered lists keep 2 blocks an SM (113 registers, no spill; 372 bytes
// spilled at 3).

#include <cuda_runtime.h>

namespace {

constexpr int kRec = 32;         // floats per packed light record
constexpr int kGroupMax = 64;    // slots prepared per barrier pair
constexpr int kMaxThreads = 256;
constexpr float kInnerHi = (float)(1.5707963267948966 - 0.02);
constexpr float kOuterHi = (float)(1.5707963267948966 - 0.005);
constexpr float kBound = 1e6f;   // a bounded light field, position, camera
constexpr float kNormalBound = 2.0f;
constexpr int kSpot = 2, kRect = 3, kTube = 4;
constexpr int kBounded = 1, kNoRadiance = 2;

// torch's clamp / clamp_min / clamp_max with scalar bounds, its clamp with
// tensor bounds and torch.maximum / minimum: a NaN operand propagates.
__device__ __forceinline__ float clamp_s(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// (x0, x1, x2).sum(-1) as PyTorch's CUDA reduction adds it.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return ((x0 + x2) + 0.0f) + x1;
}

// One component of torch.linalg.cross: a * b - c * d as its kernel rounds.
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = cross_term(a[1], b[2], a[2], b[1]);
  o[1] = cross_term(a[2], b[0], a[0], b[2]);
  o[2] = cross_term(a[0], b[1], a[1], b[0]);
}

// light_runtime._norm: v / clamp(sqrt(sum(v * v)), 1e-8).
__device__ __forceinline__ void norm3(float v[3]) {
  const float d =
      clamp_lo(sqrtf(sum3(v[0] * v[0], v[1] * v[1], v[2] * v[2])), 1e-8f);
  v[0] = v[0] / d;
  v[1] = v[1] / d;
  v[2] = v[2] / d;
}

// A list slot's light as the per-pixel code reads it: the record's fields
// that do not depend on the pixel, in eval_local_lights' operations.
struct Light {
  int type, model, plane, flags;
  float pos[3];
  float fwd[3];      // spot, rect: unit forward
  float ra[3];       // rect: right; tube: segment start
  float rb[3];       // rect: up; tube: segment
  float e0, e1;      // rect: half extents; tube: e0 its squared length
  float rng, rng2;   // clamp(range, 0.001) and its square
  float rsoft;       // tube: clamp(range, 0.1)
  float cos_outer, cden;  // spot
  float apow, abias, acut;
  float ci[3];       // clamp(color, 0) * clamp(intensity, 0)
  float spw, ssc;    // the kind's specular power and scale
};

// The light of list entry idx (-1: a padded slot).  Tiled lists read a
// zero record for a padded slot and zero the intensity of a record whose
// range is not above 0; clustered lists read the record of light 0 for a
// padded slot and zero its intensity (accumulate_local_lights_plain).
template <bool CLUSTERED>
__device__ __forceinline__ Light prepare(const float* __restrict__ packed,
                                         int n_lights, long long idx,
                                         const long long* __restrict__ sidx,
                                         int n_planes) {
  const bool valid = idx >= 0;
  const long long id = valid ? (idx < n_lights ? idx : n_lights - 1) : 0;
  const float* r = packed + (size_t)id * kRec;
  const bool zero = !CLUSTERED && !valid;
  float f[28];
#pragma unroll
  for (int i = 0; i < 28; ++i) f[i] = zero ? 0.0f : __ldg(r + i);
  const float intensity =
      (CLUSTERED ? valid : f[17] > 0.0f) ? f[16] : 0.0f;
  bool bounded = fabsf(intensity) <= kBound;
#pragma unroll
  for (int i = 0; i < 28; ++i)
    if (i != 16) bounded = bounded && fabsf(f[i]) <= kBound;

  Light L;
  L.type = (int)f[0];
  L.model = (int)f[24];
  L.plane = 0;
  if (sidx != nullptr) {
    const long long p = __ldg(sidx + id);
    L.plane = (int)(p < 0 ? 0 : (p < n_planes ? p : n_planes - 1));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    L.pos[c] = f[1 + c];
    L.fwd[c] = f[4 + c];
    L.ra[c] = L.rb[c] = 0.0f;
    L.ci[c] = clamp_lo(f[13 + c], 0.0f) * clamp_lo(intensity, 0.0f);
  }
  L.e0 = L.e1 = L.cos_outer = L.cden = 0.0f;
  L.spw = 36.0f;
  L.ssc = 0.30f;
  if (L.type == kSpot || L.type == kRect) norm3(L.fwd);
  if (L.type == kSpot) {
    const float inner = clamp_s(f[18], 0.02f, kInnerHi);
    const float lo = inner + 0.005f;
    const float outer = minimum(maximum(maximum(lo, f[19]), lo), kOuterHi);
    const float cos_inner = cosf(inner);
    L.cos_outer = cosf(outer);
    L.cden = clamp_lo(cos_inner - L.cos_outer, 1e-5f);
    L.spw = 34.0f;
    L.ssc = 0.32f;
  } else if (L.type == kRect) {
    float up_hint[3] = {f[7], f[8], f[9]};
    norm3(up_hint);
    float right[3], up[3];
    cross3(up_hint, L.fwd, right);
    norm3(right);
    cross3(L.fwd, right, up);
    norm3(up);
    cross3(up, L.fwd, right);
    norm3(right);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      L.ra[c] = right[c];
      L.rb[c] = up[c];
    }
    L.e0 = clamp_lo(f[20], 0.05f);
    L.e1 = clamp_lo(f[21], 0.05f);
    L.spw = 26.0f;
    L.ssc = 0.26f;
  } else if (L.type == kTube) {
    float axis[3] = {f[10], f[11], f[12]};
    norm3(axis);
    const float half_len = clamp_lo(f[22], 0.1f);
    const float twice = 2.0f * half_len;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      L.ra[c] = L.pos[c] - axis[c] * half_len;
      L.rb[c] = axis[c] * twice;
    }
    L.e0 = clamp_lo(sum3(L.rb[0] * L.rb[0], L.rb[1] * L.rb[1],
                         L.rb[2] * L.rb[2]),
                    1e-8f);
    L.spw = 22.0f;
    L.ssc = 0.20f;
  }
  L.rng = clamp_lo(f[17], 0.001f);
  L.rng2 = L.rng * L.rng;
  L.rsoft = clamp_lo(f[17], 0.1f);
  L.apow = clamp_lo(f[25], 0.001f);
  L.abias = f[26];
  L.acut = f[27];
  L.flags = (bounded ? kBounded : 0)
            | (L.ci[0] == 0.0f && L.ci[1] == 0.0f && L.ci[2] == 0.0f
                   ? kNoRadiance : 0);
  return L;
}

struct Pixel {
  float px, py, pz, nx, ny, nz, vx, vy, vz;
  const float* vis;  // this pixel's plane 0, or null
  int vis_sk;
  bool bounded;
};

// One (pixel, light) pair: t = (diffuse rgb, specular rgb) as
// eval_local_lights and _shadowed compute them.  Returns false, leaving t
// unset, only for a bounded pair whose terms are +0 or -0.
__device__ __forceinline__ bool light_term(const Light& L, const Pixel& P,
                                           float t[6]) {
  const bool fast = P.bounded && (L.flags & kBounded);
  if (fast && (L.flags & kNoRadiance)) return false;
  float ex = L.pos[0], ey = L.pos[1], ez = L.pos[2];
  if (L.type == kRect) {
    const float dx = P.px - L.pos[0], dy = P.py - L.pos[1],
                dz = P.pz - L.pos[2];
    const float ux = clamp_t(sum3(dx * L.ra[0], dy * L.ra[1], dz * L.ra[2]),
                             -L.e0, L.e0);
    const float uy = clamp_t(sum3(dx * L.rb[0], dy * L.rb[1], dz * L.rb[2]),
                             -L.e1, L.e1);
    ex = (L.pos[0] + L.ra[0] * ux) + L.rb[0] * uy;
    ey = (L.pos[1] + L.ra[1] * ux) + L.rb[1] * uy;
    ez = (L.pos[2] + L.ra[2] * ux) + L.rb[2] * uy;
  } else if (L.type == kTube) {
    const float s = clamp_s(sum3((P.px - L.ra[0]) * L.rb[0],
                                 (P.py - L.ra[1]) * L.rb[1],
                                 (P.pz - L.ra[2]) * L.rb[2]) / L.e0,
                            0.0f, 1.0f);
    ex = L.ra[0] + L.rb[0] * s;
    ey = L.ra[1] + L.rb[1] * s;
    ez = L.ra[2] + L.rb[2] * s;
  }
  const float tx = ex - P.px, ty = ey - P.py, tz = ez - P.pz;
  const float dist = sqrtf(sum3(tx * tx, ty * ty, tz * tz));
  if (fast && !(dist > 1e-4f && dist < L.rng)) return false;
  const float dcl = clamp_lo(dist, 1e-8f);
  const float lx = tx / dcl, ly = ty / dcl, lz = tz / dcl;
  const float ndl = clamp_lo(sum3(P.nx * lx, P.ny * ly, P.nz * lz), 0.0f);
  if (fast && !(ndl > 0.0f)) return false;
  // The plane's texel is read here, so its latency overlaps the
  // shaping and the attenuation.
  const float vis =
      P.vis != nullptr ? P.vis[(size_t)L.plane * P.vis_sk] : 1.0f;

  float shaping = 1.0f;
  if (L.type == kSpot) {
    const float ct = sum3(-lx * L.fwd[0], -ly * L.fwd[1], -lz * L.fwd[2]);
    if (fast && !(ct > L.cos_outer)) return false;
    const float tt = clamp_s((ct - L.cos_outer) / L.cden, 0.0f, 1.0f);
    shaping = ct > L.cos_outer ? (tt * tt) * (3.0f - 2.0f * tt) : 0.0f;
  } else if (L.type == kRect) {
    const float facing =
        clamp_lo(sum3(L.fwd[0] * -lx, L.fwd[1] * -ly, L.fwd[2] * -lz), 0.0f);
    if (fast && !(facing > 0.0f)) return false;
    shaping = facing > 0.0f ? 0.65f + 0.55f * facing : 0.0f;
  } else if (L.type == kTube) {
    const float soft = clamp_s(1.0f - dist / L.rsoft, 0.0f, 1.0f);
    shaping = 0.75f + 0.35f * soft;
  }

  // eval_distance_attenuation, times the clamped shaping.
  const float nrm = clamp_s(1.0f - dist / L.rng, 0.0f, 1.0f);
  float fall;
  if (L.model == 0) {
    fall = nrm;
  } else if (L.model == 1) {
    fall = (nrm * nrm) * (3.0f - 2.0f * nrm);
  } else {
    fall = (clamp_hi(L.rng2 / maximum(dist * dist, L.abias), 1.0f) * nrm)
           * nrm;
  }
  fall = powf(clamp_lo(fall, 0.0f), L.apow);
  if (L.acut > 0.0f && fall < L.acut) fall = 0.0f;
  const float atten =
      (dist < L.rng ? clamp_lo(fall, 0.0f) : 0.0f) * clamp_lo(shaping, 0.0f);
  const bool live = dist > 1e-4f && ndl > 0.0f && atten > 0.0f;
  if (fast && !live) return false;
  if (P.vis != nullptr && fast && vis == 0.0f) return false;

  float hv[3] = {lx + P.vx, ly + P.vy, lz + P.vz};
  norm3(hv);
  const float ndh =
      clamp_lo(sum3(P.nx * hv[0], P.ny * hv[1], P.nz * hv[2]), 0.0f);
  const float spec = L.ssc * powf(ndh, L.spw);
  const float lf = live ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rad = L.ci[c] * atten;
    t[c] = (rad * ndl) * lf;
    t[3 + c] = (rad * spec) * lf;
    if (P.vis != nullptr) {
      t[c] = t[c] * vis;
      t[3 + c] = t[3 + c] * vis;
    }
  }
  return true;
}

struct Args {
  const float* wp;
  int wp_sy, wp_sx, wp_sc;
  const float* nrm;
  int n_sy, n_sx, n_sc;
  const float* cam;
  const float* packed;
  int n_lights;
  const long long* lists;
  int cap, chunk, n_chunks;
  const long long* cluster;
  int cl_sy, cl_sx, slices;
  const float* vis;
  int v_sy, v_sx, v_sk, n_planes;
  const long long* sidx;
  float* diffuse;
  float* specular;
  int width, height, tile_size, tiles_x;
};

__device__ __forceinline__ long long list_entry(const Args& a, long long row,
                                                int slot) {
  return slot < a.cap ? __ldg(a.lists + row * a.cap + slot) : -1;
}

template <bool CLUSTERED>
__global__ void __launch_bounds__(kMaxThreads, CLUSTERED ? 2 : 4)
local_lights_kernel(const Args a) {
  __shared__ Light staged[kGroupMax];
  const int ts = a.tile_size, npx = ts * ts;
  const int tile = blockIdx.x;
  const int y0 = (tile / a.tiles_x) * ts, x0 = (tile % a.tiles_x) * ts;
  const int cap_p = a.n_chunks * a.chunk;
  const int group = a.chunk * (kGroupMax / a.chunk);  // whole chunks
  const float cx = a.cam[0], cy = a.cam[1], cz = a.cam[2];
  const bool cam_bounded =
      fabsf(cx) <= kBound && fabsf(cy) <= kBound && fabsf(cz) <= kBound;

  for (int p0 = 0; p0 < npx; p0 += blockDim.x) {
    const int pi = p0 + threadIdx.x;
    const int y = y0 + pi / ts, x = x0 + pi % ts;
    const bool active = pi < npx && y < a.height && x < a.width;
    Pixel P;
    long long row = tile;
    float dsum[3] = {0.0f, 0.0f, 0.0f}, ssum[3] = {0.0f, 0.0f, 0.0f};
    if (active) {
      const float* w = a.wp + (size_t)y * a.wp_sy + (size_t)x * a.wp_sx;
      const float* n = a.nrm + (size_t)y * a.n_sy + (size_t)x * a.n_sx;
      P.px = w[0];
      P.py = w[a.wp_sc];
      P.pz = w[2 * a.wp_sc];
      P.nx = n[0];
      P.ny = n[a.n_sc];
      P.nz = n[2 * a.n_sc];
      float v[3] = {cx - P.px, cy - P.py, cz - P.pz};
      norm3(v);
      P.vx = v[0];
      P.vy = v[1];
      P.vz = v[2];
      P.bounded = cam_bounded && fabsf(P.px) <= kBound
                  && fabsf(P.py) <= kBound && fabsf(P.pz) <= kBound
                  && fabsf(P.nx) <= kNormalBound
                  && fabsf(P.ny) <= kNormalBound
                  && fabsf(P.nz) <= kNormalBound;
      P.vis = nullptr;
      P.vis_sk = a.v_sk;
      if (a.vis != nullptr) {
        P.vis = a.vis + (size_t)y * a.v_sy + (size_t)x * a.v_sx;
        for (int k = 0; k < a.n_planes; ++k)
          P.bounded = P.bounded && isfinite(P.vis[(size_t)k * a.v_sk]);
      }
      if (CLUSTERED) {
        // A slice outside [0, slices) (the plain version's index error)
        // reads the nearest slice's list.
        const long long cl =
            a.cluster[(size_t)y * a.cl_sy + (size_t)x * a.cl_sx];
        row = (long long)tile * a.slices
              + (cl < 0 ? 0 : (cl < a.slices ? cl : a.slices - 1));
      }
    }

    for (int g0 = 0; g0 < cap_p; g0 += group) {
      const int gn = min(group, cap_p - g0);
      if (!CLUSTERED) {
        __syncthreads();
        for (int j = threadIdx.x; j < gn; j += blockDim.x)
          staged[j] = prepare<false>(a.packed, a.n_lights,
                                     list_entry(a, tile, g0 + j), a.sidx,
                                     a.n_planes);
        __syncthreads();
      }
      if (!active) continue;
#pragma unroll 1
      for (int c0 = 0; c0 < gn; c0 += a.chunk) {
        // The chunk's sum: slot j into accumulator j % 4.
        float acc[4][6];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < 6; ++c) acc[k][c] = 0.0f;
#pragma unroll 1
        for (int j0 = 0; j0 < a.chunk; j0 += 4) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + k;
            if (j >= a.chunk) break;
            float t[6];
            bool nz;
            if (CLUSTERED) {
              const Light L = prepare<true>(
                  a.packed, a.n_lights, list_entry(a, row, g0 + c0 + j),
                  a.sidx, a.n_planes);
              nz = light_term(L, P, t);
            } else {
              nz = light_term(staged[c0 + j], P, t);
            }
            if (nz) {
#pragma unroll
              for (int c = 0; c < 6; ++c) acc[k][c] = acc[k][c] + t[c];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dsum[c] = dsum[c]
                    + (((acc[0][c] + acc[1][c]) + acc[2][c]) + acc[3][c]);
          ssum[c] = ssum[c] + (((acc[0][3 + c] + acc[1][3 + c])
                                + acc[2][3 + c]) + acc[3][3 + c]);
        }
      }
    }
    if (active) {
      const size_t q = ((size_t)y * a.width + x) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a.diffuse[q + c] = dsum[c];
        a.specular[q + c] = ssum[c];
      }
    }
  }
}

}  // namespace

// Pointers to f32 (world_pos, normal, camera, packed records, vis, outputs)
// and int64 (lists, cluster, shadow index) device memory; strides in
// elements; cluster null for tiled lists, vis and sidx null without planes.
extern "C" int lsr_local_lights(
    const void* wp, int wp_sy, int wp_sx, int wp_sc, const void* nrm,
    int n_sy, int n_sx, int n_sc, const void* cam, const void* packed,
    int n_lights, const void* lists, int cap, int chunk, const void* cluster,
    int cl_sy, int cl_sx, int slices, const void* vis, int v_sy, int v_sx,
    int v_sk, int n_planes, const void* sidx, void* diffuse, void* specular,
    int width, int height, int tile_size, void* stream) {
  if (tile_size < 1 || chunk < 1 || chunk > 32 || cap < 0 || n_lights < 1
      || width < 1 || height < 1 || slices < 1
      || (vis != nullptr && (sidx == nullptr || n_planes < 1)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(wp), wp_sy, wp_sx, wp_sc,
         static_cast<const float*>(nrm), n_sy, n_sx, n_sc,
         static_cast<const float*>(cam), static_cast<const float*>(packed),
         n_lights, static_cast<const long long*>(lists), cap, chunk,
         (cap + chunk - 1) / chunk, static_cast<const long long*>(cluster),
         cl_sy, cl_sx, slices, static_cast<const float*>(vis), v_sy, v_sx,
         v_sk, n_planes, static_cast<const long long*>(sidx),
         static_cast<float*>(diffuse), static_cast<float*>(specular), width,
         height, tile_size, (width + tile_size - 1) / tile_size};
  const int tiles = a.tiles_x * ((height + tile_size - 1) / tile_size);
  const int px = tile_size * tile_size;
  const int threads = px < kMaxThreads ? (px + 31) / 32 * 32 : kMaxThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster != nullptr)
    local_lights_kernel<true><<<tiles, threads, 0, s>>>(a);
  else
    local_lights_kernel<false><<<tiles, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
