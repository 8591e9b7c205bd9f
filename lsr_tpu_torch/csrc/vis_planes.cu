// Kernel V2: the local-shadow visibility planes at full resolution,
// (K + 1, H, W): each plane evaluated on the vis_scale-strided grid inside
// the window kernel V1 (vis_footprint.cu) chose for it and 1.0 elsewhere
// (1.0 everywhere for a plane whose run flag is false, an empty footprint
// or a culled light, and for plane K, the constant plane of unshadowed
// lights), then, at vis_scale > 1, upsampled bilinearly to the frame.
//
// Replaces no pallas_call: lsr_tpu evaluates the planes with XLA gathers
// inside its lax.cond crop cascade, lsr_tpu/lighting/local_shadows.py:674
// (_cropped_plane; the planes _spot_plane_one :749, _point_plane_one :838,
// the sampling _uvz_to_texel / _esm_vis / _pcf_from_rows), and upsamples
// them with jax.image.resize (:966-971).  Plain version:
// vis_planes_full_plain in lighting/local_shadows.py (vis_planes_plain,
// then core/image.resize_bilinear), which this kernel equals bit for bit:
// the same operations in the same order, built with -fmad=false; the PCF
// box's mean multiplies by the f32 reciprocal of its tap count, as
// PyTorch's CUDA division by a scalar does; the upsample is
// resize_bilinear's separable two-tap sum, rows first, then columns, each
// a * w0 + b * w1 with the product and the sum rounded apart, on the taps
// and weights core/image._taps makes.
//
// Per strided pixel and plane: a spot projects by its slot's
// view-projection, a point picks its cube face by the major axis of the
// light-to-pixel vector and projects by that face's own view-projection
// (in reach: inside the range sphere); outside the map the plane is 1.0.
// Then the slope-scaled bias from N.L to the light.  ESM fetches one q16
// texel of the prefiltered soft map and compares it with the linearised
// depth (clamp(exp(c (soft - z)), 0, 1)); PCF counts the (2r+1)^2 box of
// depth tests on clamped texels, in q16 quanta on int32 tables or in f32
// on f32 depth tables (lsr_tpu's TAPS_U16 False, a template parameter).
// Then 1 + (lit - 1) * strength.
//
// What bounds it on this card: bytes.  The full-resolution planes are
// written once ((K + 1) H W 4 bytes, 91 MB at flagship (a)); world
// positions and normals are read once at the strided pixels that some
// running window holds (24 bytes a pixel); the tables touched where the
// windows' pixels sample them.  The
// operations (~60 a pixel and plane, 25 compares under PCF, 9 for the
// upsample of an output) are far below.
//
// What the design does about it: one launch writes every plane.  A block
// owns a tile of the output: at vis_scale > 1, 8 x 128 pixels (fewer rows
// where K planes would overflow 48 KB of shared memory), whose taps reach
// a halo of strided pixels (the tile's strided rows and columns plus one
// sample), its size fixed on the host when the frame is built.  Each
// thread takes strided pixels of the halo, reads the world position and
// normal once, runs the plane loop (a pixel off a plane's window, or of a
// plane that does not run, is 1.0 and costs no evaluation) and leaves the
// K values in shared memory.  Then each thread writes 4 neighbouring
// outputs of a row for every plane, 16-byte stores where the width is a
// multiple of 4.  At vis_scale 1 there is no halo: a block owns 32 x 8
// pixels, a thread one, evaluated in place (four pixels a thread held 92
// registers and ran at a quarter of the occupancy, 0.184 ms at flagship
// (d) against 0.149 for the first V2).  The windows sit in shared memory;
// the tables are read through the read-only path.

#include <cuda_runtime.h>

#include <type_traits>

#include "vis_common.cuh"

namespace {

using lsr_vis::clamp;
using lsr_vis::clamp_min;
using lsr_vis::clampi;
using lsr_vis::kPoint;
using lsr_vis::kThreads;
using lsr_vis::kWarps;

constexpr int kTileW = 128;  // output columns of an upsampling block
constexpr int kDirectW = 32;  // a block's pixels at vis_scale 1: 32 x 8
constexpr int kDirectH = kThreads / kDirectW;

// Uniforms, device floats: bias_const, bias_slope, esm_c, near, far_min,
// 1 / 65535, 1 / (2r + 1)^2 (all f32 values made on the host).
enum { kBiasConst, kBiasSlope, kEsmC, kNear, kFarMin, kInvQ16, kInvBox };

// Texel: int (q16 quanta) or float (f32 depth, PCF only).
template <typename Texel>
struct Tables {
  const int* info;        // (K, 2) kind, base slot
  const float* spot_vp;   // (n_spot, 16)
  const float* point_vp;  // (n_point * 6, 16)
  const float* cpos;      // (K, 3)
  const float* crange;    // (K,)
  const float* strength;  // (K,)
  const Texel* spot_taps;   // (n_spot, S1, S1)
  const Texel* point_taps;  // (n_point * 6, S2, S2)
  int spot_size, point_size;
};

// The upsample's taps and weights of each output row and column
// (core/image._taps: i0, i1 int64, w0, w1 f32).
struct Taps {
  const long long *i0y, *i1y;
  const float *w0y, *w1y;
  const long long *i0x, *i1x;
  const float *w0x, *w1x;
};

template <typename Texel>
__device__ float plane_value(const Tables<Texel>& t,
                             const float* __restrict__ uni, int k, int esm,
                             int radius, float x, float y, float z, float nx,
                             float ny, float nz) {
  const int kind = __ldg(t.info + 2 * k), base = __ldg(t.info + 2 * k + 1);
  const float rx = x - __ldg(t.cpos + 3 * k), ry = y - __ldg(t.cpos + 3 * k + 1),
              rz = z - __ldg(t.cpos + 3 * k + 2);
  const float len = lsr_vis::norm3(rx, ry, rz);
  int slot = base, size = t.spot_size;
  const float* m = t.spot_vp + 16 * base;
  const Texel* taps = t.spot_taps;
  if (kind == kPoint) {
    if (!(len > 1e-4f && len < __ldg(t.crange + k))) return 1.0f;
    const float ax = fabsf(rx), ay = fabsf(ry), az = fabsf(rz);
    const int face = (ax >= ay && ax >= az) ? (rx >= 0.0f ? 0 : 1)
                     : (ay >= az)           ? (ry >= 0.0f ? 2 : 3)
                                            : (rz >= 0.0f ? 4 : 5);
    slot = base + face;
    m = t.point_vp + 16 * slot;
    size = t.point_size;
    taps = t.point_taps;
  }
  lsr_vis::Uvz p;
  if (!lsr_vis::in_map<true>(m, x, y, z, p)) return 1.0f;
  // _bias_ndl
  const float d = clamp_min(len, 1e-8f);
  const float lx = -rx / d, ly = -ry / d, lz = -rz / d;
  const float ndl = clamp_min((nx * lx + ny * ly) + nz * lz, 0.0f);
  const float bias =
      uni[kBiasConst] + uni[kBiasSlope] * (1.0f - clamp(ndl, 0.0f, 1.0f));

  const float top = (float)(size - 1);
  const int cx = (int)clamp(rintf(p.u * top), 0.0f, top);
  const int cy = (int)clamp(rintf(p.v * top), 0.0f, top);
  const Texel* tab = taps + (long long)slot * size * size;
  float lit;
  constexpr bool kQ16 = std::is_same<Texel, int>::value;
  if (kQ16 && esm) {
    const float soft = (float)__ldg(tab + cy * size + cx) * uni[kInvQ16];
    const float far = clamp_min(__ldg(t.crange + k), uni[kFarMin]);
    const float near = uni[kNear];
    const float z_lin = (near * p.z) / (far - p.z * (far - near));
    lit = clamp(expf((soft - (z_lin - bias)) * uni[kEsmC]), 0.0f, 1.0f);
  } else {
    const float zt = p.z - bias;
    const Texel q = kQ16 ? (Texel)clamp(rintf(zt * 65535.0f), 0.0f, 65535.0f)
                         : (Texel)zt;
    float count = 0.0f;
    for (int dy = -radius; dy <= radius; ++dy) {
      const int row = clampi(cy + dy, 0, size - 1) * size;
      for (int dx = -radius; dx <= radius; ++dx) {
        const int col = clampi(cx + dx, 0, size - 1);
        count = count + (q <= __ldg(tab + row + col) ? 1.0f : 0.0f);
      }
    }
    lit = count * uni[kInvBox];
  }
  return 1.0f + (lit - 1.0f) * clamp(__ldg(t.strength + k), 0.0f, 1.0f);
}

// The K windows in shared memory as (y0, x0, y1, x1), empty for a plane
// that does not run.
__device__ __forceinline__ void stage_windows(
    const int* __restrict__ win, const unsigned char* __restrict__ run,
    int n_planes, int* wins) {
  for (int k = threadIdx.x; k < n_planes; k += kThreads) {
    const bool go = run[k] != 0;
    const int y0 = win[4 * k], x0 = win[4 * k + 1];
    wins[4 * k] = y0;
    wins[4 * k + 1] = x0;
    wins[4 * k + 2] = go ? y0 + win[4 * k + 2] : y0;
    wins[4 * k + 3] = go ? x0 + win[4 * k + 3] : x0;
  }
}

__device__ __forceinline__ bool inside(const int* wk, int y, int x) {
  return y >= wk[0] && y < wk[2] && x >= wk[1] && x < wk[3];
}

// Four outputs of a row from column x on: one 16-byte store where the
// row's width is a multiple of 4 (x is), else one store a column inside.
__device__ __forceinline__ void store4(float* __restrict__ p, const float* v,
                                       int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && j < left; ++j) p[j] = v[j];
  }
}

// vis_scale 1: a block owns 32 x 8 pixels, a thread one of them, read
// once and evaluated in place for every plane; a warp's stores are one
// 128-byte row.
template <typename Texel>
__global__ void __launch_bounds__(kThreads)
vis_planes_direct(const float* __restrict__ wp, int wsy, int wsx, int ws3,
                  const float* __restrict__ nm, int nsy, int nsx, int ns3,
                  int h, int w, Tables<Texel> t,
                  const int* __restrict__ win,
                  const unsigned char* __restrict__ run,
                  const float* __restrict__ uni, float* __restrict__ out,
                  int n_planes, int esm, int radius) {
  extern __shared__ int wins[];  // (K, 4)
  stage_windows(win, run, n_planes, wins);
  __syncthreads();
  const int x = blockIdx.x * kDirectW + threadIdx.x % kDirectW;
  const int y = blockIdx.y * kDirectH + threadIdx.x / kDirectW;
  if (y >= h || x >= w) return;
  float px, py, pz, qx, qy, qz;
  bool loaded = false;
  for (int k = 0; k < n_planes; ++k) {
    float v = 1.0f;
    if (inside(wins + 4 * k, y, x)) {
      if (!loaded) {
        lsr_vis::load3(wp, wsy, wsx, ws3, y, x, 1, px, py, pz);
        lsr_vis::load3(nm, nsy, nsx, ns3, y, x, 1, qx, qy, qz);
        loaded = true;
      }
      v = plane_value(t, uni, k, esm, radius, px, py, pz, qx, qy, qz);
    }
    out[((long long)k * h + y) * w + x] = v;
  }
  out[((long long)n_planes * h + y) * w + x] = 1.0f;
}

// vis_scale > 1: a block owns tile_h x 128 outputs; the strided pixels
// their taps reach (a halo of at most halo_h x halo_w) are evaluated into
// shared memory, then every plane of the tile is upsampled from there.
template <typename Texel>
__global__ void __launch_bounds__(kThreads)
vis_planes_up(const float* __restrict__ wp, int wsy, int wsx, int ws3,
              const float* __restrict__ nm, int nsy, int nsx, int ns3, int h,
              int w, int scale, Tables<Texel> t, Taps tp,
              const int* __restrict__ win,
              const unsigned char* __restrict__ run,
              const float* __restrict__ uni, float* __restrict__ out,
              int n_planes, int esm, int radius, int tile_h, int halo_h,
              int halo_w) {
  extern __shared__ int wins[];                           // (K, 4)
  float* halo = reinterpret_cast<float*>(wins + 4 * n_planes);  // (K, hh, hw)
  stage_windows(win, run, n_planes, wins);
  const int ty0 = blockIdx.y * tile_h, tx0 = blockIdx.x * kTileW;
  const int ty1 = min(ty0 + tile_h, h), tx1 = min(tx0 + kTileW, w);
  // _taps' indices rise with the output, so the tile's first and last
  // outputs bound its halo.
  const int hy0 = (int)__ldg(tp.i0y + ty0), hx0 = (int)__ldg(tp.i0x + tx0);
  const int nhy = (int)__ldg(tp.i1y + ty1 - 1) - hy0 + 1;
  const int nhx = (int)__ldg(tp.i1x + tx1 - 1) - hx0 + 1;
  if (nhy > halo_h || nhx > halo_w) __trap();
  __syncthreads();

  for (int i = threadIdx.x; i < nhy * nhx; i += kThreads) {
    const int r = i / nhx, c = i % nhx;
    const int ys = hy0 + r, xs = hx0 + c;
    float px, py, pz, qx, qy, qz;
    bool loaded = false;
    for (int k = 0; k < n_planes; ++k) {
      float v = 1.0f;
      if (inside(wins + 4 * k, ys, xs)) {
        if (!loaded) {
          lsr_vis::load3(wp, wsy, wsx, ws3, ys, xs, scale, px, py, pz);
          lsr_vis::load3(nm, nsy, nsx, ns3, ys, xs, scale, qx, qy, qz);
          loaded = true;
        }
        v = plane_value(t, uni, k, esm, radius, px, py, pz, qx, qy, qz);
      }
      halo[(k * halo_h + r) * halo_w + c] = v;
    }
  }
  __syncthreads();

  const int x = tx0 + (threadIdx.x % 32) * 4;
  if (x >= w) return;
  const int left = w - x;
  const bool vec = (w % 4) == 0;
  int cx0[4], cx1[4];
  float wx0[4], wx1[4];
  for (int j = 0; j < 4; ++j) {
    const int xj = min(x + j, w - 1);
    cx0[j] = (int)__ldg(tp.i0x + xj) - hx0;
    cx1[j] = (int)__ldg(tp.i1x + xj) - hx0;
    wx0[j] = __ldg(tp.w0x + xj);
    wx1[j] = __ldg(tp.w1x + xj);
  }
  for (int y = ty0 + (int)threadIdx.x / 32; y < ty1; y += kWarps) {
    const int ry0 = (int)__ldg(tp.i0y + y) - hy0;
    const int ry1 = (int)__ldg(tp.i1y + y) - hy0;
    const float wy0 = __ldg(tp.w0y + y), wy1 = __ldg(tp.w1y + y);
    float v[4];
    for (int k = 0; k < n_planes; ++k) {
      const float* a = halo + (k * halo_h + ry0) * halo_w;
      const float* b = halo + (k * halo_h + ry1) * halo_w;
      for (int j = 0; j < 4; ++j) {
        const float r0 = a[cx0[j]] * wy0 + b[cx0[j]] * wy1;
        const float r1 = a[cx1[j]] * wy0 + b[cx1[j]] * wy1;
        v[j] = r0 * wx0[j] + r1 * wx1[j];
      }
      store4(out + ((long long)k * h + y) * w + x, v, left, vec);
    }
    // Plane K: the upsample of 1.0, computed as for any plane.
    const float r1 = 1.0f * wy0 + 1.0f * wy1;
    for (int j = 0; j < 4; ++j) v[j] = r1 * wx0[j] + r1 * wx1[j];
    store4(out + ((long long)n_planes * h + y) * w + x, v, left, vec);
  }
}

template <typename Texel>
int launch(const float* wp, int wsy, int wsx, int ws3, const float* nm,
           int nsy, int nsx, int ns3, int h, int w, int scale,
           const Tables<Texel>& t, const Taps& tp, const int* win,
           const unsigned char* run, const float* uni, float* out,
           int n_planes, int esm, int radius, int tile_h, int halo_h,
           int halo_w, cudaStream_t s) {
  const size_t wins = sizeof(int) * 4 * (size_t)n_planes;
  if (tp.i0y == nullptr) {
    const dim3 grid((w + kDirectW - 1) / kDirectW,
                    (h + kDirectH - 1) / kDirectH);
    vis_planes_direct<Texel><<<grid, kThreads, wins, s>>>(
        wp, wsy, wsx, ws3, nm, nsy, nsx, ns3, h, w, t, win, run, uni, out,
        n_planes, esm, radius);
  } else {
    const size_t smem =
        wins + sizeof(float) * (size_t)n_planes * halo_h * halo_w;
    if (smem > 48 * 1024 || tile_h < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((w + kTileW - 1) / kTileW, (h + tile_h - 1) / tile_h);
    vis_planes_up<Texel><<<grid, kThreads, smem, s>>>(
        wp, wsy, wsx, ws3, nm, nsy, nsx, ns3, h, w, scale, t, tp, win, run,
        uni, out, n_planes, esm, radius, tile_h, halo_h, halo_w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// h, w: the full-resolution output.  taps: the eight (n,) tensors of
// core/image._taps, rows (i0, i1, w0, w1) then columns, or all null at
// vis_scale 1.  f32_taps: the tables are f32 depth (PCF), else int32 q16.
extern "C" int lsr_vis_planes(
    const float* wp, int wsy, int wsx, int ws3, const float* nm, int nsy,
    int nsx, int ns3, int h, int w, int scale, const int* info,
    const float* spot_vp, const float* point_vp, const float* cpos,
    const float* crange, const float* strength, const void* spot_taps,
    const void* point_taps, int spot_size, int point_size, int f32_taps,
    const int* win, const unsigned char* run, const float* uni, float* out,
    int n_planes, int esm, int radius, const long long* i0y,
    const long long* i1y, const float* w0y, const float* w1y,
    const long long* i0x, const long long* i1x, const float* w0x,
    const float* w1x, int tile_h, int halo_h, int halo_w, void* stream) {
  const Taps tp{i0y, i1y, w0y, w1y, i0x, i1x, w0x, w1x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32_taps) {
    if (esm) return (int)cudaErrorInvalidValue;
    const Tables<float> t{info, spot_vp, point_vp, cpos, crange, strength,
                          static_cast<const float*>(spot_taps),
                          static_cast<const float*>(point_taps), spot_size,
                          point_size};
    return launch(wp, wsy, wsx, ws3, nm, nsy, nsx, ns3, h, w, scale, t, tp,
                  win, run, uni, out, n_planes, esm, radius, tile_h, halo_h,
                  halo_w, s);
  }
  const Tables<int> t{info, spot_vp, point_vp, cpos, crange, strength,
                      static_cast<const int*>(spot_taps),
                      static_cast<const int*>(point_taps), spot_size,
                      point_size};
  return launch(wp, wsy, wsx, ws3, nm, nsy, nsx, ns3, h, w, scale, t, tp, win,
                run, uni, out, n_planes, esm, radius, tile_h, halo_h, halo_w,
                s);
}
