// The per-pixel arithmetic shared by kernels V1 (vis_footprint.cu) and V2
// (vis_planes.cu), in the operation order of their plain versions in
// lsr_tpu_torch/lighting/local_shadows.py, so that a kernel built with
// -fmad=false (no contraction of a * b + c) rounds as the torch ops do.

#pragma once

#include <cuda_runtime.h>

namespace lsr_vis {

constexpr int kSpot = 2;   // SHADOW_SPOT_2D
constexpr int kPoint = 3;  // SHADOW_POINT_CUBE
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// m3.norm3: the squares exact in double, sqrt(fma(z, z, fma(y, y, x * x)))
// rounded as the port rounds it (each sum in double, then to float).
__device__ __forceinline__ float norm3(float x, float y, float z) {
  const float xx = x * x;
  const float s = __double2float_rn(
      __dadd_rn(__dmul_rn((double)y, (double)y), (double)xx));
  return sqrtf(__double2float_rn(
      __dadd_rn(__dmul_rn((double)z, (double)z), (double)s)));
}

// _project_rows: one row of a row-major 4x4, summed left to right.
__device__ __forceinline__ float project_row(const float4 r, float x, float y,
                                             float z) {
  return ((r.x * x + r.y * y) + r.z * z) + r.w;
}

struct Uvz {
  float u, v, z;
};

// A row of a 16-byte aligned row-major 4x4 in shared memory (V1) or
// through the read-only path (V2): one 16-byte load.
template <bool kGlobal>
__device__ __forceinline__ float4 row4(const float* m, int i) {
  const float4* p = reinterpret_cast<const float4*>(m) + i;
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}

// _uvz and _in_map of a point projected by m, for a pixel in reach: the
// conjunction w_ok & (w > 0) & u, v in [0, 1] & z in (0, 1), evaluated
// term by term and left at the first false one.  Each value it does
// compute takes _uvz's operations (w_ok makes the safe w the w itself), so
// the flag and the (u, v, z) of an in-map pixel are those of the plain
// version; a pixel behind the light costs one projected row.
template <bool kGlobal>
__device__ __forceinline__ bool in_map(const float* m, float x, float y,
                                       float z, Uvz& r) {
  const float pw = project_row(row4<kGlobal>(m, 3), x, y, z);
  if (!(fabsf(pw) >= 1e-8f && pw > 0.0f)) return false;
  r.u = (project_row(row4<kGlobal>(m, 0), x, y, z) / pw) * 0.5f + 0.5f;
  if (!(r.u >= 0.0f && r.u <= 1.0f)) return false;
  r.v = (project_row(row4<kGlobal>(m, 1), x, y, z) / pw) * 0.5f + 0.5f;
  if (!(r.v >= 0.0f && r.v <= 1.0f)) return false;
  r.z = (project_row(row4<kGlobal>(m, 2), x, y, z) / pw) * 0.5f + 0.5f;
  return r.z > 0.0f && r.z < 1.0f;
}

// A pixel of an (H, W, 3) tensor at every scale-th row and column, read in
// place through its element strides.
__device__ __forceinline__ void load3(const float* __restrict__ p, int sy,
                                      int sx, int s3, int y, int x, int scale,
                                      float& a, float& b, float& c) {
  const long long o =
      (long long)(y * scale) * sy + (long long)(x * scale) * sx;
  a = p[o];
  b = p[o + s3];
  c = p[o + 2 * s3];
}

}  // namespace lsr_vis
