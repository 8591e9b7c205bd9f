// The per-pixel arithmetic shared by kernels V1 (vis_footprint.cu) and V2
// (vis_planes.cu), in the operation order of their plain versions in
// lsr_tpu_torch/lighting/local_shadows.py, so that a kernel built with
// -fmad=false (no contraction of a * b + c) rounds as the torch ops do.

#pragma once

#include <cuda_runtime.h>

namespace lsr_vis {

constexpr int kSpot = 2;   // SHADOW_SPOT_2D
constexpr int kPoint = 3;  // SHADOW_POINT_CUBE
constexpr int kTileW = 32;
constexpr int kTileH = 8;

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
__device__ __forceinline__ float project_row(const float* m, float x, float y,
                                             float z) {
  return ((m[0] * x + m[1] * y) + m[2] * z) + m[3];
}

struct Uvz {
  float u, v, z;
  bool in_map;
};

// _uvz and _in_map of a projected point.
__device__ __forceinline__ Uvz uvz(const float* m, float x, float y, float z,
                                   bool in_reach) {
  const float px = project_row(m, x, y, z);
  const float py = project_row(m + 4, x, y, z);
  const float pz = project_row(m + 8, x, y, z);
  const float pw = project_row(m + 12, x, y, z);
  const bool w_ok = fabsf(pw) >= 1e-8f;
  const float ws = w_ok ? pw : 1.0f;
  Uvz r;
  r.u = (px / ws) * 0.5f + 0.5f;
  r.v = (py / ws) * 0.5f + 0.5f;
  r.z = (pz / ws) * 0.5f + 0.5f;
  r.in_map = w_ok && in_reach && pw > 0.0f && r.u >= 0.0f && r.u <= 1.0f &&
             r.v >= 0.0f && r.v <= 1.0f && r.z > 0.0f && r.z < 1.0f;
  return r;
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
