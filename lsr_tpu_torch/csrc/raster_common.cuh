// Per-(triangle, pixel) arithmetic shared by the raster kernels B1
// (direct_raster.cu), B3 (tiled_raster.cu) and B4 (chunklist_raster.cu),
// and the exact cull of a triangle against a rectangle of pixels that B3
// and B4 use (block_walk.cuh).
//
// A setup record is lsr_tpu's 16 f32, read as four float4:
//   r0 = A0 B0 C0 A1 | r1 = B1 C1 A2 B2 | r2 = C2 iw0 iw1 iw2 |
//   r3 = ziw0 ziw1 ziw2 id      (id < 0: invalid or padding)
//
// The operations and their order are those of lsr_tpu's kernels
// (lsr_tpu/raster/tiled.py:176-193 and :374-391) and of the plain PyTorch
// versions (raster/brute.py, raster/tiled.py:_tri_depth).  Every kernel is
// built with -fmad=false and spells each product and sum with the
// round-to-nearest intrinsics, so coverage and depth equal the plain
// versions bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace lsr {

constexpr int kRecVec = 4;  // float4 per setup record

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// True when the pixel center (px, py) is inside the triangle, with a
// positive perspective denominator; z01 then holds its depth in [0, 1]:
// view-z mapped by (zn, inv_range) for depth_mode 0, z_ndc * 0.5 + 0.5 for
// depth_mode 1.
__device__ __forceinline__ bool tri_depth(float4 r0, float4 r1, float4 r2,
                                          float4 r3, float px, float py,
                                          int depth_mode, float zn,
                                          float inv_range, float& z01) {
  const float bc0 = __fadd_rn(__fadd_rn(__fmul_rn(r0.x, px),
                                        __fmul_rn(r0.y, py)), r0.z);
  const float bc1 = __fadd_rn(__fadd_rn(__fmul_rn(r0.w, px),
                                        __fmul_rn(r1.x, py)), r1.y);
  const float bc2 = __fadd_rn(__fadd_rn(__fmul_rn(r1.z, px),
                                        __fmul_rn(r1.w, py)), r2.x);
  if (!(bc0 >= 0.0f && bc1 >= 0.0f && bc2 >= 0.0f && r3.w >= 0.0f))
    return false;
  const float denom = __fadd_rn(__fadd_rn(__fmul_rn(bc0, r2.y),
                                          __fmul_rn(bc1, r2.z)),
                                __fmul_rn(bc2, r2.w));
  if (!(denom > 1e-10f)) return false;
  if (depth_mode == 0) {
    const float view_z = __fdiv_rn(1.0f, fmaxf(denom, 1e-10f));
    z01 = clamp01(__fmul_rn(__fsub_rn(view_z, zn), inv_range));
  } else {
    const float zsum = __fadd_rn(__fadd_rn(__fmul_rn(bc0, r3.x),
                                           __fmul_rn(bc1, r3.y)),
                                 __fmul_rn(bc2, r3.z));
    const float zlin = __fdiv_rn(zsum, fmaxf(denom, 1e-10f));
    z01 = clamp01(__fadd_rn(__fmul_rn(zlin, 0.5f), 0.5f));
  }
  return true;
}

// The pixel centers of a rectangle of pixels: px in [x0, x1], py in
// [y0, y1], each bound the very float a pixel of the rectangle uses.
struct Rect {
  float x0, x1, y0, y1;
};

// The largest value one edge function takes over the pixel centers of a
// rectangle, in f32 as tri_depth computes it.  Each step of
// fadd(fadd(fmul(a, px), fmul(b, py)), c) rounds to nearest, and rounding
// is monotone, so the rounded value is non-decreasing in px when a >= 0 and
// non-increasing otherwise (likewise py and b): the maximum is the value at
// the corner picked by the signs of a and b, spelled with the same
// intrinsics.  A NaN (non-finite coefficients, inf - inf) compares false
// with '< 0', so it never rejects.
__device__ __forceinline__ float edge_max(float a, float b, float c,
                                          const Rect& q) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a >= 0.0f ? q.x1 : q.x0),
                             __fmul_rn(b, b >= 0.0f ? q.y1 : q.y0)), c);
}

// True when no pixel center of the rectangle can pass tri_depth's coverage
// test: one edge function is negative at its largest corner, or the id lane
// marks the record invalid.  Exact in f32: it uses no bbox, so the stray
// pixels a sliver's edge functions cover outside its bbox are kept.  Takes
// the ten lanes the test reads: r0, r1, C2 (lane 8) and the id (lane 15).
__device__ __forceinline__ bool rect_reject(float4 r0, float4 r1, float c2,
                                            float id, const Rect& q) {
  return edge_max(r0.x, r0.y, r0.z, q) < 0.0f
         || edge_max(r0.w, r1.x, r1.y, q) < 0.0f
         || edge_max(r1.z, r1.w, c2, q) < 0.0f || id < 0.0f;
}

}  // namespace lsr
