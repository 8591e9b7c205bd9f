// Per-pixel lighting shared by kernels B2 (shade_fused.cu), B5
// (resolve_fused.cu) and B6 (fplus_accumulate.cu): the sun BRDF and one
// binned local light, in lsr_tpu's operation order (its _shade_kernel,
// _resolve_kernel and _fplus_kernel share these formulas, from
// lighting/light_runtime.py).  Built with -fmad=false and no fast math, so
// each function rounds like the plain PyTorch versions beside the kernels.
//
// What bounds the light loop on this card is the operations it executes,
// and most were spent where they bought nothing: on work that belongs to
// the light, not to the pixel, and on pairs whose gain is 0.  So one light
// at one pixel is three steps:
//   light_prepare  record -> Light: everything that does not depend on the
//                  pixel (unit axis, cone cosines, rect frame, tube
//                  segment, clamps);
//   light_reach    Light x pixel -> distance, direction, N.L, cone cosine,
//                  and whether the light can add anything at the pixel;
//   light_shade    the attenuation, the half vector and the specular pow.
// B2, B5 and B6 run light_prepare once per light (one thread a light,
// into shared memory) and let a warp skip light_shade when light_reach says
// no for all of its pixels: the light walk of light_walk.cuh.
//
// The three steps take the light's kind as a template parameter: 0 reads it
// from the record at run time (what the kernels ship: a staged group holds
// lights of any kind), 2, 3, 4 and 1 (spot, rect, tube, point) fix it when
// the code is compiled, so that a copy carries no other kind's fields or
// branches.  Before the walk, when every pixel prepared every light, four
// copies made B2 0.547 -> 0.482 ms and B6 1.114 -> 1.012 ms on an NVIDIA
// H100 80GB HBM3 at 700 W; on the walk B5 gave 0.370 against 0.378 ms and
// B2's measurement is in shade_fused.cu's header.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace lsr {

constexpr int kRec = 32;  // floats per packed light record
constexpr float kPi = 3.14159265358979f;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979);
constexpr float kInnerHi = (float)(1.5707963267948966 - 0.02);
constexpr float kOuterHi = (float)(1.5707963267948966 - 0.005);

// 1/sqrt rounded twice, like the CPU reference (rsqrtf is approximate).
__device__ __forceinline__ float rsqrt_rn(float x) { return 1.0f / sqrtf(x); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ void unit3(float& a, float& b, float& c) {
  const float il = rsqrt_rn(fmaxf(a * a + b * b + c * c, 1e-16f));
  a = a * il;
  b = b * il;
  c = c * il;
}

// Sun BRDF (not yet times visibility): sun_model 0 = pbr_mr (Cook-Torrance
// GGX), 1 = blinn_phong.  (lx, ly, lz) = -sun_dir (unit), (vx, vy, vz) the
// unit view vector, (srr, srg, srb) the sun radiance.
__device__ __forceinline__ void sun_term(
    int sun_model, float nx, float ny, float nz, float vx, float vy, float vz,
    float lx, float ly, float lz, float ar, float ag, float ab, float metal,
    float rough, float srr, float srg, float srb, float& dr, float& dg,
    float& db) {
  float hx = lx + vx, hy = ly + vy, hz = lz + vz;
  unit3(hx, hy, hz);
  const float ndl = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
  const float ndh = fmaxf(nx * hx + ny * hy + nz * hz, 0.0f);
  const float ndv = fmaxf(nx * vx + ny * vy + nz * vz, 0.0f);
  if (sun_model == 1) {  // blinn_phong
    const float rough_c = clampf(rough, 0.0f, 1.0f);
    const float spec_pow = fmaxf(8.0f + (1.0f - rough_c) * 120.0f, 4.0f);
    const float spec_norm = (spec_pow + 2.0f) / kTwoPi;
    const float spec_f0 = 0.04f + 0.96f * metal;
    const float spec = powf(fmaxf(ndh, 1e-9f), spec_pow) * spec_norm
                       * spec_f0 * ndl;
    const float base = (1.0f - metal) * (ndl / kPi);
    dr = (base * ar + spec) * srr;
    dg = (base * ag + spec) * srg;
    db = (base * ab + spec) * srb;
    return;
  }
  const float rough_c = clampf(rough, 0.04f, 1.0f);
  const float a = rough_c * rough_c;
  const float a2 = a * a;
  const float dden = ndh * ndh * (a2 - 1.0f) + 1.0f;
  const float d = a2 / (kPi * dden * dden + 1e-7f);
  const float k = (a + 1.0f) * (a + 1.0f) * 0.125f;
  const float g1v = ndv / (ndv * (1.0f - k) + k + 1e-7f);
  const float g1l = ndl / (ndl * (1.0f - k) + k + 1e-7f);
  const float g = g1v * g1l;
  const float vdh = fmaxf(vx * hx + vy * hy + vz * hz, 0.0f);
  const float fres = powf(1.0f - vdh, 5.0f);
  const float denom_s = fmaxf(4.0f * ndl * ndv, 1e-6f);
  const float lit = (ndl > 0.0f && ndv > 0.0f) ? 1.0f : 0.0f;
  const float alb[3] = {ar, ag, ab};
  const float rad[3] = {srr, srg, srb};
  float res[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f0 = 0.04f + (alb[c] - 0.04f) * metal;
    const float fc = f0 + (1.0f - f0) * fres;
    const float sc = d * g * fc / denom_s;
    const float kd = (1.0f - fc) * (1.0f - metal);
    res[c] = (kd * alb[c] * kInvPi + sc) * rad[c] * ndl * lit;
  }
  dr = res[0];
  dg = res[1];
  db = res[2];
}

// A light as the per-pixel math reads it: what light_prepare derives from a
// packed record (32 floats of pack_light_records) without looking at a
// pixel.  Staged in shared memory, every field is read as a broadcast.
struct Light {
  float ltype;             // 2 spot, 3 rect, 4 tube, anything else a point
  float posx, posy, posz;
  float fwdx, fwdy, fwdz;  // unit forward
  float rng, rng2;         // clamped range, rng * rng
  float amodel, apow, abias, acut;
  float intensity;
  float colr, colg, colb;  // clamped color
  float spec_pw, spec_sc;
  float cout, cden;        // spot: cos(outer), max(cos(inner) - cos(outer))
  float zero_ok;           // 1: color * 0 is +0 (no infinite channel)
  float sidx;              // local-shadow plane (record lane 28)
  // rect: right (ax, ay, az), up (bx, by, bz), half extents (ex, ey);
  // tube: segment start (ax..), segment (bx..), its squared length (ex).
  float ax, ay, az, bx, by, bz, ex, ey;
};

// Everything of a light that does not depend on the pixel, in the
// operations and the order the per-pixel code used when it did this work
// itself, so every field is the float it was: only who computes it changes.
// A zero record (a list slot past the count) gives a point light of range
// 0.001 at the origin with no color.
// Whether a light of type ltype is of kind k (2 spot, 3 rect, 4 tube), known
// when the code is compiled unless KIND is 0.
template <int KIND>
__device__ __forceinline__ bool is_kind(float ltype, int k) {
  return KIND ? KIND == k : ltype == (float)k;
}

template <int KIND = 0>
__device__ __forceinline__ Light light_prepare(const float* f) {
  Light L;
  L.ltype = f[0];
  L.posx = f[1];
  L.posy = f[2];
  L.posz = f[3];
  float fwdx = f[4], fwdy = f[5], fwdz = f[6];
  unit3(fwdx, fwdy, fwdz);
  L.fwdx = fwdx;
  L.fwdy = fwdy;
  L.fwdz = fwdz;
  L.rng = fmaxf(f[17], 0.001f);
  L.rng2 = L.rng * L.rng;
  L.amodel = f[24];
  L.apow = fmaxf(f[25], 0.001f);
  L.abias = fmaxf(f[26], 1e-5f);
  L.acut = f[27];
  L.sidx = f[28];
  L.intensity = f[16];
  L.colr = fmaxf(f[13], 0.0f);
  L.colg = fmaxf(f[14], 0.0f);
  L.colb = fmaxf(f[15], 0.0f);
  L.zero_ok = (L.colr < CUDART_INF_F && L.colg < CUDART_INF_F
               && L.colb < CUDART_INF_F) ? 1.0f : 0.0f;
  L.spec_pw = 36.0f;
  L.spec_sc = 0.30f;
  L.cout = 0.0f;
  L.cden = 0.0f;
  L.ax = L.ay = L.az = L.bx = L.by = L.bz = L.ex = L.ey = 0.0f;
  if (is_kind<KIND>(L.ltype, 2)) {
    const float inner = clampf(f[18], 0.02f, kInnerHi);
    const float outer = clampf(fmaxf(inner + 0.005f, f[19]), inner + 0.005f,
                               kOuterHi);
    const float cin = cosf(inner);
    L.cout = cosf(outer);
    L.cden = fmaxf(cin - L.cout, 1e-5f);
    L.spec_pw = 34.0f;
    L.spec_sc = 0.32f;
  } else if (is_kind<KIND>(L.ltype, 3)) {
    float upx = f[7], upy = f[8], upz = f[9];
    unit3(upx, upy, upz);
    L.ex = fmaxf(f[20], 0.05f);
    L.ey = fmaxf(f[21], 0.05f);
    float rx0 = upy * fwdz - upz * fwdy;
    float ry0 = upz * fwdx - upx * fwdz;
    float rz0 = upx * fwdy - upy * fwdx;
    unit3(rx0, ry0, rz0);
    float u2x = fwdy * rz0 - fwdz * ry0;
    float u2y = fwdz * rx0 - fwdx * rz0;
    float u2z = fwdx * ry0 - fwdy * rx0;
    unit3(u2x, u2y, u2z);
    float rx = u2y * fwdz - u2z * fwdy;
    float ry = u2z * fwdx - u2x * fwdz;
    float rz = u2x * fwdy - u2y * fwdx;
    unit3(rx, ry, rz);
    L.ax = rx;
    L.ay = ry;
    L.az = rz;
    L.bx = u2x;
    L.by = u2y;
    L.bz = u2z;
    L.spec_pw = 26.0f;
    L.spec_sc = 0.26f;
  } else if (is_kind<KIND>(L.ltype, 4)) {
    float axx = f[10], axy = f[11], axz = f[12];
    unit3(axx, axy, axz);
    const float thl = fmaxf(f[22], 0.1f);
    L.bx = axx * (2.0f * thl);
    L.by = axy * (2.0f * thl);
    L.bz = axz * (2.0f * thl);
    L.ax = L.posx - axx * thl;
    L.ay = L.posy - axy * thl;
    L.az = L.posz - axz * thl;
    L.ex = fmaxf(L.bx * L.bx + L.by * L.by + L.bz * L.bz, 1e-8f);
    L.spec_pw = 22.0f;
    L.spec_sc = 0.20f;
  }
  return L;
}

// The first half of one light at one pixel: the emitter point, the distance
// and the unit direction to it, N.L and, for spots and rects, the cosine
// against the light's forward axis.
struct Reach {
  float dist, llx, lly, llz, lndl, cfwd;
};

// Fills r and returns whether the light can add anything at this pixel.
// False implies gain == 0 in light_shade, whatever the rest computes: the
// pixel is uncovered or at the emitter (live is false), out of range
// (atten is 0 * shaping: 0 or NaN, never > 0), faces away (lndl is 0) or
// lies outside a spot's cone or behind a rect (shaping is 0).  A NaN in any
// of these compares false here exactly where it makes live false there.
template <int KIND = 0>
__device__ __forceinline__ bool light_reach(const Light& L, float px, float py,
                                            float pz, float nx, float ny,
                                            float nz, bool covered, Reach& r) {
  const bool is_spot = is_kind<KIND>(L.ltype, 2);
  const bool is_rect = is_kind<KIND>(L.ltype, 3);
  const bool is_tube = is_kind<KIND>(L.ltype, 4);
  float emx = L.posx, emy = L.posy, emz = L.posz;
  if (is_rect) {
    const float dxp = px - L.posx, dyp = py - L.posy, dzp = pz - L.posz;
    const float ux = clampf(dxp * L.ax + dyp * L.ay + dzp * L.az, -L.ex, L.ex);
    const float uy = clampf(dxp * L.bx + dyp * L.by + dzp * L.bz, -L.ey, L.ey);
    emx = L.posx + L.ax * ux + L.bx * uy;
    emy = L.posy + L.ay * ux + L.by * uy;
    emz = L.posz + L.az * ux + L.bz * uy;
  } else if (is_tube) {
    const float tseg = clampf(((px - L.ax) * L.bx + (py - L.ay) * L.by
                               + (pz - L.az) * L.bz) / L.ex,
                              0.0f, 1.0f);
    emx = L.ax + L.bx * tseg;
    emy = L.ay + L.by * tseg;
    emz = L.az + L.bz * tseg;
  }
  const float tlx = emx - px, tly = emy - py, tlz = emz - pz;
  r.dist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-16f));
  const float inv_d = 1.0f / r.dist;
  r.llx = tlx * inv_d;
  r.lly = tly * inv_d;
  r.llz = tlz * inv_d;
  r.lndl = fmaxf(nx * r.llx + ny * r.lly + nz * r.llz, 0.0f);
  r.cfwd = 0.0f;
  bool shaped = true;
  if (is_spot) {
    r.cfwd = -(r.llx * L.fwdx + r.lly * L.fwdy + r.llz * L.fwdz);
    shaped = r.cfwd > L.cout;
  } else if (is_rect) {
    r.cfwd = -(L.fwdx * r.llx + L.fwdy * r.lly + L.fwdz * r.llz);
    shaped = fmaxf(r.cfwd, 0.0f) > 0.0f;
  }
  return covered && r.dist > 1e-4f && r.dist < L.rng && r.lndl > 0.0f
         && shaped;
}

// The second half: the diffuse weight wd = gain * N.L and the specular
// weight ws = gain * spec, to be multiplied by the light's clamped color.
// apow1 skips the attenuation pow (B2 only, when every power is 1); B5 and
// B6 always apply it, as their TPU kernels do.  vis is the light's
// local-shadow visibility at the pixel (B2a, B5a), which multiplies the
// gain; 1 for an unshadowed light, and gain * 1 is gain.
template <int KIND = 0>
__device__ __forceinline__ void light_shade(const Light& L, const Reach& r,
                                            float nx, float ny, float nz,
                                            float vx, float vy, float vz,
                                            bool covered, int apow1,
                                            float& wd, float& ws,
                                            float vis = 1.0f) {
  const float dist = r.dist, rng = L.rng;
  float shaping = 1.0f;
  if (is_kind<KIND>(L.ltype, 2)) {
    const float tt = clampf((r.cfwd - L.cout) / L.cden, 0.0f, 1.0f);
    shaping = r.cfwd > L.cout ? tt * tt * (3.0f - 2.0f * tt) : 0.0f;
  } else if (is_kind<KIND>(L.ltype, 3)) {
    const float facing = fmaxf(r.cfwd, 0.0f);
    shaping = facing > 0.0f ? 0.65f + 0.55f * facing : 0.0f;
  } else if (is_kind<KIND>(L.ltype, 4)) {
    const float soft = clampf(1.0f - dist / rng, 0.0f, 1.0f);
    shaping = 0.75f + 0.35f * soft;
  }

  const float norm = clampf(1.0f - dist / rng, 0.0f, 1.0f);
  float fall;
  if (L.amodel == 0.0f) {
    fall = norm;
  } else if (L.amodel == 1.0f) {
    fall = norm * norm * (3.0f - 2.0f * norm);
  } else {
    fall = fminf(1.0f, L.rng2 / fmaxf(dist * dist, L.abias)) * norm * norm;
  }
  if (!apow1) fall = powf(fmaxf(fall, 1e-9f), L.apow);
  if (L.acut > 0.0f && fall < L.acut) fall = 0.0f;
  const float atten = (dist < rng ? fall : 0.0f) * fmaxf(shaping, 0.0f);

  const bool live = dist > 1e-4f && r.lndl > 0.0f && atten > 0.0f && covered;
  const float gain = (live ? L.intensity * atten : 0.0f) * vis;
  const float hxl = r.llx + vx, hyl = r.lly + vy, hzl = r.llz + vz;
  const float hll = rsqrt_rn(fmaxf(hxl * hxl + hyl * hyl + hzl * hzl, 1e-16f));
  const float lndh = fmaxf(nx * (hxl * hll) + ny * (hyl * hll)
                           + nz * (hzl * hll), 0.0f);
  const float spec = L.spec_sc * powf(fmaxf(lndh, 1e-9f), L.spec_pw);
  wd = gain * r.lndl;
  ws = gain * spec;
}

}  // namespace lsr
