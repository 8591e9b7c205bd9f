// Per-pixel lighting shared by kernels B2 (shade_fused.cu), B5
// (resolve_fused.cu) and B6 (fplus_accumulate.cu): the sun BRDF and one
// binned local light, in lsr_tpu's operation order (its _shade_kernel,
// _resolve_kernel and _fplus_kernel share these formulas, from
// lighting/light_runtime.py).  Built with -fmad=false and no fast math, so
// each function rounds like the plain PyTorch versions beside the kernels.
#pragma once

#include <cuda_runtime.h>

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

// One local light (record f, 32 floats of pack_light_records) at a pixel:
// the diffuse weight wd = gain * N.L and the specular weight ws = gain *
// spec, to be multiplied by the light's clamped color.  Point, spot, rect
// and tube lights; the type branches are uniform across a block that walks
// one list.  apow1 skips the attenuation pow (B2 only, when every power is
// 1); B5 and B6 always apply it, as their TPU kernels do.
__device__ __forceinline__ void local_light(
    const float* f, float px, float py, float pz, float nx, float ny,
    float nz, float vx, float vy, float vz, bool covered, int apow1,
    float& wd, float& ws) {
  const float ltype = f[0];
  const float posx = f[1], posy = f[2], posz = f[3];
  const bool is_spot = ltype == 2.0f;
  const bool is_rect = ltype == 3.0f;
  const bool is_tube = ltype == 4.0f;
  float fwdx = f[4], fwdy = f[5], fwdz = f[6];
  unit3(fwdx, fwdy, fwdz);
  const float rng = fmaxf(f[17], 0.001f);
  const float amodel = f[24];
  const float abias = fmaxf(f[26], 1e-5f);
  const float acut = f[27];

  float emx = posx, emy = posy, emz = posz;
  if (is_rect) {
    float upx = f[7], upy = f[8], upz = f[9];
    unit3(upx, upy, upz);
    const float hex = fmaxf(f[20], 0.05f), hey = fmaxf(f[21], 0.05f);
    const float dxp = px - posx, dyp = py - posy, dzp = pz - posz;
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
    const float ux = clampf(dxp * rx + dyp * ry + dzp * rz, -hex, hex);
    const float uy = clampf(dxp * u2x + dyp * u2y + dzp * u2z, -hey, hey);
    emx = posx + rx * ux + u2x * uy;
    emy = posy + ry * ux + u2y * uy;
    emz = posz + rz * ux + u2z * uy;
  } else if (is_tube) {
    float axx = f[10], axy = f[11], axz = f[12];
    unit3(axx, axy, axz);
    const float thl = fmaxf(f[22], 0.1f);
    const float ax2 = axx * (2.0f * thl), ay2 = axy * (2.0f * thl),
                az2 = axz * (2.0f * thl);
    const float a0x = posx - axx * thl, a0y = posy - axy * thl,
                a0z = posz - axz * thl;
    const float denom_seg = fmaxf(ax2 * ax2 + ay2 * ay2 + az2 * az2, 1e-8f);
    const float tseg = clampf(((px - a0x) * ax2 + (py - a0y) * ay2
                               + (pz - a0z) * az2) / denom_seg,
                              0.0f, 1.0f);
    emx = a0x + ax2 * tseg;
    emy = a0y + ay2 * tseg;
    emz = a0z + az2 * tseg;
  }

  const float tlx = emx - px, tly = emy - py, tlz = emz - pz;
  const float dist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-16f));
  const float inv_d = 1.0f / dist;
  const float llx = tlx * inv_d, lly = tly * inv_d, llz = tlz * inv_d;

  float shaping = 1.0f;
  float spec_pw = 36.0f, spec_sc = 0.30f;
  if (is_spot) {
    const float inner = clampf(f[18], 0.02f, kInnerHi);
    const float outer = clampf(fmaxf(inner + 0.005f, f[19]), inner + 0.005f,
                               kOuterHi);
    const float cos_t = -(llx * fwdx + lly * fwdy + llz * fwdz);
    const float cin = cosf(inner);
    const float cout = cosf(outer);
    const float tt = clampf((cos_t - cout) / fmaxf(cin - cout, 1e-5f), 0.0f,
                            1.0f);
    shaping = cos_t > cout ? tt * tt * (3.0f - 2.0f * tt) : 0.0f;
    spec_pw = 34.0f;
    spec_sc = 0.32f;
  } else if (is_rect) {
    const float facing = fmaxf(-(fwdx * llx + fwdy * lly + fwdz * llz), 0.0f);
    shaping = facing > 0.0f ? 0.65f + 0.55f * facing : 0.0f;
    spec_pw = 26.0f;
    spec_sc = 0.26f;
  } else if (is_tube) {
    const float soft = clampf(1.0f - dist / rng, 0.0f, 1.0f);
    shaping = 0.75f + 0.35f * soft;
    spec_pw = 22.0f;
    spec_sc = 0.20f;
  }

  const float norm = clampf(1.0f - dist / rng, 0.0f, 1.0f);
  float fall;
  if (amodel == 0.0f) {
    fall = norm;
  } else if (amodel == 1.0f) {
    fall = norm * norm * (3.0f - 2.0f * norm);
  } else {
    fall = fminf(1.0f, (rng * rng) / fmaxf(dist * dist, abias)) * norm * norm;
  }
  if (!apow1) fall = powf(fmaxf(fall, 1e-9f), fmaxf(f[25], 0.001f));
  if (acut > 0.0f && fall < acut) fall = 0.0f;
  const float atten = (dist < rng ? fall : 0.0f) * fmaxf(shaping, 0.0f);

  const float lndl = fmaxf(nx * llx + ny * lly + nz * llz, 0.0f);
  const bool live = dist > 1e-4f && lndl > 0.0f && atten > 0.0f && covered;
  const float gain = live ? f[16] * atten : 0.0f;
  const float hxl = llx + vx, hyl = lly + vy, hzl = llz + vz;
  const float hll = rsqrt_rn(fmaxf(hxl * hxl + hyl * hyl + hzl * hzl, 1e-16f));
  const float lndh = fmaxf(nx * (hxl * hll) + ny * (hyl * hll)
                           + nz * (hzl * hll), 0.0f);
  const float spec = spec_sc * powf(fmaxf(lndh, 1e-9f), spec_pw);
  wd = gain * lndl;
  ws = gain * spec;
}

// Stage rows [0, n) of a light chunk (n * kRec floats) into shared memory,
// every thread of the block copying a strided share.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int n_floats, int lane,
                                            int n_threads) {
  for (int i = lane; i < n_floats; i += n_threads) dst[i] = src[i];
}

}  // namespace lsr
