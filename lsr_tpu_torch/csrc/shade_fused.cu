// Kernel B2: fused sun BRDF + binned local lights.
//
// Replaces lsr_tpu/lighting/shade_kernel.py:_shade_kernel (wrapper
// shade_fused_pallas, pallas_call at shade_kernel.py:510).
//
// What bounds it on this card: arithmetic.  Per (pixel, light) it runs ~60
// f32 operations with two square roots, one or two powf and, for spots, two
// cosf; at 1080p with up to 256 binned lights per 64x128 tile that is far
// above the 13 G-buffer planes (2 MB each) it reads and the 25 MB it writes.
//
// What the design does about it: one thread per pixel; a 32x8 block lies
// inside one 64x128 light tile, so every thread of a block walks the same
// list.  The block stages each chunk of 8 light records (8 x 32 f32 = 1 KB)
// in shared memory, one float per thread, then all threads read each field
// as a shared-memory broadcast.  Light-type branches are uniform across the
// block (same light for every thread), so they cost no divergence, and
// absent types cost nothing.  The walk is min(ceil(count/8), cap/8) chunks,
// as in lsr_tpu (shade_kernel.py:342-346); list slots past the count hold
// zero records and add exactly zero.
//
// Numerics follow lsr_tpu's kernel operation by operation (no fast math;
// rsqrt is 1/sqrt rounded twice, like the CPU reference).

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 64;
constexpr int kTileW = 128;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kChunk = 8;
constexpr int kRec = 32;  // floats per light record
constexpr float kPi = 3.14159265358979f;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979);
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kInnerHi = (float)(1.5707963267948966 - 0.02);
constexpr float kOuterHi = (float)(1.5707963267948966 - 0.005);

__device__ __forceinline__ float rsqrt_rn(float x) {
  return 1.0f / sqrtf(x);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ void unit3(float& a, float& b, float& c) {
  const float il = rsqrt_rn(fmaxf(a * a + b * b + c * c, 1e-16f));
  a = a * il;
  b = b * il;
  c = c * il;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
shade_fused_kernel(const float* __restrict__ gbuf,      // (16, ph, pw)
                   const float* __restrict__ tile_rec,  // (tiles, cap, 32)
                   const int* __restrict__ counts,      // (tiles,)
                   const float* __restrict__ uni,       // (9,)
                   float* __restrict__ out,             // (H, W, 3)
                   int width, int height, int ph, int pw, int tiles_x,
                   int cap, int sun_model, int apow1) {
  __shared__ float lrec[kChunk * kRec];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int lane = threadIdx.y * kBlockX + threadIdx.x;
  const size_t plane = (size_t)ph * pw;
  const size_t o = (size_t)y * pw + x;

  const float px = gbuf[0 * plane + o], py = gbuf[1 * plane + o],
              pz = gbuf[2 * plane + o];
  const float nx = gbuf[3 * plane + o], ny = gbuf[4 * plane + o],
              nz = gbuf[5 * plane + o];
  const bool covered = gbuf[6 * plane + o] > 0.0f;
  const float ar = gbuf[7 * plane + o], ag = gbuf[8 * plane + o],
              ab = gbuf[9 * plane + o];
  const float metal = clampf(gbuf[10 * plane + o], 0.0f, 1.0f);
  const float rough = gbuf[11 * plane + o];
  const float sun_vis = gbuf[12 * plane + o];

  const float cx = uni[0], cy = uni[1], cz = uni[2];
  const float sdx = uni[3], sdy = uni[4], sdz = uni[5];
  const float srr = uni[6], srg = uni[7], srb = uni[8];

  float vx = cx - px, vy = cy - py, vz = cz - pz;
  unit3(vx, vy, vz);

  // --- sun term (L = -sun_dir, unit) ---------------------------------------
  const float lx = -sdx, ly = -sdy, lz = -sdz;
  float hx = lx + vx, hy = ly + vy, hz = lz + vz;
  unit3(hx, hy, hz);
  const float ndl = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
  const float ndh = fmaxf(nx * hx + ny * hy + nz * hz, 0.0f);
  const float ndv = fmaxf(nx * vx + ny * vy + nz * vz, 0.0f);

  float dr, dg, db;
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
  } else {  // pbr_mr: Cook-Torrance GGX
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
  dr = dr * sun_vis;
  dg = dg * sun_vis;
  db = db * sun_vis;

  // --- local lights of this block's tile -----------------------------------
  const int tile = (y / kTileH) * tiles_x + x / kTileW;  // uniform per block
  const int count = counts[tile];
  const int n_chunks = min((count + kChunk - 1) / kChunk, cap / kChunk);
  const float* trec = tile_rec + (size_t)tile * cap * kRec;

  float ldr = 0.0f, ldg = 0.0f, ldb = 0.0f;
  float lsr = 0.0f, lsg = 0.0f, lsb = 0.0f;
  for (int ci = 0; ci < n_chunks; ++ci) {
    __syncthreads();
    lrec[lane] = trec[ci * kChunk * kRec + lane];  // 256 threads, 256 floats
    __syncthreads();
    float cdr = 0.0f, cdg = 0.0f, cdb = 0.0f;
    float csr = 0.0f, csg = 0.0f, csb = 0.0f;
#pragma unroll 1
    for (int li = 0; li < kChunk; ++li) {
      const float* f = lrec + li * kRec;
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
      const float dist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz,
                                     1e-16f));
      const float inv_d = 1.0f / dist;
      const float llx = tlx * inv_d, lly = tly * inv_d, llz = tlz * inv_d;

      float shaping = 1.0f;
      float spec_pw = 36.0f, spec_sc = 0.30f;
      if (is_spot) {
        const float inner = clampf(f[18], 0.02f, kInnerHi);
        const float outer = clampf(fmaxf(inner + 0.005f, f[19]),
                                   inner + 0.005f, kOuterHi);
        const float cos_t = -(llx * fwdx + lly * fwdy + llz * fwdz);
        const float cin = cosf(inner);
        const float cout = cosf(outer);
        const float tt = clampf((cos_t - cout) / fmaxf(cin - cout, 1e-5f),
                                0.0f, 1.0f);
        shaping = cos_t > cout ? tt * tt * (3.0f - 2.0f * tt) : 0.0f;
        spec_pw = 34.0f;
        spec_sc = 0.32f;
      } else if (is_rect) {
        const float facing = fmaxf(-(fwdx * llx + fwdy * lly + fwdz * llz),
                                   0.0f);
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
        fall = fminf(1.0f, (rng * rng) / fmaxf(dist * dist, abias))
               * norm * norm;
      }
      if (!apow1) fall = powf(fmaxf(fall, 1e-9f), fmaxf(f[25], 0.001f));
      if (acut > 0.0f && fall < acut) fall = 0.0f;
      const float atten = (dist < rng ? fall : 0.0f) * fmaxf(shaping, 0.0f);

      const float lndl = fmaxf(nx * llx + ny * lly + nz * llz, 0.0f);
      const bool live = dist > 1e-4f && lndl > 0.0f && atten > 0.0f
                        && covered;
      const float gain = live ? f[16] * atten : 0.0f;
      const float hxl = llx + vx, hyl = lly + vy, hzl = llz + vz;
      const float hll = rsqrt_rn(fmaxf(hxl * hxl + hyl * hyl + hzl * hzl,
                                       1e-16f));
      const float lndh = fmaxf(nx * (hxl * hll) + ny * (hyl * hll)
                               + nz * (hzl * hll), 0.0f);
      const float spec = spec_sc * powf(fmaxf(lndh, 1e-9f), spec_pw);
      const float wd = gain * lndl;
      const float ws = gain * spec;
      const float colr = fmaxf(f[13], 0.0f), colg = fmaxf(f[14], 0.0f),
                  colb = fmaxf(f[15], 0.0f);
      cdr += colr * wd;
      cdg += colg * wd;
      cdb += colb * wd;
      csr += colr * ws;
      csg += colg * ws;
      csb += colb * ws;
    }
    ldr += cdr;
    ldg += cdg;
    ldb += cdb;
    lsr += csr;
    lsg += csg;
    lsb += csb;
  }

  if (x < width && y < height) {
    const float covf = covered ? 1.0f : 0.0f;
    float* po = out + ((size_t)y * width + x) * 3;
    po[0] = (dr + ar * ldr + lsr) * covf;
    po[1] = (dg + ag * ldg + lsg) * covf;
    po[2] = (db + ab * ldb + lsb) * covf;
  }
}

}  // namespace

extern "C" int lsr_shade_fused(const void* gbuf, const void* tile_rec,
                               const void* counts, const void* uni, void* out,
                               int width, int height, int ph, int pw,
                               int tiles_x, int cap, int sun_model, int apow1,
                               void* stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid(pw / kBlockX, ph / kBlockY);
  shade_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)gbuf, (const float*)tile_rec, (const int*)counts,
      (const float*)uni, (float*)out, width, height, ph, pw, tiles_x, cap,
      sun_model, apow1);
  return (int)cudaGetLastError();
}
