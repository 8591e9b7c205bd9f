// Kernel V2: the local-shadow visibility planes, (K + 1, H', W') on the
// vis_scale-strided pixel grid, each evaluated inside the window kernel V1
// (vis_footprint.cu) chose for it and 1.0 elsewhere; 1.0 everywhere for a
// plane whose run flag is false (empty footprint, light culled) and for
// plane K, the constant plane of unshadowed lights.
//
// Replaces no pallas_call: lsr_tpu evaluates the planes with XLA gathers
// inside its lax.cond crop cascade, lsr_tpu/lighting/local_shadows.py:674
// (_cropped_plane; the planes _spot_plane_one :749, _point_plane_one :838,
// the sampling _uvz_to_texel / _esm_vis / _pcf_from_rows).  Plain version:
// vis_planes_plain in lighting/local_shadows.py, which this kernel equals
// bit for bit: the same operations in the same order, built with
// -fmad=false; the PCF box's mean multiplies by the f32 reciprocal of its
// tap count, as PyTorch's CUDA division by a scalar does.
//
// Per pixel: the slope-scaled bias from N.L to the light; a spot projects
// by its slot's view-projection, a point picks its cube face by the major
// axis of the light-to-pixel vector and projects by that face's own
// view-projection (in reach: inside the range sphere); outside the map the
// plane is 1.0.  ESM fetches one q16 texel of the prefiltered soft map and
// compares it with the linearised depth (clamp(exp(c (soft - z)), 0, 1));
// PCF counts the (2r+1)^2 box of q16 depth tests on clamped texels.  Then
// 1 + (lit - 1) * strength.
//
// What bounds it on this card: bytes.  World positions and normals are
// read once at the strided grid (24 bytes a pixel), the planes written
// once (4 bytes a pixel and plane), the q16 tables touched where the
// windows' pixels sample them; the operations (~60 a pixel and plane, 25
// compares under PCF) are far below.
//
// What the design does about it: one thread per (pixel, plane), 32x8
// blocks, the plane on blockIdx.z, so that a block is uniform in its
// plane: a block outside its plane's window, or of a plane that does not
// run, writes 1.0 and reads nothing.  World positions and normals are read
// in place at their strides, the tables through the read-only path; a
// simple kernel first, tuned later.

#include <cuda_runtime.h>

#include "vis_common.cuh"

namespace {

using lsr_vis::clamp;
using lsr_vis::clamp_min;
using lsr_vis::clampi;
using lsr_vis::kPoint;
using lsr_vis::kTileH;
using lsr_vis::kTileW;

// Uniforms, device floats: bias_const, bias_slope, esm_c, near, far_min,
// 1 / 65535, 1 / (2r + 1)^2 (all f32 values made on the host).
enum { kBiasConst, kBiasSlope, kEsmC, kNear, kFarMin, kInvQ16, kInvBox };

struct Tables {
  const int* info;        // (K, 2) kind, base slot
  const float* spot_vp;   // (n_spot, 16)
  const float* point_vp;  // (n_point * 6, 16)
  const float* cpos;      // (K, 3)
  const float* crange;    // (K,)
  const float* strength;  // (K,)
  const int* spot_taps;   // (n_spot, S1, S1) q16
  const int* point_taps;  // (n_point * 6, S2, S2) q16
  int spot_size, point_size;
};

__device__ float plane_value(const Tables& t, const float* __restrict__ uni,
                             int k, int esm, int radius, float x, float y,
                             float z, float nx, float ny, float nz) {
  const int kind = t.info[2 * k], base = t.info[2 * k + 1];
  // _bias_ndl
  const float rx = x - t.cpos[3 * k], ry = y - t.cpos[3 * k + 1],
              rz = z - t.cpos[3 * k + 2];
  const float len = lsr_vis::norm3(rx, ry, rz);
  const float d = clamp_min(len, 1e-8f);
  const float lx = -rx / d, ly = -ry / d, lz = -rz / d;
  const float ndl = clamp_min((nx * lx + ny * ly) + nz * lz, 0.0f);
  const float bias =
      uni[kBiasConst] + uni[kBiasSlope] * (1.0f - clamp(ndl, 0.0f, 1.0f));

  int slot = base, size = t.spot_size;
  const float* m = t.spot_vp + 16 * base;
  const int* taps = t.spot_taps;
  bool in_reach = true;
  if (kind == kPoint) {
    const float ax = fabsf(rx), ay = fabsf(ry), az = fabsf(rz);
    const int face = (ax >= ay && ax >= az) ? (rx >= 0.0f ? 0 : 1)
                     : (ay >= az)           ? (ry >= 0.0f ? 2 : 3)
                                            : (rz >= 0.0f ? 4 : 5);
    slot = base + face;
    m = t.point_vp + 16 * slot;
    size = t.point_size;
    taps = t.point_taps;
    in_reach = len > 1e-4f && len < t.crange[k];
  }
  const lsr_vis::Uvz p = lsr_vis::uvz(m, x, y, z, in_reach);
  if (!p.in_map) return 1.0f;
  const float top = (float)(size - 1);
  const int cx = (int)clamp(rintf(p.u * top), 0.0f, top);
  const int cy = (int)clamp(rintf(p.v * top), 0.0f, top);
  const int* tab = taps + (long long)slot * size * size;
  float lit;
  if (esm) {
    const float soft = (float)__ldg(tab + cy * size + cx) * uni[kInvQ16];
    const float far = clamp_min(t.crange[k], uni[kFarMin]);
    const float near = uni[kNear];
    const float z_lin = (near * p.z) / (far - p.z * (far - near));
    lit = clamp(expf((soft - (z_lin - bias)) * uni[kEsmC]), 0.0f, 1.0f);
  } else {
    const int q = (int)clamp(rintf((p.z - bias) * 65535.0f), 0.0f, 65535.0f);
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
  return 1.0f + (lit - 1.0f) * clamp(t.strength[k], 0.0f, 1.0f);
}

__global__ void __launch_bounds__(kTileW* kTileH)
vis_planes_kernel(const float* __restrict__ wp, int wsy, int wsx, int ws3,
                  const float* __restrict__ nm, int nsy, int nsx, int ns3,
                  int h, int w, int scale, Tables t,
                  const int* __restrict__ win,           // (K, 4)
                  const unsigned char* __restrict__ run,  // (K,)
                  const float* __restrict__ uni, float* __restrict__ out,
                  int n_planes, int esm, int radius) {
  const int k = blockIdx.z;
  const int bx = blockIdx.x * kTileW, by = blockIdx.y * kTileH;
  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  bool live = false;
  if (k < n_planes && run[k]) {
    const int y0 = win[4 * k], x0 = win[4 * k + 1];
    const int y1 = y0 + win[4 * k + 2], x1 = x0 + win[4 * k + 3];
    // The block-uniform test first: a block off the window reads nothing.
    if (by < y1 && by + kTileH > y0 && bx < x1 && bx + kTileW > x0)
      live = y >= y0 && y < y1 && x >= x0 && x < x1;
  }
  if (x >= w || y >= h) return;
  float v = 1.0f;
  if (live) {
    float px, py, pz, qx, qy, qz;
    lsr_vis::load3(wp, wsy, wsx, ws3, y, x, scale, px, py, pz);
    lsr_vis::load3(nm, nsy, nsx, ns3, y, x, scale, qx, qy, qz);
    v = plane_value(t, uni, k, esm, radius, px, py, pz, qx, qy, qz);
  }
  out[((long long)k * h + y) * w + x] = v;
}

}  // namespace

extern "C" int lsr_vis_planes(
    const float* wp, int wsy, int wsx, int ws3, const float* nm, int nsy,
    int nsx, int ns3, int h, int w, int scale, const int* info,
    const float* spot_vp, const float* point_vp, const float* cpos,
    const float* crange, const float* strength, const int* spot_taps,
    const int* point_taps, int spot_size, int point_size, const int* win,
    const unsigned char* run, const float* uni, float* out, int n_planes,
    int esm, int radius, void* stream) {
  const Tables t{info,     spot_vp,    point_vp,  cpos,      crange,
                 strength, spot_taps,  point_taps, spot_size, point_size};
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  n_planes + 1);
  vis_planes_kernel<<<grid, dim3(kTileW, kTileH), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      wp, wsy, wsx, ws3, nm, nsy, nsx, ns3, h, w, scale, t, win, run, uni,
      out, n_planes, esm, radius);
  return (int)cudaGetLastError();
}
