// Kernel V1: the crop window and run flag of each local-shadow visibility
// plane.  Per shadowed light k, on the vis_scale-strided pixel grid: its
// footprint (a spot's frustum, _spot_in_map; a point's range sphere,
// _point_in_reach), the footprint's bounds, the first level of the crop
// cascade that holds them, and whether the plane runs at all (non-empty
// footprint, light not culled).
//
// Replaces no pallas_call: lsr_tpu's crop cascade is nested lax.cond,
// lsr_tpu/lighting/local_shadows.py:674-730 (_cropped_plane, with
// _crop_bounds :660, the masks :733 and :830).  lsr_tpu branches on the
// device; here the branch becomes data, a (K, 4) window and a (K,) flag
// that kernel V2 (vis_planes.cu) reads, so a captured frame serves every
// camera.  Plain version: vis_windows_plain in lighting/local_shadows.py,
// equal as integers.
//
// What bounds it on this card: operations and bytes, about even.  It
// reads world positions once at the strided grid (12 bytes a pixel) and
// writes 17 bytes a plane; each (pixel, plane) costs a spot ~40 f32
// operations (four projected rows, three divisions, the compares) or a
// point ~10 (a distance), so ten planes of flagship (a) need ~1.4x the
// bytes' time.
//
// What the design does about it: one thread per (pixel, plane), 32x8
// blocks, world positions read in place at their strides (no strided
// copy); the bounds fold by warp (__reduce_min_sync), then by block in
// shared memory, into one atomicMin per block and value (not one per warp:
// every block of a plane contends for the same four words), the maxima
// stored negated so that all four are minima of one memset sentinel.  A
// second launch of one block picks the level.  The memset and both
// launches sit on the caller's stream, so a captured graph resets its
// scratch on every replay.

#include <cuda_runtime.h>

#include "vis_common.cuh"

namespace {

using lsr_vis::kPoint;
using lsr_vis::kTileH;
using lsr_vis::kTileW;

// The memset byte 0x7F makes every int 0x7F7F7F7F: above any pixel index.
constexpr int kNone = 0x7F7F7F7F;

__global__ void __launch_bounds__(kTileW* kTileH)
vis_footprint_kernel(const float* __restrict__ wp, int sy, int sx, int s3,
                     int h, int w, int scale,
                     const int* __restrict__ info,        // (K, 2) kind, base
                     const float* __restrict__ spot_vp,   // (n_spot, 16)
                     const float* __restrict__ cpos,      // (K, 3)
                     const float* __restrict__ crange,    // (K,)
                     int* __restrict__ bounds) {          // (K, 4)
  const int k = blockIdx.z;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  bool in = false;
  if (x < w && y < h) {
    float px, py, pz;
    lsr_vis::load3(wp, sy, sx, s3, y, x, scale, px, py, pz);
    if (info[2 * k] == kPoint) {
      const float len = lsr_vis::norm3(px - cpos[3 * k], py - cpos[3 * k + 1],
                                       pz - cpos[3 * k + 2]);
      in = len > 1e-4f && len < crange[k];
    } else {
      in = lsr_vis::uvz(spot_vp + 16 * info[2 * k + 1], px, py, pz, true)
               .in_map;
    }
  }
  // Each row of 32 threads is a warp: fold the warp, then the block's
  // eight warps in shared memory, then one atomicMin a value and block.
  __shared__ int part[4][kTileH];
  const int v[4] = {in ? y : kNone, in ? x : kNone, in ? -y : kNone,
                    in ? -x : kNone};
  for (int i = 0; i < 4; ++i) {
    const int m = __reduce_min_sync(0xffffffffu, v[i]);
    if (threadIdx.x == 0) part[i][threadIdx.y] = m;
  }
  __syncthreads();
  if (threadIdx.y == 0 && threadIdx.x < 4) {
    int m = kNone;
    for (int j = 0; j < kTileH; ++j) m = min(m, part[threadIdx.x][j]);
    if (m != kNone) atomicMin(bounds + 4 * k + threadIdx.x, m);
  }
}

// _cropped_plane's choice: the first level (ascending area) that holds the
// bounds, its corner clipped into the grid; the whole grid where none
// does.  An empty footprint has the bounds of _crop_bounds on an empty
// mask, (0, h - 1, 0, w - 1).
__global__ void vis_window_kernel(const int* __restrict__ bounds,
                                  const int* __restrict__ levels,  // (L, 2)
                                  int n_levels, int has_crop,
                                  const unsigned char* __restrict__ enabled,
                                  int h, int w, int n_planes,
                                  int* __restrict__ win,            // (K, 4)
                                  unsigned char* __restrict__ run) {
  for (int k = threadIdx.x; k < n_planes; k += blockDim.x) {
    const bool en = enabled == nullptr || enabled[k] != 0;
    int y0c = 0, x0c = 0, ch = h, cw = w;
    bool go = en;
    if (has_crop) {
      const bool nonempty = bounds[4 * k] != kNone;
      const int y0 = nonempty ? bounds[4 * k] : 0;
      const int x0 = nonempty ? bounds[4 * k + 1] : 0;
      const int y1 = nonempty ? -bounds[4 * k + 2] : h - 1;
      const int x1 = nonempty ? -bounds[4 * k + 3] : w - 1;
      for (int i = 0; i < n_levels; ++i) {
        const int lh = levels[2 * i], lw = levels[2 * i + 1];
        if (y1 - y0 + 1 <= lh && x1 - x0 + 1 <= lw) {
          ch = lh;
          cw = lw;
          y0c = min(y0, h - ch);
          x0c = min(x0, w - cw);
          break;
        }
      }
      go = go && nonempty;
    }
    win[4 * k] = y0c;
    win[4 * k + 1] = x0c;
    win[4 * k + 2] = ch;
    win[4 * k + 3] = cw;
    run[k] = go ? 1 : 0;
  }
}

}  // namespace

extern "C" int lsr_vis_windows(const float* wp, int sy, int sx, int s3, int h,
                               int w, int scale, const int* info,
                               const float* spot_vp, const float* cpos,
                               const float* crange,
                               const unsigned char* enabled,
                               const int* levels, int n_levels, int has_crop,
                               int* bounds, int* win, unsigned char* run,
                               int n_planes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_crop) {
    cudaError_t e = cudaMemsetAsync(bounds, 0x7F,
                                    sizeof(int) * 4 * (size_t)n_planes, s);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    n_planes);
    vis_footprint_kernel<<<grid, dim3(kTileW, kTileH), 0, s>>>(
        wp, sy, sx, s3, h, w, scale, info, spot_vp, cpos, crange, bounds);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  vis_window_kernel<<<1, 32, 0, s>>>(bounds, levels, n_levels, has_crop,
                                     enabled, h, w, n_planes, win, run);
  return (int)cudaGetLastError();
}
