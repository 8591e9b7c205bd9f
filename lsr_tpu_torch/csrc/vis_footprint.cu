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
// What bounds it on this card: bytes.  It reads world positions once at
// the strided grid (12 bytes a pixel) and writes 17 bytes a plane.  A
// (pixel, plane) costs a spot at most ~42 f32 operations (four projected
// rows, three divisions, the compares) and a point ~11 (a distance), but
// the spot test stops at its first false term, so on flagship (a)'s data
// the operations take less time than the bytes (chip_smoke._v1_ops).
//
// What the design does about it: one launch over all planes.  A thread
// owns a strided pixel and loops over the K planes, so the world position
// is read once; the planes' view-projections, centres, ranges and kinds
// sit in shared memory, staged once a block.  The spot test stops at its
// first false term (vis_common.cuh in_map: a pixel behind the light costs
// one projected row and no division).  A warp covers 32 neighbouring
// pixels of one row, so a plane's ballot gives the warp's row and its
// first and last column at once: lane 0 folds them into the warp's minima
// in shared memory (maxima stored negated, so that all four are minima of
// one sentinel), with no reduction and no atomic.  The grid is persistent
// (the caller's blocks an SM, lighting/vis_kernel.V1_BLOCKS_PER_SM: 8,
// 1.33 waves of the 6 resident at 40 registers, which evens out the
// blocks' uneven work better than one wave), each block walking a
// contiguous run of warp rows; at its end a block folds its warps per
// plane and makes one global atomicMin a (block, plane, value) where the
// plane was seen.  The last block to finish (a ticket counter behind
// __threadfence) picks the levels.  A call is one memset of the scratch
// (bounds and ticket) and one launch, both on the caller's stream, so a
// captured graph resets its scratch on every replay.  Of the
// costs suspected in the first V1 (one thread a (pixel, plane), a launch
// a plane on blockIdx.z), its divisions cost it 8%, its f64 distance and
// its atomics under 1% (each patched out of a copy of the source and
// timed on an NVIDIA H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>

#include "vis_common.cuh"

namespace {

using lsr_vis::kPoint;
using lsr_vis::kThreads;
using lsr_vis::kWarps;

// The memset byte 0x7F makes every int 0x7F7F7F7F: above any pixel index.
// The ticket counter starts there too and counts blocks up from it.
constexpr int kNone = 0x7F7F7F7F;
constexpr int kTab = 20;  // a plane's staged floats: view-proj, centre, range

__global__ void __launch_bounds__(kThreads)
vis_footprint_kernel(const float* __restrict__ wp, int sy, int sx, int s3,
                     int h, int w, int scale,
                     const int* __restrict__ info,        // (K, 2) kind, base
                     const float* __restrict__ spot_vp,   // (n_spot, 16)
                     const float* __restrict__ cpos,      // (K, 3)
                     const float* __restrict__ crange,    // (K,)
                     const unsigned char* __restrict__ enabled,
                     const int* __restrict__ levels,      // (L, 2)
                     int n_levels, int has_crop, int n_planes,
                     int* __restrict__ bounds,            // (K, 4), ticket
                     int* __restrict__ win,               // (K, 4)
                     unsigned char* __restrict__ run) {
  extern __shared__ float4 smem[];
  float* tab = reinterpret_cast<float*>(smem);         // (K, kTab)
  int* kind = reinterpret_cast<int*>(tab + kTab * n_planes);
  int* part = kind + n_planes;                         // (kWarps, K, 4)
  __shared__ bool last;
  const int tid = threadIdx.x;
  if (has_crop) {
    for (int k = tid; k < n_planes; k += kThreads) {
      const int kd = info[2 * k];
      kind[k] = kd;
      float* t = tab + kTab * k;
      if (kd != kPoint) {
        const float* m = spot_vp + 16 * info[2 * k + 1];
        for (int i = 0; i < 16; ++i) t[i] = m[i];
      }
      t[16] = cpos[3 * k];
      t[17] = cpos[3 * k + 1];
      t[18] = cpos[3 * k + 2];
      t[19] = crange[k];
    }
    for (int i = tid; i < kWarps * 4 * n_planes; i += kThreads)
      part[i] = kNone;
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    int* mine = part + warp * 4 * n_planes;
    const int segs_x = (w + 31) / 32;
    const long long n_seg = (long long)h * segs_x;
    const long long per = (n_seg + gridDim.x - 1) / gridDim.x;
    const long long s0 = blockIdx.x * per;
    const long long s1 = min(n_seg, s0 + per);
    for (long long s = s0 + warp; s < s1; s += kWarps) {
      const int y = (int)(s / segs_x);
      const int x0 = (int)(s % segs_x) * 32;
      const int x = x0 + lane;
      float px = 0.0f, py = 0.0f, pz = 0.0f;
      if (x < w) lsr_vis::load3(wp, sy, sx, s3, y, x, scale, px, py, pz);
      for (int k = 0; k < n_planes; ++k) {
        const float* t = tab + kTab * k;
        bool in = false;
        if (x < w) {
          if (kind[k] == kPoint) {
            const float len =
                lsr_vis::norm3(px - t[16], py - t[17], pz - t[18]);
            in = len > 1e-4f && len < t[19];
          } else {
            lsr_vis::Uvz r;
            in = lsr_vis::in_map<false>(t, px, py, pz, r);
          }
        }
        const unsigned b = __ballot_sync(0xffffffffu, in);
        if (b != 0u && lane == 0) {
          int* m = mine + 4 * k;
          m[0] = min(m[0], y);
          m[1] = min(m[1], x0 + __ffs(b) - 1);
          m[2] = min(m[2], -y);
          m[3] = min(m[3], -(x0 + 31 - __clz(b)));
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < 4 * n_planes; i += kThreads) {
      int m = kNone;
      for (int j = 0; j < kWarps; ++j) m = min(m, part[j * 4 * n_planes + i]);
      if (m != kNone) atomicMin(bounds + i, m);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicAdd(bounds + 4 * n_planes, 1) ==
             kNone + (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }

  // The last block: _cropped_plane's choice, the first level (ascending
  // area) that holds the bounds, its corner clipped into the grid; the
  // whole grid where none does.  An empty footprint has the bounds of
  // _crop_bounds on an empty mask, (0, h - 1, 0, w - 1).
  for (int k = tid; k < n_planes; k += kThreads) {
    const bool en = enabled == nullptr || enabled[k] != 0;
    int y0c = 0, x0c = 0, ch = h, cw = w;
    bool go = en;
    if (has_crop) {
      const int b0 = __ldcg(bounds + 4 * k), b1 = __ldcg(bounds + 4 * k + 1);
      const int b2 = __ldcg(bounds + 4 * k + 2);
      const int b3 = __ldcg(bounds + 4 * k + 3);
      const bool nonempty = b0 != kNone;
      const int y0 = nonempty ? b0 : 0;
      const int x0 = nonempty ? b1 : 0;
      const int y1 = nonempty ? -b2 : h - 1;
      const int x1 = nonempty ? -b3 : w - 1;
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

// bounds: (4 K + 1) ints of scratch.  n_blocks: the persistent grid (the
// caller's few blocks an SM, fewer where the grid has fewer warp rows);
// without a crop cascade one block writes the whole-grid windows.
extern "C" int lsr_vis_windows(const float* wp, int sy, int sx, int s3, int h,
                               int w, int scale, const int* info,
                               const float* spot_vp, const float* cpos,
                               const float* crange,
                               const unsigned char* enabled,
                               const int* levels, int n_levels, int has_crop,
                               int* bounds, int* win, unsigned char* run,
                               int n_planes, int n_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 1;
  if (has_crop) {
    cudaError_t e = cudaMemsetAsync(bounds, 0x7F,
                                    sizeof(int) * (4 * (size_t)n_planes + 1),
                                    s);
    if (e != cudaSuccess) return (int)e;
    const long long rows = (long long)h * ((w + 31) / 32);
    const long long need = (rows + kWarps - 1) / kWarps;
    grid = (int)(need < n_blocks ? need : n_blocks);
    grid = grid < 1 ? 1 : grid;
  }
  const size_t smem =
      has_crop ? sizeof(float) * (size_t)n_planes * (kTab + 1 + 4 * kWarps)
               : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  vis_footprint_kernel<<<grid, kThreads, smem, s>>>(
      wp, sy, sx, s3, h, w, scale, info, spot_vp, cpos, crange, enabled,
      levels, n_levels, has_crop, n_planes, bounds, win, run);
  return (int)cudaGetLastError();
}
