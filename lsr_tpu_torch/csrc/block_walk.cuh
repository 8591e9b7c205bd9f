// The cull-and-evaluate walk shared by the rasterizers B1
// (direct_raster.cu), B3 (tiled_raster.cu) and B4 (chunklist_raster.cu).
//
// A block of 256 threads owns a 16x16 pixel block inside one screen tile
// and walks that tile's candidates (B1: the triangles of the listed supers
// whose chunk bbox meets the block; B3: the listed setup rows; B4: the
// triangles of the listed chunks) in list order, in steps:
//
//  (a) cull: each thread takes one candidate of the step, reads the ten
//      record lanes the coverage test uses, and drops the candidate if
//      lsr::rect_reject says no pixel of the block can be covered.  The
//      survivors are compacted in list order (__ballot_sync inside a warp,
//      a prefix over the eight warp totals across) into a queue in shared
//      memory, where their records are staged;
//  (b) evaluate: when the queue cannot take another step, or the list ends,
//      every thread walks the queue in order with lsr::tri_depth and a
//      strict '<' in registers: first submitted wins, no atomics.  A warp
//      owns an 8x4 pixel footprint and first culls the queue against it, 32
//      queue entries at a time, one per lane, so a pixel only evaluates
//      what reaches its warp.
//
// The cull is exact (raster_common.cuh), so depth and tid equal the plain
// versions, which evaluate every candidate at every pixel, bit for bit.
//
// One __syncthreads per step (the warp totals are double buffered) and one
// more per evaluation.  The step, the queue's size and layout, the second
// cull level and the prefetch are the measured choice among the
// alternatives listed in the header of tiled_raster.cu.

#pragma once

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace lsr {

constexpr int kBlock = 16;                 // pixel block edge
constexpr int kThreads = kBlock * kBlock;  // one thread per pixel
constexpr int kWarps = kThreads / 32;
constexpr int kWarpW = 8, kWarpH = 4;      // a warp's pixel footprint
constexpr int kStep = kThreads;            // candidates culled per step
constexpr int kQueue = 2 * kStep;          // survivor queue, in records
constexpr unsigned kFullMask = 0xffffffffu;

// Dynamic shared memory of one block: the queue of staged records (and
// their packed bands when the walk uses them) and the warp totals.
constexpr size_t walk_smem_bytes(bool bands) {
  return (size_t)kQueue * kRecVec * sizeof(float4)
         + (bands ? (size_t)kQueue * sizeof(int) : 0)
         + 2 * kWarps * sizeof(int);
}
static_assert(walk_smem_bytes(true) <= 48 * 1024,
              "the queue must fit the shared memory a launch gets by default");

// What one thread knows of its pixel and of the rectangles it culls
// against.  Warp w of the block owns the 8x4 pixels at
// (8 * (w % 2), 4 * (w / 2)).
struct WalkPixel {
  int x, y;        // pixel in the target
  float px, py;    // its center; py carries y_offset
  bool live;       // inside the NDC bounds: coverage is evaluated
  Rect block, warp;
};

// (bx, by): the first pixel of the thread's block.
__device__ __forceinline__ WalkPixel walk_pixel(int bx, int by, int width,
                                                int y_offset, float max_py) {
  const int w = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int wx = bx + (w & 1) * kWarpW, wy = by + (w >> 1) * kWarpH;
  WalkPixel p;
  p.x = wx + (wl & (kWarpW - 1));
  p.y = wy + wl / kWarpW;
  p.px = (float)p.x + 0.5f;
  p.py = (float)(p.y + y_offset) + 0.5f;
  p.live = p.px <= (float)(width - 1) && p.py <= max_py;
  p.block = {(float)bx + 0.5f, (float)(bx + kBlock - 1) + 0.5f,
             (float)(by + y_offset) + 0.5f,
             (float)(by + kBlock - 1 + y_offset) + 0.5f};
  p.warp = {(float)wx + 0.5f, (float)(wx + kWarpW - 1) + 0.5f,
            (float)(wy + y_offset) + 0.5f,
            (float)(wy + kWarpH - 1 + y_offset) + 0.5f};
  return p;
}

// Where a block of the 1-D grid works.  The launchers order the tiles by
// falling list length (order[rank] = tile), and the hardware starts blocks
// in grid order, so the blocks of the longest lists start first and the
// short ones fill in around them: the longest walk no longer runs alone at
// the end.  Returns the tile; (bx, by) is the block's first pixel.
__device__ __forceinline__ int walk_block(const long long* __restrict__ order,
                                          int tile_w, int tile_h, int tiles_x,
                                          int& bx, int& by) {
  const int bpt_x = tile_w / kBlock;
  const int bpt = bpt_x * (tile_h / kBlock);
  const int tile = (int)order[blockIdx.x / bpt], sub = blockIdx.x % bpt;
  bx = (tile % tiles_x) * tile_w + (sub % bpt_x) * kBlock;
  by = (tile / tiles_x) * tile_h + (sub / bpt_x) * kBlock;
  return tile;
}

// A packed band range, bits start << 2 | (count - 1) as in a chunk-list
// entry, meets bands [lo, hi].
__device__ __forceinline__ bool band_hit(int bands, int lo, int hi) {
  const int bs = (bands >> 2) & 3;
  return hi >= bs && lo <= bs + (bands & 3);
}

// One candidate of the cull: its setup row (-1: none), its packed bands and
// the ten record lanes rect_reject reads.
struct Cand {
  int row, bands;
  float4 r0, r1;
  float c2, id;
};

// Candidate i of the walk, or row -1 past the end or where the source has
// none (B4: the entry's bands miss the block).
template <class Source>
__device__ __forceinline__ void locate(const Source& src, int i, int n,
                                       Cand& c) {
  c.row = -1;
  c.bands = 0;
  if (i < n) src(i, c.row, c.bands);
}

__device__ __forceinline__ void load_lanes(const float4* __restrict__ rec,
                                           Cand& c) {
  if (c.row < 0) return;
  const float4* r = rec + (size_t)c.row * kRecVec;
  c.r0 = __ldg(r);
  c.r1 = __ldg(r + 1);
  c.c2 = __ldg((const float*)r + 8);
  c.id = __ldg((const float*)r + 15);
}

// Fold one queued record into the pixel's depth and id: strict '<', so the
// earlier entry keeps a tie; with kTieTid an exact depth tie goes to the
// smaller triangle id instead (B1's spatially sorted rows, whose list order
// is not submission order).
template <bool kTieTid>
__device__ __forceinline__ void resolve_entry(float4 r0, float4 r1, float4 r2,
                                              float4 r3, const WalkPixel& p,
                                              int depth_mode, float zn,
                                              float inv_range, float& d,
                                              int& t) {
  float z01;
  if (p.live
      && tri_depth(r0, r1, r2, r3, p.px, p.py, depth_mode, zn, inv_range, z01)
      && (z01 < d || (kTieTid && z01 == d && (int)r3.w < t))) {
    d = z01;
    t = (int)r3.w;
  }
}

// float4 u of queue entry j's record.  Staged records lie in shared memory
// as four planes of kQueue float4, so the lanes of a warp that read 32
// different entries hit 32 different banks.
__device__ __forceinline__ float4& queue_rec(float4* qrec, int j, int u) {
  return qrec[u * kQueue + j];
}

// The walk.  src(i, row, bands) names candidate i < n of the block's tile
// (it leaves row at -1 where there is none); kBands: a candidate only
// touches the rows of its bands, my_band is the thread's band and
// [warp_band_lo, warp_band_hi] its warp's.  d and t are the pixel's depth
// and triangle id, updated in list order; kTieTid as in resolve_entry.
template <bool kBands, bool kTieTid, class Source>
__device__ __forceinline__ void block_walk(
    const Source& src, int n, const float4* __restrict__ rec,
    const WalkPixel& p, int my_band, int warp_band_lo, int warp_band_hi,
    int depth_mode, float zn, float inv_range, float& d, int& t) {
  extern __shared__ float4 walk_smem[];
  float4* qrec = walk_smem;
  int* qband = (int*)(qrec + kQueue * kRecVec);
  int* wtot = qband + (kBands ? kQueue : 0);

  const int lane = threadIdx.x, w = lane >> 5, wl = lane & 31;
  int qn = 0;  // queued survivors, the same value in every thread

  // Thread `lane` takes candidate s + lane of the step that starts at s.
  // A register pipeline: the next step's cull lanes and the list entry of
  // the step after it are loaded before the current step is processed.
  Cand cur = {}, nxt = {};
  locate(src, lane, n, cur);
  locate(src, kStep + lane, n, nxt);
  load_lanes(rec, cur);
  for (int s = 0, it = 0; s < n; s += kStep, ++it) {
    Cand far = {};
    load_lanes(rec, nxt);
    locate(src, s + 2 * kStep + lane, n, far);

    // (a) cull against the block, compact the survivors in list order.
    const bool keep = cur.row >= 0
                      && !rect_reject(cur.r0, cur.r1, cur.c2, cur.id, p.block);
    const unsigned ballot = __ballot_sync(kFullMask, keep);
    int* wt = wtot + (it & 1) * kWarps;
    if (wl == 0) wt[w] = __popc(ballot);
    __syncthreads();
    int first = 0;  // queue slot of warp w's first survivor
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      if (k == w) first = qn;
      qn += wt[k];
    }
    if (keep) {
      const int pos = first + __popc(ballot & ((1u << wl) - 1u));
      const float4* r = rec + (size_t)cur.row * kRecVec;
      queue_rec(qrec, pos, 0) = cur.r0;
      queue_rec(qrec, pos, 1) = cur.r1;
      queue_rec(qrec, pos, 2) = __ldg(r + 2);
      queue_rec(qrec, pos, 3) = __ldg(r + 3);
      if (kBands) qband[pos] = cur.bands;
    }

    // (b) evaluate the queue once it cannot take another step: each warp
    // culls 32 queue entries against its own footprint (and bands), one per
    // lane, and its pixels evaluate the hits in order.
    if (qn + kStep > kQueue || s + kStep >= n) {
      __syncthreads();
      for (int base = 0; base < qn; base += 32) {
        const int k = base + wl;
        bool hit = false;
        if (k < qn) {
          hit = !rect_reject(queue_rec(qrec, k, 0), queue_rec(qrec, k, 1),
                             queue_rec(qrec, k, 2).x, queue_rec(qrec, k, 3).w,
                             p.warp)
                && (!kBands
                    || band_hit(qband[k], warp_band_lo, warp_band_hi));
        }
        unsigned m = __ballot_sync(kFullMask, hit);
        while (m) {
          const int j = base + __ffs(m) - 1;
          m &= m - 1;
          if (!kBands || band_hit(qband[j], my_band, my_band))
            resolve_entry<kTieTid>(queue_rec(qrec, j, 0),
                                   queue_rec(qrec, j, 1),
                                   queue_rec(qrec, j, 2),
                                   queue_rec(qrec, j, 3), p, depth_mode, zn,
                                   inv_range, d, t);
        }
      }
      qn = 0;
    }
    cur = nxt;
    nxt = far;
  }
}

}  // namespace lsr
