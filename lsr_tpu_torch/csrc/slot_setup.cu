// Kernel F1: the "map" local-shadow atlas's front end.  For every slot of a
// stack (spot maps or cube faces, each a size x size depth target) and every
// input triangle, the depth-only setup of both near-clip fan rows, written
// straight into kernel B1's inputs: the setup records, the 16-row chunk
// boxes, and the per-128x128-tile lists of the 256-row supers.
//
// Replaces no pallas_call: lsr_tpu renders the "map" atlas slot by slot
// with XLA ops (lsr_tpu/lighting/local_shadows.py:_render_slot_stack,
// lsr_tpu/raster/setup.py:scene_setup_depth) before each slot's B1 launch.
// Plain version: raster/slot_setup.slot_inputs_plain (the batched torch ops
// of scene_setup_slots_depth, pack_direct_records, _chunk_bboxes and
// _super_lists), which this kernel equals bit for bit on the card, and
// which equals the per-slot chain scene_setup_depth -> pack_direct_records
// -> _chunk_bboxes -> _super_lists bit for bit:
//  - vertex_stage_world's model rows, scene_setup_depth's clip rows,
//    clip_triangles_near's case table, t-values and lerps, and
//    build_setup at CULL_NONE, each expression in its torch order (left to
//    right as written), built with -fmad=false, no fast math, IEEE
//    division and reciprocal, denormals kept;
//  - torch.clamp's NaN rule (NaN passes); every other value a torch.where
//    masks away is computed as torch computes it, so the records of
//    invalid rows are the same bits too.
//
// What bounds it on this card: nothing much.  The work is ~400 f32
// operations a (slot, triangle); the bytes are the records written, 128 a
// (slot, triangle) (66 MB a flagship frame: 20 slots of 51,456 rows, 0.02
// ms at 3.35 TB/s).  Positions, indices, models and masks stay in L2.
// What it replaces is ~290 small torch kernels a slot.
//
// What the design does about it: one block per (256-row super, slot), one
// thread per input triangle: the thread computes its three corners'
// world and clip positions, clips, sets up its two rows and writes them
// as eight 16-byte stores.  The 8 triangles of a 16-row chunk are 8
// neighbouring lanes, so the chunk box is a shuffle reduction of 3 steps;
// two more steps and a shared-memory step over the block's 4 warps give
// the super's box, which the block writes to scratch.  The last block of
// a slot to finish (a ticket counter behind __threadfence, zeroed by the
// launcher's memset) builds the slot's order-preserving super lists, a
// warp a tile, a ballot and a population count per 32 supers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;         // triangles of one 256-row super
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;            // B1's list tiles
constexpr float kBig = 1e9f;          // _chunk_bboxes' empty fill

// torch.clamp with scalar bounds on the card: NaN passes.
__device__ __forceinline__ float clamp_s(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

struct C4 {
  float x, y, z, w;
};

// clip_triangles_near's lerp: a + (b - a) * t, lane by lane.
__device__ __forceinline__ C4 lerp(const C4& a, const C4& b, float t) {
  return {a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
          a.z + (b.z - a.z) * t, a.w + (b.w - a.w) * t};
}

// edge_t(a, b): clamp(d_a / den, 0, 1), den = d_a - d_b where |den| > 1e-8,
// else 1.
__device__ __forceinline__ float edge_t(float da, float db) {
  float den = da - db;
  den = fabsf(den) > 1e-8f ? den : 1.0f;
  return clamp_s(da / den, 0.0f, 1.0f);
}

// Generator g of the clip polygon (0..2 corners, 3..5 the lerps, 6 zeros).
__device__ __forceinline__ C4 gen(int g, const C4& c0, const C4& c1,
                                  const C4& c2, const C4& l01, const C4& l12,
                                  const C4& l20) {
  const C4 z = {0.0f, 0.0f, 0.0f, 0.0f};
  return g == 0 ? c0 : g == 1 ? c1 : g == 2 ? c2 : g == 3 ? l01
       : g == 4 ? l12 : g == 5 ? l20 : z;
}

// _CASE_SLOTS (raster/clip.py), 3 bits a generator, slot 0 lowest.
__device__ __forceinline__ int case_slots(int cs) {
  constexpr int P = 6;
  const int t[8][4] = {{P, P, P, P}, {3, 5, 0, P}, {3, 1, 4, P},
                       {1, 4, 5, 0}, {4, 2, 5, P}, {3, 4, 2, 0},
                       {3, 1, 2, 5}, {1, 2, 0, P}};
  int packed = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k == cs)
      packed = t[k][0] | t[k][1] << 3 | t[k][2] << 6 | t[k][3] << 9;
  return packed;
}

struct Row {
  float coef[9], iw[3], ziw[3];
  float4 bb;       // x0, y0, x1, y1 as f32, or the empty fill
  bool ok;
};

// build_setup of one post-clip triangle for a size x size target
// (fs1 = size - 1), CULL_NONE; valid: the clip's and the masks' validity.
__device__ __forceinline__ void setup_row(const C4& p0, const C4& p1,
                                          const C4& p2, float fs1, bool valid,
                                          Row& r) {
  const C4 p[3] = {p0, p1, p2};
  float nx[3], ny[3], nz[3], sx[3], sy[3];
  bool w_ok = true, finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool pos = p[i].w > 1e-8f;
    w_ok = w_ok && pos;
    // where(w > 1e-8, 1 / clamp(w, 1e-8), 0): the clamp is w itself there.
    r.iw[i] = pos ? 1.0f / p[i].w : 0.0f;
    nx[i] = p[i].x * r.iw[i];
    ny[i] = p[i].y * r.iw[i];
    nz[i] = p[i].z * r.iw[i];
    finite = finite && isfinite(nx[i]) && isfinite(ny[i]) && isfinite(nz[i]);
    sx[i] = (nx[i] * 0.5f + 0.5f) * fs1;
    sy[i] = (ny[i] * 0.5f + 0.5f) * fs1;
    r.ziw[i] = nz[i] * r.iw[i];
  }
  const float e0x = sx[1] - sx[0], e0y = sy[1] - sy[0];
  const float e1x = sx[2] - sx[0], e1y = sy[2] - sy[0];
  const float area2 = e0x * e1y - e0y * e1x;
  const bool nondeg = fabsf(area2) >= 1e-10f;
  const float inv = nondeg ? 1.0f / area2 : 0.0f;
  // edge_coef(j, k) for (1, 2), (2, 0), (0, 1).
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int j = (e + 1) % 3, k = (e + 2) % 3;
    r.coef[3 * e] = (sy[j] - sy[k]) * inv;
    r.coef[3 * e + 1] = (sx[k] - sx[j]) * inv;
    r.coef[3 * e + 2] = (sx[j] * sy[k] - sx[k] * sy[j]) * inv;
  }
  const float xmin = fminf(fminf(sx[0], sx[1]), sx[2]);
  const float xmax = fmaxf(fmaxf(sx[0], sx[1]), sx[2]);
  const float ymin = fminf(fminf(sy[0], sy[1]), sy[2]);
  const float ymax = fmaxf(fmaxf(sy[0], sy[1]), sy[2]);
  const bool on_screen =
      xmax >= 0.0f && xmin <= fs1 && ymax >= 0.0f && ymin <= fs1;
  r.ok = valid && w_ok && finite && nondeg && on_screen;
  // The i64 bbox as _chunk_bboxes reads it (f32 of the clamped floor /
  // ceil; a valid row's are finite, so the int round trip only drops -0).
  r.bb = r.ok ? make_float4((float)(int)clamp_s(floorf(xmin), 0.0f, fs1),
                            (float)(int)clamp_s(floorf(ymin), 0.0f, fs1),
                            (float)(int)clamp_s(ceilf(xmax), 0.0f, fs1),
                            (float)(int)clamp_s(ceilf(ymax), 0.0f, fs1))
              : make_float4(kBig, kBig, -kBig, -kBig);
}

__device__ __forceinline__ void store_row(float4* out, const Row& r,
                                          float id) {
  out[0] = make_float4(r.coef[0], r.coef[1], r.coef[2], r.coef[3]);
  out[1] = make_float4(r.coef[4], r.coef[5], r.coef[6], r.coef[7]);
  out[2] = make_float4(r.coef[8], r.iw[0], r.iw[1], r.iw[2]);
  out[3] = make_float4(r.ziw[0], r.ziw[1], r.ziw[2], r.ok ? id : -1.0f);
}

__device__ __forceinline__ float4 merge(float4 a, float4 b) {
  return make_float4(fminf(a.x, b.x), fminf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

__device__ __forceinline__ float4 shfl_merge(float4 a, int mask) {
  float4 b;
  b.x = __shfl_xor_sync(0xffffffffu, a.x, mask);
  b.y = __shfl_xor_sync(0xffffffffu, a.y, mask);
  b.z = __shfl_xor_sync(0xffffffffu, a.z, mask);
  b.w = __shfl_xor_sync(0xffffffffu, a.w, mask);
  return merge(a, b);
}

// World then clip position of vertex v: vertex_stage_world's rows
// ((m0 x + m1 y) + m2 z) + m3, then scene_setup_depth's rows
// ((v0 wx + v1 wy) + v2 wz) + v3 ww.
__device__ __forceinline__ C4 clip_corner(const float* __restrict__ pos,
                                          const long long* __restrict__ vobj,
                                          const float* __restrict__ models,
                                          const float (&vp)[16],
                                          long long v) {
  const float x = __ldg(pos + 3 * v), y = __ldg(pos + 3 * v + 1);
  const float z = __ldg(pos + 3 * v + 2);
  const float* m = models + 16 * __ldg(vobj + v);
  float wc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    wc[r] = __ldg(m + 4 * r) * x + __ldg(m + 4 * r + 1) * y +
            __ldg(m + 4 * r + 2) * z + __ldg(m + 4 * r + 3);
  float c[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    c[r] = vp[4 * r] * wc[0] + vp[4 * r + 1] * wc[1] + vp[4 * r + 2] * wc[2] +
           vp[4 * r + 3] * wc[3];
  return {c[0], c[1], c[2], c[3]};
}

__global__ void __launch_bounds__(kThreads)
slot_setup_kernel(const float* __restrict__ pos,          // (V, 3)
                  const long long* __restrict__ indices,  // (T, 3)
                  const long long* __restrict__ vobj,     // (V,)
                  const long long* __restrict__ tobj,     // (T,)
                  const float* __restrict__ models,       // (O, 16)
                  const float* __restrict__ vps,          // (n, 16)
                  const unsigned char* __restrict__ vis,  // (n, O)
                  int n_obj,
                  const unsigned char* __restrict__ en,   // (n,) or null
                  int n_tris, int size,
                  float4* __restrict__ rec,         // (n, n_pad, 16)
                  float4* __restrict__ chunk_bb,    // (n, n_pad / 16, 4)
                  int* __restrict__ lists,          // (n, tiles, n_sup)
                  int* __restrict__ counts,         // (n, tiles)
                  float4* __restrict__ super_bb,    // (n, n_sup) scratch
                  int* __restrict__ tickets) {      // (n,) zeroed
  __shared__ float4 warp_bb[kWarps];
  __shared__ bool last;
  const int s = blockIdx.y, n_sup = gridDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long t = (long long)blockIdx.x * kThreads + tid;
  const long long n_pad = (long long)n_sup * 2 * kThreads;
  const float fs1 = (float)(size - 1);

  Row r0, r1;
  if (t < n_tris) {
    float vp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) vp[i] = __ldg(vps + 16 * s + i);
    const C4 c0 = clip_corner(pos, vobj, models, vp, __ldg(indices + 3 * t));
    const C4 c1 =
        clip_corner(pos, vobj, models, vp, __ldg(indices + 3 * t + 1));
    const C4 c2 =
        clip_corner(pos, vobj, models, vp, __ldg(indices + 3 * t + 2));
    // clip_triangles_near.
    const float d0 = c0.z + c0.w, d1 = c1.z + c1.w, d2 = c2.z + c2.w;
    const int cs = (d0 >= 0.0f) + 2 * (d1 >= 0.0f) + 4 * (d2 >= 0.0f);
    const C4 l01 = lerp(c0, c1, edge_t(d0, d1));
    const C4 l12 = lerp(c1, c2, edge_t(d1, d2));
    const C4 l20 = lerp(c2, c0, edge_t(d2, d0));
    const int g = case_slots(cs);
    const C4 q0 = gen(g & 7, c0, c1, c2, l01, l12, l20);
    const C4 q1 = gen(g >> 3 & 7, c0, c1, c2, l01, l12, l20);
    const C4 q2 = gen(g >> 6 & 7, c0, c1, c2, l01, l12, l20);
    const C4 q3 = gen(g >> 9 & 7, c0, c1, c2, l01, l12, l20);
    // _CASE_COUNT: 0 for case 0, 4 for cases 3, 5 and 6, else 3.
    const bool four = cs == 3 || cs == 5 || cs == 6;
    const bool shown = vis[(long long)s * n_obj + __ldg(tobj + t)] != 0 &&
                       (en == nullptr || en[s] != 0);
    setup_row(q0, q1, q2, fs1, shown && cs != 0, r0);
    setup_row(q0, q2, q3, fs1, shown && four, r1);
  } else {
    // pack_direct_records' padding rows: zeros, id -1, no box.
#pragma unroll
    for (int i = 0; i < 9; ++i) r0.coef[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) r0.iw[i] = r0.ziw[i] = 0.0f;
    r0.ok = false;
    r0.bb = make_float4(kBig, kBig, -kBig, -kBig);
    r1 = r0;
  }
  float4* out = rec + ((long long)s * n_pad + 2 * t) * 4;
  store_row(out, r0, (float)(2 * t));
  store_row(out + 4, r1, (float)(2 * t + 1));

  // The chunk box: the 8 triangles of a 16-row chunk are lanes 8k..8k+7.
  float4 bb = merge(r0.bb, r1.bb);
  bb = shfl_merge(bb, 1);
  bb = shfl_merge(bb, 2);
  bb = shfl_merge(bb, 4);
  if (lane % 8 == 0) chunk_bb[(long long)s * (n_pad / 16) + t / 8] = bb;
  // The super box: the warp's 4 chunks, then the block's 4 warps.
  bb = shfl_merge(bb, 8);
  bb = shfl_merge(bb, 16);
  if (lane == 0) warp_bb[warp] = bb;
  __syncthreads();
  if (tid == 0) {
    float4 sb = warp_bb[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sb = merge(sb, warp_bb[w]);
    super_bb[(long long)s * n_sup + blockIdx.x] = sb;
    __threadfence();
    last = atomicAdd(tickets + s, 1) == n_sup - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The slot's last block: _super_mask and _dense_lists.  Tile (ty, tx)
  // is list ty * tiles_x + tx; super j is listed where its box meets the
  // tile's pixels [tx * 128, tx * 128 + 127] x [ty * 128, ...].
  const int tiles_x = (size + kTile - 1) / kTile;
  const int tiles = tiles_x * tiles_x;
  const float4* sbb = super_bb + (long long)s * n_sup;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const float fx = (float)(tile % tiles_x * kTile);
    const float fy = (float)(tile / tiles_x * kTile);
    int* list = lists + ((long long)s * tiles + tile) * n_sup;
    int n = 0;
    for (int j0 = 0; j0 < n_sup; j0 += 32) {
      const int j = j0 + lane;
      bool hit = false;
      if (j < n_sup) {
        const float4 b = __ldcg(sbb + j);
        hit = b.x <= fx + (float)(kTile - 1) && b.z >= fx &&
              b.y <= fy + (float)(kTile - 1) && b.w >= fy;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) list[n + __popc(m & ((1u << lane) - 1u))] = j;
      n += __popc(m);
    }
    for (int k = n + lane; k < n_sup; k += 32) list[k] = -1;
    if (lane == 0) counts[(long long)s * tiles + tile] = n;
  }
}

}  // namespace

// n_slots slots of size x size over n_tris triangles: rec (n_slots, n_pad,
// 16) f32, chunk_bb (n_slots, n_pad / 16, 4) f32, lists (n_slots, tiles,
// n_sup) i32, counts (n_slots, tiles) i32, where n_pad = n_sup * 256 >= 2
// n_tris (n_sup >= 1) and tiles = ceil(size / 128)^2; scratch: super_bb
// (n_slots, n_sup, 4) f32 and tickets (n_slots,) i32, which the launcher
// zeroes.  obj_visible (n_slots, n_objects) u8; slot_enabled (n_slots,) u8
// or null.
extern "C" int lsr_slot_setup(const void* positions, const void* indices,
                              const void* vtx_obj, const void* tri_obj,
                              const void* models, const void* viewprojs,
                              const void* obj_visible, int n_objects,
                              const void* slot_enabled, int n_tris,
                              int n_slots, int size, int n_sup, void* rec,
                              void* chunk_bb, void* lists, void* counts,
                              void* super_bb, void* tickets, void* stream) {
  if (n_slots < 1 || n_slots > 65535 || size < 1 || n_sup < 1 ||
      (long long)n_sup * 2 * kThreads < 2LL * n_tris)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(tickets, 0, sizeof(int) * (size_t)n_slots,
                                  st);
  if (e != cudaSuccess) return (int)e;
  slot_setup_kernel<<<dim3(n_sup, n_slots), kThreads, 0, st>>>(
      (const float*)positions, (const long long*)indices,
      (const long long*)vtx_obj, (const long long*)tri_obj,
      (const float*)models, (const float*)viewprojs,
      (const unsigned char*)obj_visible, n_objects,
      (const unsigned char*)slot_enabled, n_tris, size, (float4*)rec,
      (float4*)chunk_bb, (int*)lists, (int*)counts, (float4*)super_bb,
      (int*)tickets);
  return (int)cudaGetLastError();
}
