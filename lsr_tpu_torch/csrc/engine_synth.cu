// Kernel S1: the engine voice (port of the jitted lax.scan of
// lsr_tpu/audio/engine_synth.py:84 `synthesize`, step :99-174; no
// pallas_call there).
//
// What it computes: y[i] = main_y after step i of the synth's recurrence.
// The carried state: the rpm / throttle / load smoothers; the phases of the
// fundamental, the crack, the thump and the starter; the noise low-pass;
// the output low-pass.  Each step adds a 24-harmonic stack weighted by a
// load-binned table (8 x 24), four tones, a mix and a softclip.
//
// What bounds it: the loop-carried chains and the SM's issue, not bytes or
// operations.  A sample reads 24 bytes and writes 4 and does some 600
// float32 operations, but step i + 1 of a recurrence waits for step i, so
// one SM does all of it.  None of the heavy work feeds back: the sines, the
// mix and the tanh of a sample need only that sample's state.
//
// Design: one block, its warps specialised by stage.  Chunks of kChunk
// samples pass through a ring of kSlots shared-memory slots; a stage waits
// on its predecessor's mbarrier of the slot, works, and arrives on its own
// (no block-wide barrier after set-up).  In chunk order:
//   load      (1 warp): the six input columns into the slot, once the
//             low-pass stage has freed it; past n, zeros.
//   smooth    (2 warps, serial): rpm_s on one; thr_s and load_s on lanes
//             0-1 of the other.
//   feed      (1 warp, a lane a sample): the increments of the four phases,
//             the noise low-pass's coefficient, and whether the chunk's
//             phase increments allow the fast wrap (below).
//   phases    (1 warp, serial): the four phases on lanes 0-3.
//   noise     (1 warp, serial): the noise low-pass on lane 0.
//   output    (2 x kChunk / 32 warps, a thread a sample, the two halves on
//             alternate chunks): hp, starter, catch, the 24 weighted
//             harmonics summed in a fixed pairwise tree, the four tones, the
//             mix, tanhf, the output low-pass's coefficient.
//   low-pass  (1 warp, serial): main_y on lane 0; the warp writes y.
// The serial stages work on different chunks at once, so the time
// approaches the slower of the longest chain and the SM's issue.  A serial
// lane reads its inputs a batch of kBatch samples ahead of its chain
// (16-byte shared loads) and stores a batch at once; its step is only its
// chain.  Every stage walks whole chunks: the last one is padded with zeros
// past n, and the padded samples' state is never used.  The warps sit so
// that the serial ones share two of the SM's four schedulers (warp % 4) with
// nothing but each other, and the output warps issue on the other two.
//
// Rounding: built with -fmad=false, so a * b + c rounds twice, as the
// plain version's separate torch ops do; __fmaf_rn stands exactly where
// the plain version calls math3d.fma (where XLA:CPU fuses the reference's
// multiply-adds), sinf and tanhf are CUDA's, as torch's.  The constants
// come from the wrapper (step_constants), float32 values folded as XLA
// folds them.  The harmonic sum is _butterfly_sum's tree over 32 slots,
// slots 24-31 zero and added as such.  Where a stage's step is written
// otherwise than the plain version's, it is the same bit for bit on every
// input that is not NaN:
// - thr_s, load_s: clamp(v, 0, 1) is __saturatef(v) (v is never -0: the
//   smoother starts at +0 and an exact zero sum rounds to +0); rpm_s:
//   clamp(v, -inf, inf) is v.
// - The plain version runs the phases and the noise low-pass as one 5-wide
//   step, s = fma(a, b - s * lp, s); s = s - floor(s) * wrap, with the
//   masks lp and wrap 0 or 1.  For finite state its products by 0 and 1
//   are exact; per lane it reads
//     phase lanes: u = fma(inc, dt, s); s = u - floor(u)   (s >= 0: s*0 = +0)
//     noise lane:  s = fma(lp_a, n - s, s) + 0    (u - floor(u) * 0 is u + 0)
//   The noise lane carries s without the + 0: the two differ only by the
//   sign of a zero, which neither n - s nor fma(lp_a, ., s) passes on to a
//   nonzero result, so the output stage adds the + 0 (and takes hp).
// - A phase wrap, u - floor(u), is u - (u >= 1) while u is in [0, 2), and
//   u = fma(inc, dt, s) is, since every wrap leaves s in [0, 1], when inc
//   lies in [0, 0.5 / dt].  Feed checks that for every sample of a chunk;
//   other chunks take floorf.

#include <cuda_runtime.h>

namespace {

constexpr int kHarm = 24;
constexpr int kBins = 8;
constexpr int kTree = 32;        // slots of the harmonic sum's pairwise tree
constexpr int kChunk = 256;      // samples a slot
constexpr int kSlots = 8;        // slots in the ring
constexpr int kBatch = 8;        // samples a serial lane reads ahead
constexpr int kInputs = 6;       // rpm, throttle, load, tmul, burst, noise
constexpr int kOutGroups = 2;    // output warp groups, on alternate chunks
constexpr int kOutWarps = kOutGroups * kChunk / 32;
constexpr int kThreads = 1024;
constexpr unsigned long long kWaitLimitNs = 10'000'000'000ull;

// Warp roles.  Warp w issues on scheduler w % 4: the output warps take
// schedulers 2-3, the others 0-1 (noise, low-pass, feed and load on 0; the
// smoothers and the phases on 1).  Warps without a role exit.
enum Role { kNoise, kRpm, kLowPass, kLevel, kFeed, kPhase, kLoad, kOutput,
            kIdle };
static_assert(2 * kOutWarps == kThreads / 32,
              "the output warps are those on schedulers 2-3");

__device__ __forceinline__ Role role_of(int warp) {
    if (warp % 4 >= 2) return kOutput;
    const int id = warp / 4 * 2 + warp % 4;
    return id < kOutput ? static_cast<Role>(id) : kIdle;
}

// Output warp w's index in [0, kOutWarps).
__device__ __forceinline__ int output_index(int warp) {
    return warp / 4 * 2 + warp % 4 - 2;
}

// The mbarrier each stage arrives on when it is done with a slot.  Every
// thread of the stage arrives: a warp, the two smoothers' warps together
// (kSmoothed), the phase and noise warps together (kAccumulated), one
// output group (kMixed).
enum Stage { kLoaded, kSmoothed, kFed, kAccumulated, kMixed, kDone,
             kStages };

__device__ __forceinline__ unsigned arrivals(int stage) {
    return stage == kSmoothed || stage == kAccumulated ? 64u
         : stage == kMixed ? kChunk : 32u;
}

struct alignas(16) Slot {
    float in[kInputs][kChunk];
    float smooth[3][kChunk];     // rpm_s, thr_s, load_s
    float inc[5][kChunk];        // f0, crack_hz, thump_hz, whine, lp_a
    float ph[4][kChunk];         // phase, crack_ph, thump_ph, starter_ph
    float lp[kChunk];            // lp_y (without the + 0)
    float mix[2][kChunk];        // the softclipped x, main_a
    float y[kChunk];
    float lp_before;             // lp_y before the chunk (without the + 0)
    int fast_wrap;               // the phases may take the fast wrap
};

struct Shared {
    Slot ring[kSlots];
    float harm[kBins * kHarm];
    unsigned long long bar[kStages][kSlots];
};

struct Args {
    const float* col[kInputs];
    const float* harm;
    const float* uni;
    float* y;
    int n;
};

struct Uniforms {
    float dt, wh_slope, st_slope, catch_rate, f0_scale, r7000, soft, two_pi;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* b,
                                         unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* b) {
    asm volatile("{\n\t.reg .b64 st;\n\t"
                 "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
                 :: "r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ bool bar_try_wait(unsigned long long* b,
                                             unsigned parity) {
    unsigned done;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_addr(b)), "r"(parity) : "memory");
    return done != 0;
}

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Waits for the phase of `b` with this parity to complete.  A pipeline
// that stalls for kWaitLimitNs traps (the launch fails) instead of
// holding the card.
__device__ __forceinline__ void bar_wait(unsigned long long* b,
                                         unsigned parity) {
    if (bar_try_wait(b, parity)) return;
    const unsigned long long t0 = now_ns();
    while (!bar_try_wait(b, parity))
        if (now_ns() - t0 > kWaitLimitNs) __trap();
}

// Chunk k's slot and the parity of its round.
__device__ __forceinline__ int slot_of(int k) { return k % kSlots; }
__device__ __forceinline__ unsigned parity_of(int k) {
    return (k / kSlots) & 1;
}

__device__ __forceinline__ float wrap01(float x) { return x - floorf(x); }

__device__ __forceinline__ float clamp01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ void load_batch(float (&v)[kBatch],
                                           const float* p) {
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(p)[q];
        v[4 * q] = f.x; v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
}

__device__ __forceinline__ void store_batch(float* p,
                                            const float (&v)[kBatch]) {
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q)
        reinterpret_cast<float4*>(p)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// One serial lane's walk over a chunk: step(x) takes sample j's NI inputs
// src[.][j], carries the state and returns its output dst[j].  Two batches
// alternate, so a batch's inputs are read while the chain works on the one
// before.
template <int NI, class Step>
__device__ __forceinline__ void walk(const float* const (&src)[NI],
                                     float* dst, Step step) {
    float a[NI][kBatch], b[NI][kBatch];
    auto run = [&](const float (&v)[NI][kBatch], int j0) {
        float out[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            float x[NI];
#pragma unroll
            for (int i = 0; i < NI; ++i) x[i] = v[i][u];
            out[u] = step(x);
        }
        store_batch(dst + j0, out);
    };
#pragma unroll
    for (int i = 0; i < NI; ++i) load_batch(a[i], src[i]);
#pragma unroll 1
    for (int j0 = 0; j0 < kChunk; j0 += 2 * kBatch) {
#pragma unroll
        for (int i = 0; i < NI; ++i) load_batch(b[i], src[i] + j0 + kBatch);
        run(a, j0);
        // The last pass reloads the chunk's last batch: in bounds, unused.
        const int jn = min(j0 + 2 * kBatch, kChunk - kBatch);
#pragma unroll
        for (int i = 0; i < NI; ++i) load_batch(a[i], src[i] + jn);
        run(b, j0 + kBatch);
    }
}

__device__ void load_stage(Shared& sh, const Args& g, int chunks, int lane) {
    constexpr int kPer = kChunk / 32;
    for (int k = 0; k < chunks; ++k) {
        const int s = slot_of(k);
        if (k >= kSlots) bar_wait(&sh.bar[kDone][s], parity_of(k - kSlots));
        const int c0 = k * kChunk;
        float v[kInputs][kPer];
#pragma unroll
        for (int a = 0; a < kInputs; ++a)
#pragma unroll
            for (int r = 0; r < kPer; ++r) {
                const int i = c0 + lane + 32 * r;
                v[a][r] = i < g.n ? g.col[a][i] : 0.0f;
            }
#pragma unroll
        for (int a = 0; a < kInputs; ++a)
#pragma unroll
            for (int r = 0; r < kPer; ++r)
                sh.ring[s].in[a][lane + 32 * r] = v[a][r];
        bar_arrive(&sh.bar[kLoaded][s]);
    }
}

// The parameter smoothers, x_s = clamp(fma(x_in - x_s, 0.02, x_s), lo, hi):
// rpm on lane 0 (unclamped), or (level) throttle and load on lanes 0-1
// ([0, 1]).
__device__ void smooth_stage(Shared& sh, int chunks, int lane, bool level) {
    const int a = level ? 1 + min(lane, 1) : 0;
    const bool active = lane < (level ? 2 : 1);
    float s = level ? 0.0f : 900.0f;
    for (int k = 0; k < chunks; ++k) {
        const int sl = slot_of(k);
        bar_wait(&sh.bar[kLoaded][sl], parity_of(k));
        Slot& r = sh.ring[sl];
        const float* const src[1] = {r.in[a]};
        if (active && level)
            walk(src, r.smooth[a], [&](const float (&x)[1]) {
                return s = __saturatef(__fmaf_rn(x[0] - s, 0.02f, s));
            });
        else if (active)
            walk(src, r.smooth[0], [&](const float (&x)[1]) {
                return s = __fmaf_rn(x[0] - s, 0.02f, s);
            });
        __syncwarp();
        bar_arrive(&sh.bar[kSmoothed][sl]);
    }
}

// The increments of phase, crack, thump and starter, and lp_a, a lane a
// sample; and fast_wrap: every phase increment of the chunk in [0, 0.5 /
// dt].
__device__ void feed_stage(Shared& sh, const Uniforms& c, int chunks,
                           int lane) {
    const float max_inc = 0.5f / c.dt;
    for (int k = 0; k < chunks; ++k) {
        const int sl = slot_of(k);
        bar_wait(&sh.bar[kSmoothed][sl], parity_of(k));
        Slot& r = sh.ring[sl];
        bool fast = true;
        for (int j = lane; j < kChunk; j += 32) {
            const float t = (float)(k * kChunk + j) * c.dt;
            const float rpm_s = r.smooth[0][j], thr_s = r.smooth[1][j],
                        load_s = r.smooth[2][j];
            const float rpm_norm = fminf(rpm_s * c.r7000, 1.0f);
            const float jitter = __fmaf_rn(
                __fmaf_rn(load_s, 0.0025f, 0.001f), r.in[5][j], 1.0f);
            const float inc[4] = {
                (rpm_s * c.f0_scale) * jitter,
                __fmaf_rn(rpm_norm, 350.0f, __fmaf_rn(thr_s, 550.0f, 900.0f)),
                __fmaf_rn(rpm_norm, 20.0f, __fmaf_rn(thr_s, 40.0f, 90.0f)),
                __fmaf_rn(t, c.wh_slope, 160.0f)};
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                r.inc[p][j] = inc[p];
                fast = fast && inc[p] >= 0.0f && inc[p] <= max_inc;
            }
            r.inc[4][j] = __fmaf_rn(thr_s, 0.14f, 0.025f);
        }
        fast = __all_sync(0xffffffffu, fast);
        if (lane == 0) r.fast_wrap = fast;
        __syncwarp();
        bar_arrive(&sh.bar[kFed][sl]);
    }
}

// phase, crack_ph, thump_ph, starter_ph on lanes 0-3: wrap01(fma(inc, dt,
// ph)).
__device__ void phase_stage(Shared& sh, float dt, int chunks, int lane) {
    const int a = min(lane, 3);
    float s = 0.0f;
    for (int k = 0; k < chunks; ++k) {
        const int sl = slot_of(k);
        bar_wait(&sh.bar[kFed][sl], parity_of(k));
        Slot& r = sh.ring[sl];
        const float* const src[1] = {r.inc[a]};
        if (lane < 4 && r.fast_wrap)
            walk(src, r.ph[a], [&](const float (&x)[1]) {
                const float u = __fmaf_rn(x[0], dt, s);
                return s = u - (float)(u >= 1.0f);
            });
        else if (lane < 4)
            walk(src, r.ph[a], [&](const float (&x)[1]) {
                const float u = __fmaf_rn(x[0], dt, s);
                return s = u - floorf(u);
            });
        __syncwarp();
        bar_arrive(&sh.bar[kAccumulated][sl]);
    }
}

// The noise low-pass on lane 0, lp_y = fma(lp_a, n - lp_y, lp_y), carried
// without the + 0.
__device__ void noise_stage(Shared& sh, int chunks, int lane) {
    float s = 0.0f;
    for (int k = 0; k < chunks; ++k) {
        const int sl = slot_of(k);
        bar_wait(&sh.bar[kFed][sl], parity_of(k));
        Slot& r = sh.ring[sl];
        if (lane == 0) {
            r.lp_before = s;
            const float* const src[2] = {r.inc[4], r.in[5]};
            walk(src, r.lp, [&](const float (&x)[2]) {
                return s = __fmaf_rn(x[0], x[1] - s, s);
            });
        }
        __syncwarp();
        bar_arrive(&sh.bar[kAccumulated][sl]);
    }
}

// A sample's output before the low-pass: thread j of output group `group`
// on every chunk k with k % kOutGroups == group.
__device__ void output_stage(Shared& sh, const Uniforms& c, int chunks,
                             int group, int j) {
    for (int k = group; k < chunks; k += kOutGroups) {
        const int sl = slot_of(k);
        bar_wait(&sh.bar[kAccumulated][sl], parity_of(k));
        Slot& r = sh.ring[sl];
        const float t = (float)(k * kChunk + j) * c.dt;
        const float rpm_s = r.smooth[0][j], thr_s = r.smooth[1][j],
                    load_s = r.smooth[2][j];
        const float phase = r.ph[0][j], crack_ph = r.ph[1][j],
                    thump_ph = r.ph[2][j], starter_ph = r.ph[3][j];
        const float lp_y = __fadd_rn(r.lp[j], 0.0f);
        const float hp = lp_y
            - __fadd_rn(j > 0 ? r.lp[j - 1] : r.lp_before, 0.0f);
        const float rpm_norm = fminf(rpm_s * c.r7000, 1.0f);

        // The load-binned harmonic stack, in _butterfly_sum's tree.
        const int bin = (int)fminf(
            fmaxf(rintf(load_s * (float)(kBins - 1)), 0.0f),
            (float)(kBins - 1));
        const float* w = sh.harm + bin * kHarm;
        float tree[kTree];
#pragma unroll
        for (int h = 0; h < kHarm; ++h)
            tree[h] = w[h] * sinf(wrap01(phase * (float)(h + 1)) * c.two_pi);
#pragma unroll
        for (int h = kHarm; h < kTree; ++h) tree[h] = 0.0f;
#pragma unroll
        for (int level = 1; level <= 5; ++level)
#pragma unroll
            for (int h = 0; h < kTree >> level; ++h)
                tree[h] = tree[h] + tree[h + (kTree >> level)];
        const float base = tree[0];

        // Starter whine and the catch envelope.
        const float starter =
            t < 0.55f ? ((1.0f - t * c.st_slope) * 0.13f)
                        * sinf(starter_ph * c.two_pi)
                      : 0.0f;
        const float catch_env = clamp01((t + -0.45f) * c.catch_rate);

        // Noise gain, burst voices, mix.
        const float crack_tone = sinf(crack_ph * c.two_pi);
        const float crack_tone2 = sinf(wrap01(crack_ph * 1.55f) * c.two_pi);
        const float thump = sinf(thump_ph * c.two_pi);
        const float drive =
            clamp01(fminf(fmaxf(r.in[3][j], 0.0f), 1.15f)) * 0.76f + 0.24f;
        const float hiss = (thr_s * 0.04f + 0.006f)
                           * (rpm_norm * 0.75f + 0.25f);
        const float crack = clamp01(r.in[4][j])
            * (((crack_tone * 0.06f + crack_tone2 * 0.03f) + hp * 0.03f)
               + thump * 0.085f);
        const float amp = (((load_s * 0.3f + 0.05f) + thr_s * 0.15f)
                           + rpm_norm * 0.07f) * drive;
        const float noise_gain =
            (hiss + (thr_s * 0.02f) * (load_s * 0.7f + 0.3f)) * drive;
        float x = (amp * base + noise_gain * lp_y) + crack;
        if (t < 1.0f) x = (1.0f - catch_env) * starter + catch_env * x;
        const float grit = load_s * 1.05f + 0.62f;
        r.mix[0][j] = tanhf((x * grit) * 1.5f) * c.soft;
        r.mix[1][j] = __fmaf_rn(__fmaf_rn(load_s, 0.75f, 0.25f), 0.28f,
                                0.022f);
        bar_arrive(&sh.bar[kMixed][sl]);
    }
}

// The output low-pass on lane 0, main_y = fma(main_a, x - main_y, main_y);
// the warp writes the chunk's y.
__device__ void lowpass_stage(Shared& sh, const Args& g, int chunks,
                              int lane) {
    float m = 0.0f;
    for (int k = 0; k < chunks; ++k) {
        const int sl = slot_of(k);
        bar_wait(&sh.bar[kMixed][sl], parity_of(k));
        Slot& r = sh.ring[sl];
        if (lane == 0) {
            const float* const src[2] = {r.mix[0], r.mix[1]};
            walk(src, r.y, [&](const float (&x)[2]) {
                return m = __fmaf_rn(x[1], x[0] - m, m);
            });
        }
        __syncwarp();
        for (int j = lane; j < kChunk; j += 32) {
            const int i = k * kChunk + j;
            if (i < g.n) g.y[i] = r.y[j];
        }
        bar_arrive(&sh.bar[kDone][sl]);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
engine_synth_kernel(const Args g) {
    extern __shared__ __align__(16) unsigned char smem[];
    Shared& sh = *reinterpret_cast<Shared*>(smem);
    if (threadIdx.x == 0) {
        for (int st = 0; st < kStages; ++st)
            for (int s = 0; s < kSlots; ++s)
                bar_init(&sh.bar[st][s], arrivals(st));
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    for (int k = threadIdx.x; k < kBins * kHarm; k += kThreads)
        sh.harm[k] = g.harm[k];
    const Uniforms c = {g.uni[0], g.uni[1], g.uni[2], g.uni[3],
                        g.uni[4], g.uni[5], g.uni[6], g.uni[7]};
    __syncthreads();

    const int chunks = (g.n + kChunk - 1) / kChunk;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    switch (role_of(warp)) {
        case kLoad: load_stage(sh, g, chunks, lane); break;
        case kRpm: smooth_stage(sh, chunks, lane, false); break;
        case kLevel: smooth_stage(sh, chunks, lane, true); break;
        case kFeed: feed_stage(sh, c, chunks, lane); break;
        case kPhase: phase_stage(sh, c.dt, chunks, lane); break;
        case kNoise: noise_stage(sh, chunks, lane); break;
        case kLowPass: lowpass_stage(sh, g, chunks, lane); break;
        case kOutput: {
            const int o = output_index(warp);
            output_stage(sh, c, chunks, o / (kChunk / 32),
                         o % (kChunk / 32) * 32 + lane);
            break;
        }
        case kIdle: break;
    }
}

}  // namespace

// The dynamic shared memory of a launch: the ring, the table, the barriers.
extern "C" int lsr_engine_synth_smem_bytes() { return (int)sizeof(Shared); }

extern "C" int lsr_engine_synth(const float* rpm, const float* thr,
                                const float* load, const float* tmul,
                                const float* burst, const float* noise,
                                const float* harm, const float* uni, float* y,
                                int n, cudaStream_t stream) {
    const Args g = {{rpm, thr, load, tmul, burst, noise}, harm, uni, y, n};
    const int smem = lsr_engine_synth_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        engine_synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    engine_synth_kernel<<<1, kThreads, smem, stream>>>(g);
    return (int)cudaGetLastError();
}
