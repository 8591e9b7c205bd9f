// Kernel S1: the engine voice, sample-serial (port of the jitted lax.scan
// of lsr_tpu/audio/engine_synth.py:84 `synthesize`, step :99-174; no
// pallas_call there).
//
// What it computes: y[i] = main_y after step i of the synth's recurrence.
// The carried state is ten floats: the phases of the fundamental, the
// crack, the thump and the starter; the rpm / throttle / load smoothers;
// the noise low-pass, its previous value and the output low-pass.  Each
// step adds a 24-harmonic stack weighted by a load-binned table (8 x 24).
//
// What bounds it: the chain of dependent steps, not bytes or operations.
// A step reads 24 bytes and writes 4, and does some 600 float32
// operations; the recurrence makes step i + 1 wait for step i, so one warp
// walks the samples in order (one voice, as lsr_tpu's one scan).  Its
// floor is N times the latency of the longest loop-carried chain (a
// smoother: sub, fma, max, min), and in practice the warp's in-order issue
// of one step's instructions.
//
// Design: every lane carries the same state, so no broadcast of it is
// needed.  The sines of a step are one sinf per lane: lane k < 24 takes
// harmonic k + 1, lanes 24-27 the starter, crack, crack x 1.55 and thump
// tones.  A __shfl_xor_sync butterfly sums the 24 weighted harmonics
// (lane 0's order is the plain version's _butterfly_sum), and lane 0's sum
// and the four tones are shuffled to every lane.  The table lives in
// shared memory; the inputs are staged there CHUNK samples at a time, so a
// step reads shared memory only.  Lane 0 writes y.
//
// Rounding: built with -fmad=false, so a * b + c rounds twice, as the
// plain version's separate torch ops do; __fmaf_rn stands exactly where
// the plain version calls math3d.fma (where XLA:CPU fuses the reference's
// multiply-adds).  The constants come from the wrapper (step_constants),
// float32 values folded as XLA folds them.

#include <cuda_runtime.h>

namespace {

constexpr int kHarm = 24;
constexpr int kBins = 8;
constexpr int kChunk = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float wrap01(float x) { return x - floorf(x); }

__device__ __forceinline__ float clamp01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(32)
engine_synth_kernel(const float* __restrict__ rpm,
                    const float* __restrict__ thr,
                    const float* __restrict__ load,
                    const float* __restrict__ tmul,
                    const float* __restrict__ burst,
                    const float* __restrict__ noise,
                    const float* __restrict__ harm,
                    const float* __restrict__ uni,
                    float* __restrict__ y, int n) {
    __shared__ float s_harm[kBins * kHarm];
    __shared__ float s_in[6][kChunk];
    const int lane = threadIdx.x;
    for (int k = lane; k < kBins * kHarm; k += 32) s_harm[k] = harm[k];

    const float dt = uni[0], wh_slope = uni[1], st_slope = uni[2],
                catch_rate = uni[3], f0_scale = uni[4], r7000 = uni[5],
                soft = uni[6], two_pi = uni[7];
    const float ks = (float)(lane + 1);
    const float* const src[6] = {rpm, thr, load, tmul, burst, noise};

    float phase = 0.0f, crack_ph = 0.0f, thump_ph = 0.0f, starter_ph = 0.0f;
    float rpm_s = 900.0f, thr_s = 0.0f, load_s = 0.0f;
    float lp_y = 0.0f, main_y = 0.0f;

    for (int c0 = 0; c0 < n; c0 += kChunk) {
        const int m = min(kChunk, n - c0);
        __syncwarp();
        for (int a = 0; a < 6; ++a)
            for (int j = lane; j < m; j += 32) s_in[a][j] = src[a][c0 + j];
        __syncwarp();
        for (int j = 0; j < m; ++j) {
            const int i = c0 + j;
            const float t = (float)i * dt;
            const float nz = s_in[5][j];

            // Parameter smoothers (a = 0.02).
            rpm_s = __fmaf_rn(s_in[0][j] - rpm_s, 0.02f, rpm_s);
            thr_s = clamp01(__fmaf_rn(s_in[1][j] - thr_s, 0.02f, thr_s));
            load_s = clamp01(__fmaf_rn(s_in[2][j] - load_s, 0.02f, load_s));

            // Increments of the four phases, then the phases.
            const float rpm_norm = fminf(rpm_s * r7000, 1.0f);
            const float crack_hz = __fmaf_rn(
                rpm_norm, 350.0f, __fmaf_rn(thr_s, 550.0f, 900.0f));
            const float thump_hz = __fmaf_rn(
                rpm_norm, 20.0f, __fmaf_rn(thr_s, 40.0f, 90.0f));
            const float jitter = __fmaf_rn(
                __fmaf_rn(load_s, 0.0025f, 0.001f), nz, 1.0f);
            const float f0 = (rpm_s * f0_scale) * jitter;
            const float whine = __fmaf_rn(t, wh_slope, 160.0f);
            phase = wrap01(__fmaf_rn(f0, dt, phase));
            crack_ph = wrap01(__fmaf_rn(crack_hz, dt, crack_ph));
            thump_ph = wrap01(__fmaf_rn(thump_hz, dt, thump_ph));
            starter_ph = wrap01(__fmaf_rn(whine, dt, starter_ph));

            // Noise low-pass and its first difference.
            const float lp_a = __fmaf_rn(thr_s, 0.14f, 0.025f);
            const float lp_new = __fmaf_rn(lp_a, nz - lp_y, lp_y);
            const float hp = lp_new - lp_y;
            lp_y = lp_new;

            // One sinf a lane: harmonics on lanes 0-23, tones on 24-27.
            float arg;
            if (lane < kHarm) arg = wrap01(phase * ks) * two_pi;
            else if (lane == 24) arg = starter_ph * two_pi;
            else if (lane == 25) arg = crack_ph * two_pi;
            else if (lane == 26) arg = wrap01(crack_ph * 1.55f) * two_pi;
            else if (lane == 27) arg = thump_ph * two_pi;
            else arg = 0.0f;
            const float sv = sinf(arg);
            const int bin = (int)fminf(
                fmaxf(rintf(load_s * (float)(kBins - 1)), 0.0f),
                (float)(kBins - 1));
            float term = lane < kHarm ? s_harm[bin * kHarm + lane] * sv
                                      : 0.0f;
            for (int off = 16; off > 0; off >>= 1)
                term += __shfl_xor_sync(kFull, term, off);
            const float base = __shfl_sync(kFull, term, 0);
            const float starter_sin = __shfl_sync(kFull, sv, 24);
            const float crack_tone = __shfl_sync(kFull, sv, 25);
            const float crack_tone2 = __shfl_sync(kFull, sv, 26);
            const float thump = __shfl_sync(kFull, sv, 27);

            // Starter whine and the catch envelope.
            const float starter =
                t < 0.55f ? ((1.0f - t * st_slope) * 0.13f) * starter_sin
                          : 0.0f;
            const float catch_env = clamp01((t + -0.45f) * catch_rate);

            // Noise gain, burst voices, mix.
            const float drive =
                clamp01(fminf(fmaxf(s_in[3][j], 0.0f), 1.15f)) * 0.76f
                + 0.24f;
            const float hiss = (thr_s * 0.04f + 0.006f)
                               * (rpm_norm * 0.75f + 0.25f);
            const float crack = clamp01(s_in[4][j])
                * (((crack_tone * 0.06f + crack_tone2 * 0.03f) + hp * 0.03f)
                   + thump * 0.085f);
            const float amp = (((load_s * 0.3f + 0.05f) + thr_s * 0.15f)
                               + rpm_norm * 0.07f) * drive;
            const float noise_gain =
                (hiss + (thr_s * 0.02f) * (load_s * 0.7f + 0.3f)) * drive;
            float x = (amp * base + noise_gain * lp_y) + crack;
            if (t < 1.0f) x = (1.0f - catch_env) * starter + catch_env * x;
            const float grit = load_s * 1.05f + 0.62f;
            x = tanhf((x * grit) * 1.5f) * soft;

            // Output low-pass.
            const float main_a = __fmaf_rn(
                __fmaf_rn(load_s, 0.75f, 0.25f), 0.28f, 0.022f);
            main_y = __fmaf_rn(main_a, x - main_y, main_y);
            if (lane == 0) y[i] = main_y;
        }
    }
}

}  // namespace

extern "C" int lsr_engine_synth(const float* rpm, const float* thr,
                                const float* load, const float* tmul,
                                const float* burst, const float* noise,
                                const float* harm, const float* uni, float* y,
                                int n, cudaStream_t stream) {
    engine_synth_kernel<<<1, 32, 0, stream>>>(rpm, thr, load, tmul, burst,
                                              noise, harm, uni, y, n);
    return (int)cudaGetLastError();
}
