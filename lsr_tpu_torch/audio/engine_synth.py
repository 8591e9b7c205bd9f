"""Engine-sound synthesizer (port of lsr_tpu/audio/engine_synth.py; parity:
hello-other-exps/hello_engine_synth.cpp).

A "W16" engine voice: a firing-order fundamental with load-scaled jitter, a
24-harmonic stack weighted by a load-binned table, throttle-coloured noise
and its first difference, gear-shift crack and thump bursts, a starter
whine crossfaded out in the first second, softclip drive and a one-pole
output low-pass.  lsr_tpu runs the voice as one jitted lax.scan over the
samples; here CUDA tensors launch kernel S1 (csrc/engine_synth.cu), whose
warps run the recurrences serially beside sample-parallel output warps,
and CPU tensors run its plain version, synthesize_plain.

Both compute what lsr_tpu's compiled scan computes, in float32, operation
for operation.  XLA:CPU rewrites the step before it runs it: a division by
a constant becomes a product with the float32 reciprocal, products of
constants are folded (160 + 120 * (t / 0.55) becomes t * 218.18181 + 160),
and LLVM fuses a multiply whose only use is an add into one fused
multiply-add.  The fused ones that feed the carried state (the smoothers,
the four phase accumulators and their increments, the two one-pole
filters) are written here as fused multiply-adds (core.math3d.fma, float64
rounded to odd; __fmaf_rn in the kernel); without them the phases drift
from lsr_tpu's by float32 ulps after the throttle opens.  Every other
product and sum rounds on its own.  What still differs from lsr_tpu is
output-only: XLA's own sine and tanh polynomials and its order of the
harmonic sum (here a fixed pairwise tree over 32 slots, the kernel's too).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from lsr_tpu_torch.core.image import resize_bilinear
from lsr_tpu_torch.core.math3d import fma
from lsr_tpu_torch.core.util import device_const, resolve_device
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

H_HARMONICS = 24
LOAD_BINS = 8
SMOOTH = 0.02        # parameter smoothers (Smooth a=0.02)
BUTTERFLY = 32       # slots of the harmonic sum's pairwise tree


@dataclasses.dataclass(frozen=True)
class EngineControls:
    """Per-sample control tracks, each (N,) float32 on one device."""
    rpm: torch.Tensor
    throttle: torch.Tensor
    load: torch.Tensor
    torque_mul: torch.Tensor
    shift_burst: torch.Tensor


def harmonic_table(h: int = H_HARMONICS, bins: int = LOAD_BINS,
                   device=None) -> torch.Tensor:
    """(bins, h) load-binned harmonic weights, built in numpy exactly as
    lsr_tpu builds them (a re-tuned variant of the reference's harmW:
    brightness rises with load, the rolloff exponent falls, odd harmonics
    boosted, rows normalized to unit sum), then moved to `device`."""
    k = np.arange(1, h + 1, dtype=np.float32)
    rows = []
    for b in range(bins):
        load = b / float(bins - 1)
        bright = 0.18 + 0.70 * load
        expo = 1.25 + 2.60 * (1.0 - bright)
        w = 1.0 / np.power(k, expo)
        w *= np.where(k % 2 == 1, 1.0 + 0.35 * bright, 1.0)
        rows.append(w / w.sum())
    return torch.as_tensor(np.stack(rows).astype(np.float32),
                           device=resolve_device(device))


def step_constants(sample_rate: int, cylinders: int) -> list[float]:
    """The float32 constants of the compiled step, in the kernel's order:
    dt, the starter whine's slope (120 / 0.55), the starter envelope's
    slope (0.35 / 0.55), the catch rate (1 / 0.40), the fundamental's
    scale (1/60 * cylinders/2 * 0.5), 1 / 7000, 1 / tanh(1.5) and 2 pi,
    each folded in float32 as XLA folds it."""
    f = np.float32
    r055 = f(1) / f(0.55)
    return [float(v) for v in (
        f(1.0 / float(sample_rate)), f(120) * r055, f(0.35) * r055,
        f(1) / f(0.40), f(f(f(1) / f(60)) * f(0.5 * cylinders)) * f(0.5),
        f(1) / f(7000), f(1) / f(np.tanh(1.5)), f(2 * np.pi))]


def _columns(controls: EngineControls, noise):
    cols = (controls.rpm, controls.throttle, controls.load,
            controls.torque_mul, controls.shift_burst, noise)
    n = noise.shape[0]
    for name, c in zip(("rpm", "throttle", "load", "torque_mul",
                        "shift_burst", "noise"), cols):
        if (c.dtype != torch.float32 or c.shape != (n,)
                or c.device != noise.device):
            raise ValueError(f"synthesize: {name} must be ({n},) float32 on "
                             f"{noise.device}, got {tuple(c.shape)} "
                             f"{c.dtype} on {c.device}")
    return cols


def _wrap01(x):
    return x - torch.floor(x)


def _butterfly_sum(terms):
    """Sum over the last axis of 24 in the order of lane 0 of the kernel's
    xor butterfly (offsets 16, 8, 4, 2, 1 over 32 lanes, lanes 24-31 zero)."""
    pad = BUTTERFLY - terms.shape[-1]
    s = torch.nn.functional.pad(terms, (0, pad))
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = s[..., :half] + s[..., half:]
    return s[..., 0]


def synthesize_plain(controls: EngineControls, noise,
                     sample_rate: int = 48000, cylinders: int = 16):
    """The plain PyTorch version of synthesize, on the tensors' device.

    The loops carry only the recurrences (the three smoothers; the four
    phase accumulators with the noise low-pass; the output low-pass).
    Every other value of the step is computed for all samples at once with
    the same float32 operations, which round the same per element."""
    rpm, thr, load, tmul, burst, nz = _columns(controls, noise)
    dev, n = nz.device, nz.shape[0]
    (dt, wh_slope, st_slope, catch_rate, f0_scale, r7000, soft,
     two_pi) = step_constants(sample_rate, cylinders)
    t = torch.arange(n, dtype=torch.float32, device=dev) * dt
    one = lambda v: device_const(v, dev)  # noqa: E731

    # Parameter smoothers: x_s = clip(fma(x_in - x_s, 0.02, x_s), 0, 1)
    # (rpm unclipped).
    smooth = torch.empty((n, 3), dtype=torch.float32, device=dev)
    s = one([900.0, 0.0, 0.0])
    lo, hi = one([-np.inf, 0.0, 0.0]), one([np.inf, 1.0, 1.0])
    k_smooth = one(SMOOTH)
    for i, x in enumerate(torch.stack([rpm, thr, load], 1).unbind(0)):
        s = torch.clamp(fma(x - s, k_smooth, s), lo, hi)
        smooth[i] = s
    rpm_s, thr_s, load_s = smooth.unbind(1)

    # The increments of phase, crack, thump and starter, and the noise
    # low-pass's coefficient.
    c = lambda v: torch.full_like(t, v)  # noqa: E731
    rpm_norm = torch.clamp(rpm_s * r7000, max=1.0)
    crack_hz = fma(rpm_norm, c(350.0), fma(thr_s, c(550.0), c(900.0)))
    thump_hz = fma(rpm_norm, c(20.0), fma(thr_s, c(40.0), c(90.0)))
    jitter = fma(fma(load_s, c(0.0025), c(0.001)), nz, c(1.0))
    f0 = (rpm_s * f0_scale) * jitter
    whine = fma(t, c(wh_slope), c(160.0))
    lp_a = fma(thr_s, c(0.14), c(0.025))

    # phase, crack, thump, starter: wrap01(fma(inc, dt, ph)); the noise
    # low-pass: fma(lp_a, n - lp_y, lp_y).  One fma over the five lanes.
    a5 = torch.stack([f0, crack_hz, thump_hz, whine, lp_a], 1)
    b5 = torch.stack([c(dt), c(dt), c(dt), c(dt), nz], 1)
    lp_lane = one([0.0, 0.0, 0.0, 0.0, 1.0])
    wrap_lanes = 1.0 - lp_lane
    acc = torch.empty((n, 5), dtype=torch.float32, device=dev)
    s = one([0.0] * 5)
    for i, (a, b) in enumerate(zip(a5.unbind(0), b5.unbind(0))):
        s = fma(a, b - s * lp_lane, s)
        s = s - torch.floor(s) * wrap_lanes
        acc[i] = s
    phase, crack_ph, thump_ph, starter_ph, lp_y = acc.unbind(1)
    hp = lp_y - torch.cat([lp_y.new_zeros(1), lp_y[:-1]])

    # Starter whine and the catch envelope of the first second.
    starter = torch.where(
        t < 0.55, ((1.0 - t * st_slope) * 0.13)
        * torch.sin(starter_ph * two_pi), c(0.0))
    catch = torch.clamp((t + -0.45) * catch_rate, 0.0, 1.0)

    # The load-binned harmonic stack.
    bin_i = torch.clamp(torch.round(load_s * (LOAD_BINS - 1)), 0,
                        LOAD_BINS - 1).long()
    w = harmonic_table(device=dev)[bin_i]
    ks = torch.arange(1, H_HARMONICS + 1, dtype=torch.float32, device=dev)
    base = _butterfly_sum(w * torch.sin(_wrap01(phase[:, None] * ks)
                                        * two_pi))

    # Noise gain, burst voices, mix.
    drive = torch.clamp(torch.clamp(tmul, 0.0, 1.15), 0.0, 1.0) * 0.76 \
        + 0.24
    hiss = (thr_s * 0.04 + 0.006) * (rpm_norm * 0.75 + 0.25)
    crack_tone = torch.sin(crack_ph * two_pi)
    crack_tone2 = torch.sin(_wrap01(crack_ph * 1.55) * two_pi)
    thump = torch.sin(thump_ph * two_pi)
    crack = torch.clamp(burst, 0.0, 1.0) * (
        ((crack_tone * 0.06 + crack_tone2 * 0.03) + hp * 0.03)
        + thump * 0.085)
    amp = (((load_s * 0.3 + 0.05) + thr_s * 0.15) + rpm_norm * 0.07) * drive
    noise_gain = (hiss + (thr_s * 0.02) * (load_s * 0.7 + 0.3)) * drive
    x_out = (amp * base + noise_gain * lp_y) + crack
    x_out = torch.where(t < 1.0, (1.0 - catch) * starter + catch * x_out,
                        x_out)
    grit = load_s * 1.05 + 0.62
    x_out = torch.tanh((x_out * grit) * 1.5) * soft

    # Output low-pass: main_y = fma(main_a, x - main_y, main_y).
    main_a = fma(fma(load_s, c(0.75), c(0.25)), c(0.28), c(0.022))
    y = torch.empty_like(t)
    m = one([0.0])
    for i, (a, x) in enumerate(zip(main_a.unbind(0), x_out.unbind(0))):
        m = fma(a, x - m, m)
        y[i] = m[0]
    return y


@functools.lru_cache(maxsize=None)
def _launch_tables(dev, sample_rate, cylinders):
    """The harmonic table and the step constants on the card, made once for
    each (device, rate, cylinders): S1's launches then copy nothing."""
    return (harmonic_table(device=dev),
            device_const(step_constants(sample_rate, cylinders), dev))


def _synth_launch(lib, cols, harm, uni, stream):
    """Launch kernel S1 through the C interface; returns y (N,)."""
    noise = cols[-1]
    y = torch.empty_like(noise)
    err = lib.lsr_engine_synth(*(c.data_ptr() for c in cols),
                               harm.data_ptr(), uni.data_ptr(), y.data_ptr(),
                               noise.shape[0], stream)
    check_launch("lsr_engine_synth", err)
    return y


def synthesize(controls: EngineControls, noise, sample_rate: int = 48000,
               cylinders: int = 16):
    """Render the engine voice for N samples.  noise: (N,) uniform [-1, 1].
    Returns (N,) float32 in [-1, 1] on the tensors' device.  CPU tensors
    run synthesize_plain; CUDA tensors launch kernel S1 once, or raise."""
    cols = _columns(controls, noise)
    dev = noise.device
    if dev.type == "cpu":
        return synthesize_plain(controls, noise, sample_rate, cylinders)
    if dev.type != "cuda":
        raise ValueError(f"synthesize: unsupported device {dev}")
    cols = tuple(c.contiguous() for c in cols)
    harm, uni = _launch_tables(dev, sample_rate, cylinders)
    y = _synth_launch(load_kernels(), cols, harm, uni,
                      torch.cuda.current_stream(dev).cuda_stream)
    synthesize.launches += 1
    return y


synthesize.launches = 0


def drive_cycle(seconds: float = 6.0, sample_rate: int = 48000,
                seed: int = 0, device=None):
    """A scripted idle -> full-throttle -> upshift x2 -> lift-off run (the
    headless stand-in for the reference's keyboard vehicle sim): returns
    (EngineControls, noise) on `device`.  The control tracks are lsr_tpu's
    numpy arithmetic; the noise comes from a torch.Generator seeded with
    `seed` on the device, a stream of its own (not JAX's threefry)."""
    dev = resolve_device(device)
    n = int(seconds * sample_rate)
    t = np.arange(n, dtype=np.float32) / sample_rate

    thr = np.clip((t - 0.8) / 0.4, 0.0, 1.0) * (t < seconds - 1.2) \
        + np.clip(1.0 - (t - (seconds - 1.2)) / 0.8, 0.0, 1.0) \
        * (t >= seconds - 1.2)
    thr = np.clip(thr, 0.0, 1.0).astype(np.float32)

    # RPM ramps per gear with instant drops at upshifts.
    rpm = np.full(n, 900.0, np.float32)
    shift_burst = np.zeros(n, np.float32)
    shifts = [2.6, 4.2]
    seg_start = 0.8
    base_rpm = 900.0
    for s_end in shifts + [seconds]:
        seg = (t >= seg_start) & (t < s_end)
        u = (t[seg] - seg_start) / max(s_end - seg_start, 1e-3)
        rpm[seg] = base_rpm + (6800.0 - base_rpm) * np.clip(u, 0, 1)
        if s_end in shifts:
            burst = np.exp(-np.clip(t - s_end, 0, None) / 0.12) \
                * (t >= s_end)
            shift_burst = np.maximum(shift_burst, burst.astype(np.float32))
            base_rpm = 3800.0
            seg_start = s_end
    rpm[t < 0.8] = 900.0
    lift = t >= seconds - 1.2
    rpm[lift] = np.maximum(900.0, rpm[lift] - (t[lift] - (seconds - 1.2))
                           * 4000.0)

    load = (thr * 0.8 + 0.2 * np.clip(rpm / 6800.0, 0, 1)).astype(np.float32)
    torque_mul = (0.3 + 0.7 * thr).astype(np.float32)

    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.rand(n, generator=gen, device=dev) * 2.0 - 1.0
    up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    controls = EngineControls(rpm=up(rpm), throttle=up(thr), load=up(load),
                              torque_mul=up(torque_mul),
                              shift_burst=up(shift_burst))
    return controls, noise


def spectrum_image(samples, sample_rate: int = 48000, width: int = 512,
                   height: int = 256, fmax: float = 4000.0, device=None):
    """Spectrogram image, (height, width, 3) uint8 on the host (numpy): the
    analog of the reference's FFT visualizer.  Column j is |rfft| of a
    Hann window of 2048 samples from j * hop; log amplitude over 60 dB,
    resized bilinearly (jax.image.resize semantics), three-ramp colormap.
    Runs on the samples' device (`device` for a numpy array)."""
    if not torch.is_tensor(samples):
        samples = torch.as_tensor(np.array(samples, np.float32),
                                  device=resolve_device(device))
    x = samples.to(torch.float32)
    win = 2048
    hop = max(1, (x.shape[0] - win) // width)
    # lax.dynamic_slice clamps a start so that the window fits.
    starts = torch.clamp(torch.arange(width, device=x.device) * hop,
                         max=max(x.shape[0] - win, 0))
    seg = x[starts[:, None] + torch.arange(win, device=x.device)]
    hann = torch.as_tensor(np.hanning(win).astype(np.float32),
                           device=x.device)
    mags = torch.abs(torch.fft.rfft(seg * hann))       # (width, win//2+1)
    n_bins = int(fmax / sample_rate * win)
    db = 20.0 * torch.log10(torch.clamp(mags[:, :n_bins], min=1e-6))
    db = torch.clamp((db + 60.0) / 60.0, 0.0, 1.0)
    img = resize_bilinear(db.T.flip(0).contiguous(), (height, width))
    rgb = torch.stack([torch.clamp(img * 3.0 - k, 0, 1) for k in range(3)],
                      -1)
    return torch.round(rgb * 255).to(torch.uint8).cpu().numpy()
