"""The engine synth and WAV IO through lsr_tpu_torch against lsr_tpu (CPU):
audio/engine_synth (synthesize's plain version, the harmonic table, the
drive cycle's control tracks, the spectrogram), io/wav and the demo
hello_engine_synth.

The parity runs carry lsr_tpu's controls and noise into the port.  The
port's plain version follows lsr_tpu's compiled scan, including the fused
multiply-adds that XLA:CPU makes of its carried state, so the two agree to
float32 rounding in the output alone (XLA's own sine and tanh, its order
of the harmonic sum): measured 3.0e-8 over 0.5 s and 1.8e-7 over 3 s at
12 kHz.  The bounds are 2e-7 and 5e-7.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu.audio import engine_synth as jsynth
from lsr_tpu.io import wav as jwav
from lsr_tpu_torch.audio import engine_synth as tsynth
from lsr_tpu_torch.io import wav as twav
from lsr_tpu_torch.utils import s1_stages

FIELDS = ("rpm", "throttle", "load", "torque_mul", "shift_burst")


def _port_controls(controls):
    """lsr_tpu's EngineControls as the port's, on the CPU."""
    return tsynth.EngineControls(*(
        torch.tensor(np.asarray(getattr(controls, f))) for f in FIELDS))


def _both(controls, noise, rate):
    """(lsr_tpu's jitted voice, the port's on the CPU), numpy."""
    ref = np.asarray(jsynth.synthesize(controls, noise, sample_rate=rate))
    got = tsynth.synthesize(_port_controls(controls),
                            torch.tensor(np.asarray(noise)),
                            sample_rate=rate).numpy()
    return ref, got


def test_synthesize_matches_jax_short():
    """0.5 s at 12 kHz of the drive cycle (the starter and its catch),
    lsr_tpu's noise carried in."""
    rate = 12000
    controls, noise = jsynth.drive_cycle(seconds=0.5, sample_rate=rate)
    ref, got = _both(controls, noise, rate)
    assert got.dtype == np.float32 and got.shape == (6000,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7)


def test_synthesize_matches_jax_past_throttle():
    """1.5 s at 12 kHz: 18,000 samples, past the throttle's opening at
    0.8 s where the phases of an unfused step drift from lsr_tpu's.  Every
    sample within 5e-7; peak and RMS within 1e-4 relative; PCM16 within
    one LSB."""
    rate = 12000
    controls, noise = jsynth.drive_cycle(seconds=1.5, sample_rate=rate)
    ref, got = _both(controls, noise, rate)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-7)
    peak_r, peak_g = np.abs(ref).max(), np.abs(got).max()
    rms_r = np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    rms_g = np.sqrt(np.mean(got.astype(np.float64) ** 2))
    assert abs(peak_g - peak_r) <= 1e-4 * peak_r
    assert abs(rms_g - rms_r) <= 1e-4 * rms_r
    pcm = lambda x: np.round(x * 32767.0).astype(np.int32)  # noqa: E731
    assert np.abs(pcm(got) - pcm(ref)).max() <= 1


@pytest.mark.parametrize("n", [1, 255, 257, 769])
def test_synthesize_matches_jax_chunk_edges(n):
    """Clips of n samples at 48 kHz, either side of the 256-sample chunks
    that kernel S1's stages hand over (csrc/engine_synth.cu): the port's
    voice on the CPU within 2e-7 of lsr_tpu's, lsr_tpu's noise carried in.
    chip_smoke.py holds S1 bit for bit against this plain version on the
    same lengths on the card."""
    rate = 48000
    controls, noise = jsynth.drive_cycle(seconds=0.02, sample_rate=rate)
    clip = jsynth.EngineControls(*(getattr(controls, f)[:n] for f in FIELDS))
    ref, got = _both(clip, noise[:n], rate)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7)


@pytest.mark.parametrize("variant", list(s1_stages.VARIANTS))
def test_s1_stages_patches_apply(variant):
    """Each variant of utils/s1_stages (and its profiled copy) is a set of
    text patches of csrc/engine_synth.cu; every patch still finds its
    text, so the tool builds what its name says."""
    patches = s1_stages.VARIANTS[variant]
    for p in (patches, patches + s1_stages.PROFILE):
        src = s1_stages._patched(p)
        assert "engine_synth_kernel" in src


@pytest.mark.parametrize("rpm", [1800.0, 3600.0])
def test_fundamental_tracks_rpm(rpm):
    """lsr_tpu's check: the dominant partial sits within 6 Hz of f0 = rpm /
    60 * cylinders / 2 * 0.5, here at 6 kHz (10,800 samples), with the
    voice equal to lsr_tpu's at that rate."""
    rate = 6000
    n = int(1.8 * rate)
    full = lambda v: jnp.full((n,), v, jnp.float32)  # noqa: E731
    controls = jsynth.EngineControls(
        rpm=full(rpm), throttle=full(0.5), load=full(0.5),
        torque_mul=full(0.8), shift_burst=full(0.0))
    ref, y = _both(controls, jnp.zeros((n,), jnp.float32), rate)
    np.testing.assert_allclose(y, ref, rtol=0, atol=5e-7)
    seg = y[int(1.2 * rate):]
    mag = np.abs(np.fft.rfft(seg * np.hanning(seg.shape[0])))
    freqs = np.fft.rfftfreq(seg.shape[0], 1.0 / rate)
    f0 = rpm / 60.0 * 8.0 * 0.5
    assert abs(freqs[np.argmax(mag)] - f0) < 6.0


def test_harmonic_table_equals_jax():
    got = tsynth.harmonic_table(device="cpu")
    assert got.dtype == torch.float32 and got.shape == (8, 24)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsynth.harmonic_table()))


@pytest.mark.parametrize("seconds,rate", [(6.0, 8000), (1.5, 12000)])
def test_drive_cycle_tracks_equal_jax(seconds, rate):
    """The control tracks equal lsr_tpu's exactly; the noise (the port's
    own torch.Generator stream) lies in [-1, 1] and repeats for one seed."""
    jc, _ = jsynth.drive_cycle(seconds, rate, seed=3)
    tc, noise = tsynth.drive_cycle(seconds, rate, seed=3, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    n = int(seconds * rate)
    assert noise.shape == (n,) and noise.dtype == torch.float32
    assert float(noise.min()) >= -1.0 and float(noise.max()) <= 1.0
    _, again = tsynth.drive_cycle(seconds, rate, seed=3, device="cpu")
    _, other = tsynth.drive_cycle(seconds, rate, seed=4, device="cpu")
    assert torch.equal(noise, again) and not torch.equal(noise, other)


@pytest.mark.parametrize("rate,size", [(48000, (256, 512)),
                                       (12000, (64, 128))])
def test_spectrum_image_matches_jax(rate, size):
    """On lsr_tpu's own 1 s voice: u8 within 1 LSB everywhere (rfft and
    log10 round differently), the same shape.  At 48 kHz the frequency
    axis is upsampled (170 bins to 256 rows); at 12 kHz both axes are
    downsampled (682 bins, 512 columns)."""
    controls, noise = jsynth.drive_cycle(seconds=1.0, sample_rate=rate)
    y = np.asarray(jsynth.synthesize(controls, noise, sample_rate=rate))
    h, w = size
    ref = jsynth.spectrum_image(y, rate, width=w, height=h)
    got = tsynth.spectrum_image(torch.tensor(y), rate, width=w, height=h)
    assert got.shape == ref.shape == (h, w, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_synthesize_rejects_mismatched_tracks():
    controls, noise = tsynth.drive_cycle(0.01, 8000, device="cpu")
    short = tsynth.EngineControls(
        rpm=controls.rpm[:-1], throttle=controls.throttle,
        load=controls.load, torque_mul=controls.torque_mul,
        shift_burst=controls.shift_burst)
    with pytest.raises(ValueError, match="rpm"):
        tsynth.synthesize(short, noise)
    with pytest.raises(ValueError, match="noise"):
        tsynth.synthesize(controls, noise.double())


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_bytes_equal_jax(tmp_path, channels):
    """Both writers give the same bytes; each reader gives the other's
    arrays on the other package's file."""
    rng = np.random.default_rng(channels)
    x = rng.uniform(-1.2, 1.2, (4000, channels)).astype(np.float32)
    if channels == 1:
        x = x[:, 0]
    jp, tp = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    jwav.write_wav(jp, x, 22050)
    twav.write_wav(tp, x, 22050)
    with open(jp, "rb") as fj, open(tp, "rb") as ft:
        assert fj.read() == ft.read()
    (yj, rj), (yt, rt) = jwav.read_wav(tp), twav.read_wav(jp)
    assert rj == rt == 22050 and yt.shape == (4000, channels)
    np.testing.assert_array_equal(yt, yj)


def test_hello_engine_synth_main(tmp_path, monkeypatch, capsys):
    """The demo's main() on the CPU with its drive cycle cut to 0.1 s (4,800
    samples at 48 kHz): both files written, the WAV reads back as the voice
    normalized to a 0.9 peak, the spectrogram (256, 512, 3)."""
    from lsr_tpu_torch.demos import hello_engine_synth as demo
    from lsr_tpu_torch.io.png import read_png

    monkeypatch.setattr(demo, "SECONDS", 0.1)
    assert demo.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    assert "rendered 4800 samples" in capsys.readouterr().out
    y = demo.render("cpu", seconds=0.1).numpy()
    x, rate = twav.read_wav(str(tmp_path / "torch_hello_engine_synth.wav"))
    assert rate == 48000 and x.shape == (4800, 1)
    want = np.round(y / np.abs(y).max() * 0.9 * 32767.0) / 32767.0
    np.testing.assert_allclose(x[:, 0], want, rtol=0, atol=1e-7)
    png = read_png(str(tmp_path / "torch_hello_engine_synth_spectrum.png"))
    assert png.shape == (256, 512, 3) and png.max() > 32



def voice_gap(seconds: float, rate: int = 12000, fused: bool = True):
    """Max |port - lsr_tpu| over the drive cycle's first `seconds`, the
    port's plain version with its fused multiply-adds (fused=False: each
    rounded twice, as a plain float32 loop of lsr_tpu's source would)."""
    controls, noise = jsynth.drive_cycle(seconds=seconds, sample_rate=rate)
    saved = tsynth.fma
    if not fused:
        tsynth.fma = lambda a, b, c: a * b + c
    try:
        ref, got = _both(controls, noise, rate)
    finally:
        tsynth.fma = saved
    return float(np.abs(got - ref).max())


if __name__ == "__main__":
    # The gaps ROADMAP C21 cites (from the repository root):
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_audio.py
    for fused in (True, False):
        for seconds in (0.5, 3.0):
            print(f"fused={fused} {seconds} s at 12 kHz: max gap "
                  f"{voice_gap(seconds, fused=fused):.3g}")
