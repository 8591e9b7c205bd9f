"""HelloEngineSynth: engine-sound synthesis, headless (port of
demos/hello_engine_synth.py; parity: hello-other-exps/hello_engine_synth.cpp).

A scripted 6 s drive cycle at 48 kHz (idle, full throttle, two upshifts,
lift-off) renders the engine voice through audio/engine_synth.synthesize
(kernel S1 on the card, one launch) and writes out/torch_hello_engine_synth
.wav (the audio, normalized to a 0.9 peak) and out/torch_hello_engine_synth
_spectrum.png (the visualizer frame)."""

from __future__ import annotations

import os

import numpy as np

from lsr_tpu_torch.audio.engine_synth import (
    drive_cycle, spectrum_image, synthesize)
from lsr_tpu_torch.demos.common import parser, setup_device
from lsr_tpu_torch.io.png import write_png
from lsr_tpu_torch.io.wav import write_wav

RATE = 48000
SECONDS = 6.0


def render(device=None, seconds: float | None = None, rate: int = RATE,
           seed: int = 0):
    """The drive cycle's voice (SECONDS long by default), (N,) float32 on
    the device."""
    controls, noise = drive_cycle(SECONDS if seconds is None else seconds,
                                  rate, seed, device=device)
    return synthesize(controls, noise, sample_rate=rate)


def main(argv=None):
    args = parser(__doc__, None, None, mesh=False).parse_args(argv)
    y = render(setup_device(args.device))
    y_host = y.cpu().numpy()
    peak = float(np.abs(y_host).max())
    rms = float(np.sqrt(np.mean(y_host ** 2)))
    print(f"rendered {y_host.shape[0]} samples  peak={peak:.3f}  "
          f"rms={rms:.3f}")

    os.makedirs(args.out, exist_ok=True)
    wav_path = os.path.join(args.out, "torch_hello_engine_synth.wav")
    write_wav(wav_path, y_host / max(peak, 1e-6) * 0.9, RATE)
    print("wrote", wav_path)

    png_path = os.path.join(args.out, "torch_hello_engine_synth_spectrum.png")
    write_png(png_path, spectrum_image(y, RATE))
    print("wrote", png_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
