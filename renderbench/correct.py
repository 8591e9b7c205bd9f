"""How `correct` is decided: the frames the window produced, sampled from
the seed, against the plain reference's frames at the same cameras.

Per compared frame (the worst frame counts):
- ldr_diff_pct: the share (%) of the pixels of the tonemapped,
  anti-aliased 8-bit image with any channel unlike the reference's;
- ldr_over1_pct: the same, of the pixels off by more than 1;
- ldr_mean_abs: the mean absolute difference of its channel values, in
  units of the last bit;
- n_valid_gap, lights_per_bin_gap, overflow_bins_gap (the flagship frame):
  the absolute difference of the frame's setup count, its most lights in
  one bin and its overflowed bins from the reference's.
A cell's renderbench/checks/<cell>.json holds the numbers it is held to,
each with its limit and the readings the limit was set from; a run is
correct when every one of them is finite and within its limit and every
sampled frame was compared.  The others are logged.
"""

from __future__ import annotations

import json
import math
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

EXACT = {"n_valid": "n_valid_gap", "max_lights_per_bin": "lights_per_bin_gap",
         "overflow_bins": "overflow_bins_gap"}


def numbers(got: dict, ref: dict) -> dict:
    """The compared numbers of one frame: got (the program's outputs) and
    ref (the reference's), with the same keys."""
    a = got["ldr"].to(torch.int32).cpu()
    b = ref["ldr"].to(torch.int32).cpu()
    if a.shape != b.shape:
        return {"ldr_diff_pct": math.inf, "ldr_over1_pct": math.inf,
                "ldr_mean_abs": math.inf}
    d = (a - b).abs()
    worst = d.amax(-1)
    out = {"ldr_diff_pct": 100.0 * float((worst > 0).to(torch.float64)
                                         .mean()),
           "ldr_over1_pct": 100.0 * float((worst > 1).to(torch.float64)
                                          .mean()),
           "ldr_mean_abs": float(d.to(torch.float64).mean())}
    for key, name in EXACT.items():
        if key in ref:
            out[name] = float(abs(int(got[key]) - int(ref[key])))
    return out


def worst(per_frame: list) -> dict:
    """Each number's largest reading over the compared frames."""
    out: dict = {}
    for nums in per_frame:
        for k, v in nums.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def load_limits(cell: str) -> dict:
    """{number: limit} of a cell (renderbench/checks/<cell>.json)."""
    with open(os.path.join(HERE, "checks", f"{cell}.json")) as f:
        spec = json.load(f)
    return {k: v["limit"] for k, v in spec["numbers"].items()}


def judge(readings: dict, limits: dict, expected_frames: int,
          compared_frames: int) -> tuple:
    """(correct, checks): checks maps each limited number to its reading
    and its limit; a number with no reading reads inf."""
    checks = {k: {"value": readings.get(k, math.inf), "limit": lim}
              for k, lim in limits.items()}
    ok = compared_frames == expected_frames and compared_frames > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
