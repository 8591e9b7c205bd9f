"""A run on the CPU at a tiny size with the timed path broken underneath
comes out not correct, once for each fault a frame of these cells can
have: a frame that returns its state unchanged (the first frame's image,
whatever the camera), half of the frame left out (its lower half never
written), half of the light set left out, and an answer altered where it
is produced (a block of pixels brightened).  One chip holds each cell, so
no exchange between chips can be left out."""

import dataclasses

import pytest
import torch

from renderbench import port_side
from renderbench.test_rb_result import drive

CELL = "paths_720p.ssao"


def stale(call):
    def broken(self, index):
        out = call(self, index)
        if not hasattr(self, "first_out"):
            self.first_out = out
        return self.first_out
    return broken


def half_image(call):
    def broken(self, index):
        out = dict(call(self, index))
        ldr = out["ldr"].clone()
        ldr[ldr.shape[0] // 2:] = 0
        out["ldr"] = ldr
        return out
    return broken


def altered(call):
    def broken(self, index):
        out = dict(call(self, index))
        ldr = out["ldr"].clone()
        ldr[:16, :16] = torch.clamp(ldr[:16, :16].to(torch.int32) + 8,
                                    max=255).to(ldr.dtype)
        out["ldr"] = ldr
        return out
    return broken


def half_lights(call):
    def broken(self, index):
        lights = self.base["lights"]
        keep = torch.arange(lights.count) < lights.count // 2
        self.base["lights"] = dataclasses.replace(
            lights, enabled=lights.enabled & keep)
        try:
            return call(self, index)
        finally:
            self.base["lights"] = lights
    return broken


@pytest.mark.parametrize("fault", [stale, half_image, half_lights, altered])
def test_a_broken_frame_is_not_correct(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(port_side.Program, "call",
                        fault(port_side.Program.call))
    res = drive(tmp_path, CELL)
    assert res["correct"] is False and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_the_unbroken_run_is_correct(tmp_path):
    assert drive(tmp_path, CELL)["correct"] is True
