"""The plain reference (renderbench/reference, a frozen copy of the port's
plain route) against the port on the CPU at a tiny size, where the port
itself runs its kernels' plain versions: the same outputs bit for bit,
so on the card only the kernels can part them."""

import json
import os

import pytest
import torch

from renderbench import port_side, ref_side, scene
from renderbench.test_rb_result import tiny_bench

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("cell", ["flagship_1080p.orbit", "paths_720p.ssao"])
def test_reference_is_the_ports_plain_route(tmp_path, cell):
    bench = tiny_bench(tmp_path, cell)
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    cfg = json.load(open({c["name"]: c for c in bench["configs"]}[
        entry["config"]]["file"]))
    traffic = json.load(open(os.path.join(HERE, "traffic",
                                          f"{entry['traffic']}.json")))
    seed = 5 * 2**31 + 3
    inputs = scene.scene_inputs(cfg)
    start = scene.first_camera(traffic, seed)
    dev = torch.device("cpu")
    prog = port_side.Program(cfg, traffic, inputs, dev)
    outs = [prog.compared(prog.call(scene.camera_of(traffic, start, k)))
            for k in range(6)]
    ref = ref_side.Reference(cfg, traffic, inputs, start, dev)
    for k in (0, 5):
        want = ref.frame_outputs(k)
        assert set(want) == set(outs[k])
        for key, v in want.items():
            assert torch.equal(outs[k][key], v), (k, key)


@pytest.mark.parametrize("cell", ["flagship_1080p.orbit", "paths_720p.ssao"])
def test_the_control_is_not_correct(tmp_path, cell):
    """The reference with its HDR image held in bfloat16, put in the
    program's place: held to the cell's limits it is not correct at this
    tiny size.  TF32, which moves no pixel at this size, stays within
    them; each cell's control at its own size (TF32 for paths_720p.ssao,
    where it moves the frame) is test_rb_controls.py's, on the card."""
    from renderbench import correct

    bench = tiny_bench(tmp_path, cell)
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    cfg = json.load(open({c["name"]: c for c in bench["configs"]}[
        entry["config"]]["file"]))
    traffic = json.load(open(os.path.join(HERE, "traffic",
                                          f"{entry['traffic']}.json")))
    ref = ref_side.Reference(cfg, traffic, scene.scene_inputs(cfg), 0,
                             torch.device("cpu"))
    want = ref.frame_outputs(5)
    nums = correct.numbers(ref.frame_outputs(5, control="bf16_hdr"), want)
    ok, checks = correct.judge(nums, correct.load_limits(cell), 1, 1)
    assert not ok, checks
    assert correct.numbers(ref.frame_outputs(5, control="tf32"), want)[
        "ldr_mean_abs"] < correct.load_limits(cell)["ldr_mean_abs"]
