"""Each cell's control at the cell's own size, on the card: the
reference computed in the precision that renderbench/checks/<cell>.json
names under "control" (TF32 where it moves a frame, else the HDR image in
bfloat16), put in the program's place, comes out not correct on three
seeds' sampled frames, each run judged by the worse of its frames."""

import json
import os

import pytest
import torch

from renderbench import correct, harness, ref_side, scene, stats
from renderbench.conftest import require_card

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (4100000011, 4100000012, 4100000013)


def control_of(cell: str) -> str:
    with open(os.path.join(HERE, "checks", f"{cell}.json")) as f:
        return json.load(f)["control"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_names_a_precision(cell):
    assert control_of(cell) in ("tf32", *ref_side.CONTROL_HDR)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cell):
    require_card()
    spec = harness.cell_spec(BENCH, cell)
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device("cuda", 0)
    inputs = scene.scene_inputs(cfg)
    limits = correct.load_limits(cell)
    for seed in SEEDS:
        start = scene.first_camera(traffic, seed)
        ref = ref_side.Reference(cfg, traffic, inputs, start, dev)
        frames = stats.Reservoir(harness.CHECK_FRAMES, scene.rng_for(seed, 2))
        for k in range(12):
            frames.offer(k)
        nums = [correct.numbers(ref.frame_outputs(k, control=control_of(
            cell)), ref.frame_outputs(k)) for k in sorted(frames.items)]
        ok, checks = correct.judge(correct.worst(nums), limits, len(nums),
                                   len(nums))
        assert not ok, (seed, checks)
