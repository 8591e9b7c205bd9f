"""The readings that the limits of renderbench/checks/<cell>.json are set
from, on the card: the program against the plain reference on many seeds,
and the controls (the reference in a lower precision) against the
reference on some of them, in one process.

    python3 renderbench/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--controls tf32 bf16_hdr] \
        [--frames 12] [--out build/readings.jsonl]

Per seed it does what a run does (set-up, frames_in_flight frames in
flight, the same seeded sample of harness.CHECK_FRAMES frames, the same
comparison), over a window of --frames frames in place of --seconds, and
writes one JSON line: the seed, each sampled frame's numbers and, for a
control seed, each control's numbers at the same frames.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=["tf32", "bf16_hdr"])
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "readings.jsonl"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from renderbench import harness, scene, stats
    from renderbench.port_side import load_library

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = harness.cell_spec(bench, args.workload)
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["precision"]["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["precision"]["tf32"])
    load_library()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog, inputs, start, ordinal = harness.set_up(cfg, traffic, seed,
                                                      dev, {})
        sample = stats.Reservoir(harness.CHECK_FRAMES,
                                 scene.rng_for(seed, 2))
        win = harness.Window(
            prog, traffic, start, ordinal, int(traffic["frames_in_flight"]),
            lambda k, out: sample.offer((k, prog.compared(out))), dev)
        for _ in range(args.frames):
            win.frame()
        torch.cuda.synchronize(dev)
        kept = sorted(sample.items, key=lambda it: it[0])
        del prog, win, sample
        gc.collect()
        torch.cuda.empty_cache()
        controls = args.controls if seed in args.control_seeds else ()
        res = harness.compare(cfg, traffic, inputs, start, kept, dev,
                              controls)
        line = {"workload": args.workload, "seed": seed,
                "frames": [k for k, _ in kept], "program": res[0],
                "seconds": time.perf_counter() - t0}
        if controls:
            line["controls"] = res[3]
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        del kept, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
