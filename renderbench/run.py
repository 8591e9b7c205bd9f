"""Run one cell of lsr_tpu_torch's benchmark once and print its result.

    python3 renderbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding BENCHMARK.json, renderbench/ and the
port (lsr_tpu_torch/) on a machine with a CUDA card.  The last line of
standard output is one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, with --trace 1 breakdown, and last checks (each compared number
beside its limit, which the last lines of standard error repeat).

Exits non-zero with no result where there is no CUDA card or fewer than
the cell asks for, where the port is missing, and where jax, jaxlib,
flax or lsr_tpu is loaded at the end of the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def process_age_s() -> float:
    """Seconds since this process started, from /proc (10 ms steps)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])     # field 22 of stat(5)
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


T_START = time.perf_counter() - process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Every cache of the program and of its libraries lives at a fixed path
    # inside the checkout.
    build = os.path.join(ROOT, "build")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)
    sys.path.insert(0, ROOT)
    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"unknown workload {args.workload!r}")
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no CUDA card for {args.workload} (it needs {chips}; "
            f"available: {torch.cuda.is_available()}, count: "
            f"{torch.cuda.device_count()})")
        return 2
    from renderbench import harness

    result = harness.run(args, T_START)
    found = harness.banned_modules()
    if found:
        log(f"modules loaded that the benchmark must not load: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
