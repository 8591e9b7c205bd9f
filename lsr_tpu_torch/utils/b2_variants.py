"""Time variants of kernel B2 (csrc/shade_fused.cu) against each other on
the card, in one process.

Each variant is a patched copy of csrc/ built into its own library under
build/ (git-ignored); nothing of it is kept in the package.  The inputs are
the launches B2 gets on three frames at 1920x1080: the cut flagship frame
(no cull, no atlas: planeless), bench.py's ESM default (with local-shadow
planes, and the same records without them) and the high-poly frame
(planeless).  Every variant's output must equal the shipped kernel's.

    python -m lsr_tpu_torch.utils.b2_variants

Prints the card, each variant's registers / spilled bytes (`-Xptxas -v`)
and, per input, each variant's kernel ms over rounds in alternating order.
"""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess

import torch

from lsr_tpu_torch.utils import cuda_build

_FORK = ("n_shadowed ? shade_fused_kernel<true> : shade_fused_kernel<false>",
         "shade_fused_kernel<true>")
_BOUND = ("__launch_bounds__(kBlockX * kBlockY, 4)",
          "__launch_bounds__(kBlockX * kBlockY)")

# name -> the (old, new) replacements made in shade_fused.cu.
VARIANTS = {
    "shipped: planeless copy, (256, 4)": (),
    "one kernel, (256, 4)": (_FORK,),
    "planeless copy, no bound": (_BOUND,),
    "one kernel, no bound": (_FORK, _BOUND),
}


def _build(i, patches):
    d = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), f"b2_variant_{i}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    p = os.path.join(d, "shade_fused.cu")
    with open(p) as f:
        src = f.read()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"b2_variants: {old!r} not in shade_fused.cu")
        src = src.replace(old, new)
    with open(p, "w") as f:
        f.write(src)
    keep = cuda_build.CSRC
    cuda_build.CSRC, cuda_build._lib = d, None
    try:
        lib = cuda_build.load_kernels()
    finally:
        cuda_build.CSRC, cuda_build._lib = keep, None
    res = cuda_build.kernel_resources(cuda_build.build_info["log"])
    return lib, [(r["registers"], r["spill_bytes"])
                 for r in res.get("shade_fused.cu", [])]


def _ms(fn, iters=30):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _inputs(dev, width, height):
    """{tag: (args, kwargs)} of the B2 launches of the three frames."""
    from lsr_tpu_torch.frame import (bench_config, build_flagship_scene,
                                     flagship_camera, flagship_stages)
    from lsr_tpu_torch.highpoly import (
        build_highpoly_scene, highpoly_camera, highpoly_frame_params,
        make_highpoly_frame)
    from lsr_tpu_torch.lighting import shade_kernel as sk
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters

    launch, seen = sk._shade_launch, []

    def capture(*a, **k):
        seen.append((a, k))
        return launch(*a, **k)

    sk._shade_launch = capture
    out = {}
    try:
        geom, objects, lights, ctx = build_flagship_scene(256, 42, device=dev)
        cam, ctx_t = flagship_camera(0, ctx, width, height, device=dev)
        flagship_stages(geom, objects, lights, ctx, cam, ctx_t, width, height,
                        with_cull=False, with_local=False)
        out["cut frame, planeless"] = seen[-1]
        flagship_stages(geom, objects, lights, ctx, cam, ctx_t, width, height,
                        casters=plan_shadow_casters(lights),
                        **bench_config("esm", width, height))
        a, k = seen[-1]
        out["ESM default, planes"] = (a, k)
        # The same records launched without planes (lane 28 cleared, as
        # the records of a frame without them).
        rec = a[2].clone()
        rec[..., 28] = 0.0
        out["ESM default, planeless"] = (a[:2] + (rec,) + a[3:10], {})
        del geom, objects
        hg, ho, hl, hc = build_highpoly_scene(33, device=dev)
        hcam, hctx = highpoly_camera(hc, width, height, 33, device=dev)
        make_highpoly_frame(hg, ho, hl, hc,
                            highpoly_frame_params(width, height))(hcam, hctx)
        out["high-poly frame, planeless"] = seen[-1]
    finally:
        sk._shade_launch = launch
    torch.cuda.synchronize()
    return out


def main(width=1920, height=1080, rounds=4):
    from lsr_tpu_torch.lighting import shade_kernel as sk

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        libs[name], res = _build(i, patches)
        print(f"{name}: registers / spilled bytes {res}", flush=True)
    for tag, (a, k) in _inputs(dev, width, height).items():
        runs = {n: (lambda lib=lib: sk._shade_launch(lib, *a[1:], **k))
                for n, lib in libs.items()}
        outs = {n: f() for n, f in runs.items()}
        torch.cuda.synchronize()
        ref = outs[next(iter(VARIANTS))]
        same = all(torch.equal(o, ref) for o in outs.values())
        t = {n: [] for n in runs}
        for r in range(rounds):
            for n in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                t[n].append(_ms(runs[n]))
        print(f"{tag}: outputs equal {same}", flush=True)
        for n, v in t.items():
            print(f"  {n}: median {statistics.median(v):.4f} ms, all "
                  f"{[round(x, 4) for x in v]}", flush=True)
        if not same:
            raise RuntimeError(f"b2_variants: a variant differs on {tag}")


if __name__ == "__main__":
    main()
