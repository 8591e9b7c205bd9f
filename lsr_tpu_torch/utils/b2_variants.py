"""Time variants of the light kernels, above all B2 (csrc/shade_fused.cu),
against each other on the card, in one process.

Each variant is a patched copy of csrc/ built into its own library under
build/ (git-ignored); nothing of it is kept in the package.  A variant is
a list of text replacements in csrc/: a B2 variant turns off one of the
choices of the light walk or of shade_fused.cu (the box test, the vote,
the planeless copy, a copy of the light math per light kind) or changes
its register bound; a B5 or B6 variant patches that kernel's source or
the light walk they share.  B2's inputs are the launches it gets
on three frames at 1920x1080: the cut flagship frame (no cull, no atlas:
planeless), bench.py's ESM default (with local-shadow planes, and the same
records without them) and the high-poly frame (planeless); B5's the cut
frame's resolve route (chunk 8); B6's the cut frame's G-buffer at 64x128
tiles (chunk 16) and 16x128 (chunk 8).  Each variant is timed on its own
kernel's inputs beside the shipped library, and its output must equal the
shipped kernel's bit for bit.

    python -m lsr_tpu_torch.utils.b2_variants [--parent DIR]

--parent DIR adds the library built from another csrc/ directory (say the
parent commit's, unpacked with `git archive` into a git-ignored directory),
timed on every input; its outputs must be equal too.

Prints the card, each variant's registers / spilled bytes (`-Xptxas -v`)
and, per input, each variant's kernel ms over rounds in alternating order.
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import subprocess

import torch

from lsr_tpu_torch.utils import cuda_build

B2 = "shade_fused.cu"
WALK = "light_walk.cuh"

# Each warp keeps every light of the group (no box test) / shades every
# light it keeps (no vote).
_BOX = (WALK, "near = light_near_box(load_box_rec(f), box);", "near = true;")
_VOTE = (WALK, "return __any_sync(kFullMask, may) || L.zero_ok == 0.0f;",
         "return true;")
_BOUND = "__launch_bounds__(kWalkThreads, 4)"

# name -> (the kernel whose inputs time it, the (file, old, new)
# replacements made in csrc/).  The first is the shipped library.
VARIANTS = {
    "shipped: box test, vote, planeless copy, copy per kind, (256, 4)": (
        "B2", ()),
    "no box test (votes only)": ("B2", (_BOX,)),
    "no vote (box test only)": ("B2", (_VOTE,)),
    "neither": ("B2", (_BOX, _VOTE)),
    "one kernel for both (no planeless copy)": (
        "B2", ((B2, "n_shadowed ? shade_fused_kernel<true> "
                ": shade_fused_kernel<false>;", "shade_fused_kernel<true>;"),)),
    "one generic copy of the light math": (
        "B2", ((B2, "lsr::light_terms_of_kind<kPlanes>(",
                "lsr::light_terms<kPlanes, 0>("),)),
    "(256, 3)": (
        "B2", ((B2, _BOUND, "__launch_bounds__(kWalkThreads, 3)"),)),
    "no register bound": (
        "B2", ((B2, _BOUND, "__launch_bounds__(kWalkThreads)"),)),
    "B5: uncovered warps test no record": (
        "B5", ((WALK,
                "      near = !finite_color(f[13], f[14], f[15]);",
                "      near = false;"),)),
    "B6: (256, 3)": (
        "B6", (("fplus_accumulate.cu", "__launch_bounds__(kWalkThreads, 4)",
                "__launch_bounds__(kWalkThreads, 3)"),)),
    "B6: no register bound": (
        "B6", (("fplus_accumulate.cu", "__launch_bounds__(kWalkThreads, 4)",
                "__launch_bounds__(kWalkThreads)"),)),
    "B6: one generic copy of the light math": (
        "B6", (("fplus_accumulate.cu", "lsr::light_terms_of_kind<false>(",
                "lsr::light_terms<false, 0>("),)),
}


def _build(i, src_dir, patches):
    d = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), f"b2_variant_{i}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    for name, old, new in patches:
        p = os.path.join(d, name)
        with open(p) as f:
            src = f.read()
        if old not in src:
            raise RuntimeError(f"b2_variants: {old!r} not in {name}")
        with open(p, "w") as f:
            f.write(src.replace(old, new))
    keep = cuda_build.CSRC
    cuda_build.CSRC, cuda_build._lib = d, None
    try:
        lib = cuda_build.load_kernels()
    finally:
        cuda_build.CSRC, cuda_build._lib = keep, None
    res = cuda_build.kernel_resources(cuda_build.build_info["log"])
    return lib, {src: [(r["registers"], r["spill_bytes"]) for r in fns]
                 for src, fns in res.items()
                 if src in ("shade_fused.cu", "resolve_fused.cu",
                            "fplus_accumulate.cu")}


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


def _capture(module, name, seen):
    """Wrap module.name so that each call's (args, kwargs) lands in seen;
    returns the original."""
    launch = getattr(module, name)

    def capture(*a, **k):
        seen.append((a, k))
        return launch(*a, **k)

    setattr(module, name, capture)
    return launch


def _inputs(dev, width, height):
    """{tag: (launch, args, kwargs)} of the B2 launches of the three
    frames and of B5 and B6 on the cut frame; each tag starts with its
    kernel's name."""
    from lsr_tpu_torch.frame import (bench_config, build_flagship_scene,
                                     flagship_camera, flagship_stages)
    from lsr_tpu_torch.highpoly import (
        build_highpoly_scene, highpoly_camera, highpoly_frame_params,
        make_highpoly_frame)
    from lsr_tpu_torch.lighting import fplus_kernel as fk
    from lsr_tpu_torch.lighting import resolve_kernel as rk
    from lsr_tpu_torch.lighting import shade_kernel as sk
    from lsr_tpu_torch.lighting.local_shadows import plan_shadow_casters

    seen = {"b2": [], "b5": [], "b6": []}
    originals = {"b2": (sk, "_shade_launch"), "b5": (rk, "_resolve_launch"),
                 "b6": (fk, "_accumulate_launch")}
    launch = {k: _capture(m, n, seen[k]) for k, (m, n) in originals.items()}
    out = {}
    try:
        geom, objects, lights, ctx = build_flagship_scene(256, 42, device=dev)
        cam, ctx_t = flagship_camera(0, ctx, width, height, device=dev)
        st = flagship_stages(geom, objects, lights, ctx, cam, ctx_t, width,
                             height, with_cull=False, with_local=False)
        out["B2, cut frame, planeless"] = (launch["b2"],) + seen["b2"][-1]
        flagship_stages(geom, objects, lights, ctx, cam, ctx_t, width, height,
                        with_cull=False, with_local=False, use_resolve=True)
        out["B5, cut frame, chunk 8"] = (launch["b5"],) + seen["b5"][-1]
        for tile_h, cap, chunk in ((64, 256, 16), (16, 64, 8)):
            fk.accumulate_lights(
                st["gb"].world_pos, st["gb"].normal_ws, st["gb"].covered,
                ctx_t.camera_pos, lights, cam.view, cam.proj, width, height,
                tile_h, 128, cap, chunk)
            out[f"B6, cut frame's G-buffer, {tile_h}x128, chunk {chunk}"] = \
                (launch["b6"],) + seen["b6"][-1]
        flagship_stages(geom, objects, lights, ctx, cam, ctx_t, width, height,
                        casters=plan_shadow_casters(lights),
                        **bench_config("esm", width, height))
        a, k = seen["b2"][-1]
        out["B2, ESM default, planes"] = (launch["b2"], a, k)
        # The same records launched without planes (lane 28 cleared, as
        # the records of a frame without them).
        rec = a[2].clone()
        rec[..., 28] = 0.0
        out["B2, ESM default, planeless"] = (launch["b2"],
                                             a[:2] + (rec,) + a[3:10], {})
        del geom, objects, st
        hg, ho, hl, hc = build_highpoly_scene(33, device=dev)
        hcam, hctx = highpoly_camera(hc, width, height, 33, device=dev)
        make_highpoly_frame(hg, ho, hl, hc,
                            highpoly_frame_params(width, height))(hcam, hctx)
        out["B2, high-poly frame, planeless"] = (launch["b2"],) \
            + seen["b2"][-1]
    finally:
        for key, (m, n) in originals.items():
            setattr(m, n, launch[key])
    torch.cuda.synchronize()
    return out


def main(width=1920, height=1080, rounds=4):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another csrc/ directory to time "
                    "against the shipped kernels")
    opts = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = [(n, kernel, cuda_build.CSRC, p)
              for n, (kernel, p) in VARIANTS.items()]
    if opts.parent:
        builds.append(("parent", None, os.path.abspath(opts.parent), ()))
    libs, kernels = {}, {}
    for i, (name, kernel, src_dir, patches) in enumerate(builds):
        libs[name], res = _build(i, src_dir, patches)
        kernels[name] = kernel
        print(f"{name}: registers / spilled bytes {res}", flush=True)
    shipped = next(iter(VARIANTS))
    for tag, (launch, a, k) in _inputs(dev, width, height).items():
        names = [n for n in libs if n == shipped or kernels[n] is None
                 or tag.startswith(kernels[n])]
        runs = {n: (lambda lib=libs[n]: launch(lib, *a[1:], **k))
                for n in names}
        outs = {n: f() for n, f in runs.items()}
        torch.cuda.synchronize()

        def bits(o):
            return [t.view(torch.int32) for t in
                    (o if isinstance(o, tuple) else (o,))]

        ref = bits(outs[shipped])
        same = all(all(torch.equal(x, y) for x, y in zip(bits(o), ref))
                   for o in outs.values())
        t = {n: [] for n in runs}
        for r in range(rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                t[n].append(_ms(runs[n]))
        print(f"{tag}: outputs equal bit for bit {same}", flush=True)
        for n, v in t.items():
            print(f"  {n}: median {statistics.median(v):.4f} ms, all "
                  f"{[round(x, 4) for x in v]}", flush=True)
        if not same:
            raise RuntimeError(f"b2_variants: a variant differs on {tag}")


if __name__ == "__main__":
    main()
