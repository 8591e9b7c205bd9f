"""Phase F / G / I harness runner over the render-path presets (port of
scripts/run_phases.py: main and make_run_id; its builders are
render_paths.py's).

    python -m lsr_tpu_torch.run_phases [--device cuda|cpu] [--out-dir DIR]

The analog of hello_rendering_paths' harness phases, configured by
lsr_tpu's environment variables with lsr_tpu's defaults:

- Phase I (:389-414): each preset planned and run at LSR_PHASE_W x
  LSR_PHASE_H (320x180) through the PluggablePipeline on both raster
  backends, the CUDA kernel route (use_tiled_raster=True, kernel B1) and
  the torch rasterize_brute route (False), 2 warm-up and 6 hashed frames
  each; then per-preset technique stats (I_stats) and whether the SSAO
  composition changes the image.  The hash match is data, as in lsr_tpu:
  stray sliver pixels (ROADMAP C8) can make it false.
- Phase I-posts: the same for every post stack of POST_STACK_PRESETS (3
  hashed frames), and how many distinct images each path's stacks give.
- Phase F (:290-353): LSR_PHASE_F_WARMUP (90) + LSR_PHASE_F_SAMPLES (180)
  frames per preset at LSR_PHASE_F_W x LSR_PHASE_F_H (1280x720), plus
  forward_plus under the full post stack, net of the sync floor
  (harness.measure_sync_floor); then each pass's device ms by
  execute_segmented, the mean and standard error of 3 runs (F_pass rows).
- Phase G (:355-387, :1754): a soak of LSR_PHASE_G_SECONDS (180) cycling
  the presets every 240 frames at the Phase I size, perturbed between the
  FXAA and the empty post stack, judged against lsr_tpu's acceptance
  thresholds.

LSR_PHASE_{I,I_POSTS,F,G}=0 skip a phase; LSR_PHASE_PRESETS (a comma
list) filters the presets; LSR_PHASE_FILTER picks "pcf" (default) or
"esm"; LSR_PHASE_F_FULLSTACK=0 drops forward_plus+full and
LSR_PHASE_F_PASSES=0 the F_pass rows.  LSR_PHASE_GOLDENS is read and
ignored: lsr_tpu's goldens gate compiles its Mosaic kernels for the TPU,
and here chip_smoke.py holds each CUDA kernel against its plain version.

Every run writes a stamped header row ({"phase": "header", "run_id", ...})
per file and stamps each data row with the same run_id; rows are appended
to DIR/torch_phase_{i_backend_parity,i_post_stacks,f_metrics,
g_soak}.jsonl (DIR: artifacts by default).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.pipeline.executor import RenderContext
from lsr_tpu_torch.pipeline.recipe import POST_STACK_PRESETS
from lsr_tpu_torch.render_paths import (
    build_forward_plus_full,
    build_preset_pipelines,
)
from lsr_tpu_torch.utils.devtime import probe
from lsr_tpu_torch.utils.harness import (
    SoakAcceptance,
    measure_sync_floor,
    run_backend_parity,
    run_benchmark,
    run_soak,
    write_jsonl,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASS_REPS = 3            # execute_segmented runs per F_pass row


def make_run_id() -> str:
    """A timestamp and the checkout's short revision ("nogit" without
    one)."""
    stamp = time.strftime("%Y%m%dT%H%M%S")
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, cwd=REPO,
                             timeout=30).stdout.strip() or "nogit"
    except Exception:
        rev = "nogit"
    return f"{stamp}-{rev}"


def _on(env, key):
    """A phase switch: on unless set to anything but "1"."""
    return env.get(key, "1") == "1"


def _segmented_pass_ms(pipe, fp, state, reps=PASS_REPS):
    """({pass: mean device ms}, {pass: standard error}) over `reps` runs of
    execute_segmented (lsr_tpu's per-pass slope timing keeps the same
    pair)."""
    runs = []
    for _ in range(reps):
        ctx = RenderContext()
        pipe.execute_segmented(ctx, state, fp)
        runs.append(ctx.debug.pass_ms)
    mean, err = {}, {}
    for k in runs[0]:
        v = [r[k] for r in runs]
        m = sum(v) / len(v)
        var = sum((x - m) ** 2 for x in v) / max(1, len(v) - 1)
        mean[k], err[k] = m, (var / len(v)) ** 0.5
    return mean, err


def phase_i(env, presets, filt, floor_ms, run_id, out_dir, device, log):
    w = int(env.get("LSR_PHASE_W", "320"))
    h = int(env.get("LSR_PHASE_H", "180"))
    path = os.path.join(out_dir, "torch_phase_i_backend_parity.jsonl")
    # Reduced local-map sizes, the same on both backends (lsr_tpu's).
    kw = dict(local_map=256, local_point=128, shadow_filter=filt,
              device=device)
    tiled, tiled_pipes = build_preset_pipelines(
        w, h, presets, use_tiled=True, with_pipes=True, **kw)
    brute = build_preset_pipelines(w, h, presets, use_tiled=False, **kw)
    comps = {name: {"cuda_tiled": tiled[name], "torch_brute": brute[name]}
             for name in tiled}
    write_jsonl(path, [{
        "phase": "header", "run_id": run_id, "w": w, "h": h, "filter": filt,
        "floor_ms": round(floor_ms, 2), "presets": sorted(comps)}])
    res = run_backend_parity(comps, warmup=2, samples=6, run_id=run_id,
                             jsonl_path=path)
    for name, r in res.items():
        log(f"phase I {name}: match={r['match']}")
    out = {"I": res}
    if "forward_classic" in res and "forward_classic+ssao" in res:
        # The SSAO composition must change the image.
        h0 = res["forward_classic"]["hashes"]["cuda_tiled"][-1]
        h1 = res["forward_classic+ssao"]["hashes"]["cuda_tiled"][-1]
        write_jsonl(path, [{"phase": "I_ssao_differs", "run_id": run_id,
                            "differs": h0 != h1}])
        log(f"phase I ssao hash differs from classic: {h0 != h1}")
        out["ssao_differs"] = h0 != h1
    # Per-preset technique stats: the numbers that legitimately differ
    # across presets whose images agree.
    stats = {}
    for name, (pipe, fp, state_fn) in tiled_pipes.items():
        st = pipe.execute_jitted(RenderContext(), state_fn(0), fp)
        row = {"phase": "I_stats", "composition": name, "run_id": run_id}
        grid = st.get("light_grid")
        if grid is not None:
            counts = grid["counts"].cpu().numpy()
            row["max_lights_per_bin"] = int(grid["max_count"])
            row["overflow_bins"] = int(grid["overflow_bins"])
            row["binned_light_total"] = int(counts.sum())
            row["bins"] = int(counts.size)
            row["bin_occupancy"] = round(float((counts > 0).mean()), 4)
            row["cluster_slices"] = int(grid.get("slices", 1))
        if st.get("setup") is not None:
            row["tri_raster"] = int(st["setup"].valid.sum())
        if st.get("ssao_mask") is not None:
            row["ssao_mask_mean"] = round(float(st["ssao_mask"].mean()), 4)
        write_jsonl(path, [row])
        stats[name] = row
        log(f"phase I stats {name}: " + ", ".join(
            f"{k}={v}" for k, v in row.items()
            if k not in ("phase", "composition", "run_id")))
    out["I_stats"] = stats
    return out


def phase_i_posts(env, presets, filt, floor_ms, run_id, out_dir, device,
                  log):
    w = int(env.get("LSR_PHASE_W", "320"))
    h = int(env.get("LSR_PHASE_H", "180"))
    path = os.path.join(out_dir, "torch_phase_i_post_stacks.jsonl")
    write_jsonl(path, [{
        "phase": "header", "run_id": run_id, "w": w, "h": h, "filter": filt,
        "floor_ms": round(floor_ms, 2), "stacks": sorted(POST_STACK_PRESETS)}])
    kw = dict(local_map=256, local_point=128, shadow_filter=filt,
              device=device)
    comps = {}
    for sname, stack in POST_STACK_PRESETS.items():
        tiled = build_preset_pipelines(w, h, presets, post=stack,
                                       use_tiled=True, **kw)
        brute = build_preset_pipelines(w, h, presets, post=stack,
                                       use_tiled=False, **kw)
        for name in tiled:
            comps[f"{name}+{sname}"] = {"cuda_tiled": tiled[name],
                                        "torch_brute": brute[name]}
    res = run_backend_parity(comps, warmup=2, samples=3, run_id=run_id,
                             jsonl_path=path)
    # Distinct post stacks must produce distinct images per path.
    by_path = {}
    for full_name, r in res.items():
        name, sname = full_name.rsplit("+", 1)
        by_path.setdefault(name, {})[sname] = r["hashes"]["cuda_tiled"][-1]
        log(f"phase I-posts {full_name}: match={r['match']}")
    distinct = {}
    for name, hs in by_path.items():
        distinct[name] = (len(set(hs.values())), len(hs))
        log(f"phase I-posts {name}: {distinct[name][0]}/{len(hs)} distinct "
            f"stack hashes")
    return {"I_posts": res, "I_posts_distinct": distinct}


def phase_f(env, presets, filt, floor_ms, run_id, out_dir, device, log):
    w = int(env.get("LSR_PHASE_F_W", "1280"))
    h = int(env.get("LSR_PHASE_F_H", "720"))
    warmup = int(env.get("LSR_PHASE_F_WARMUP", "90"))
    samples = int(env.get("LSR_PHASE_F_SAMPLES", "180"))
    path = os.path.join(out_dir, "torch_phase_f_metrics.jsonl")
    comps, pipes = build_preset_pipelines(w, h, presets, use_tiled=True,
                                          shadow_filter=filt, device=device,
                                          with_pipes=True)
    # One flagship path also with the full post stack (compositions, not
    # only techniques).
    if _on(env, "LSR_PHASE_F_FULLSTACK") and (
            presets is None or "forward_plus" in presets):
        full_c, full_p = build_forward_plus_full(
            w, h, with_pipes=True, shadow_filter=filt, device=device)
        comps.update(full_c)
        pipes.update(full_p)
    write_jsonl(path, [{
        "phase": "header", "run_id": run_id, "w": w, "h": h, "filter": filt,
        "warmup": warmup, "samples": samples,
        "floor_ms": round(floor_ms, 2)}])
    results, passes = {}, {}
    for name, fn in comps.items():
        r = run_benchmark(name, fn, warmup=warmup, samples=samples,
                          meta={"w": w, "h": h, "run_id": run_id},
                          floor_ms=floor_ms, jsonl_path=path)
        results[name] = r
        log(f"phase F {name}: avg {r.ms_avg:.2f} ms "
            f"({1000.0 / max(r.ms_avg, 1e-6):.1f} fps)")
        if _on(env, "LSR_PHASE_F_PASSES"):
            pipe, fp, state_fn = pipes[name]
            ms, err = _segmented_pass_ms(pipe, fp, state_fn(0))
            row = {"phase": "F_pass", "composition": name, "run_id": run_id,
                   "pass_ms": {k: round(v, 2) for k, v in ms.items()},
                   "pass_ms_err": {k: round(v, 2) for k, v in err.items()}}
            write_jsonl(path, [row])
            passes[name] = row
            top = sorted(ms.items(), key=lambda kv: -kv[1])[:4]
            log("  top passes: " + ", ".join(f"{k} {v:.1f}ms"
                                             for k, v in top))
    return {"F": results, "F_pass": passes}


def phase_g(env, presets, filt, floor_ms, run_id, out_dir, device, log):
    w = int(env.get("LSR_PHASE_W", "320"))
    h = int(env.get("LSR_PHASE_H", "180"))
    secs = float(env.get("LSR_PHASE_G_SECONDS", "180"))
    path = os.path.join(out_dir, "torch_phase_g_soak.jsonl")
    # Perturbation variants (hello_rendering_paths.cpp:1754 toggle
    # stress): post-stack combos, cycled.
    variants = [
        build_preset_pipelines(w, h, presets, post=("fxaa",),
                               shadow_filter=filt, device=device),
        build_preset_pipelines(w, h, presets, post=(), shadow_filter=filt,
                               device=device),
    ]
    # Every variant runs once before the timed window: the soak measures
    # runtime stability under perturbation, not first-run costs.
    out = None
    for vs in variants:
        for fn in vs.values():
            out = fn(0)
    probe(out)
    cycle_state = {"v": 0}

    def perturb(cycle):
        cycle_state["v"] = cycle % len(variants)

    soak_comps = {}
    for name in variants[0]:
        def fn(i, name=name):
            return variants[cycle_state["v"]][name](i)
        soak_comps[name] = fn
    write_jsonl(path, [{
        "phase": "header", "run_id": run_id, "w": w, "h": h, "filter": filt,
        "seconds": secs, "variants": len(variants),
        "floor_ms": round(floor_ms, 2)}])
    rep = run_soak(soak_comps, duration_s=secs, frames_per_cycle=240,
                   acceptance=SoakAcceptance(max_avg_frame_ms=50.0),
                   perturb=perturb, run_id=run_id, floor_ms=floor_ms,
                   jsonl_path=path, device=device)
    log(f"phase G: {rep}")
    return {"G": rep}


def run(env=None, device=None, out_dir: str = "artifacts", log=print):
    """Every phase the environment enables, on `device` (default: the
    card).  Returns {"run_id", "floor_ms", and each phase's results}."""
    env = os.environ if env is None else env
    device = resolve_device(device)
    run_id = make_run_id()
    filt = env.get("LSR_PHASE_FILTER", "pcf")
    presets = None
    if env.get("LSR_PHASE_PRESETS"):
        presets = set(env["LSR_PHASE_PRESETS"].split(","))
    floor_ms = measure_sync_floor(device=device)
    log(f"# run_id {run_id}  sync floor {floor_ms:.3f} ms/drain")
    if "LSR_PHASE_GOLDENS" in env:
        log("# LSR_PHASE_GOLDENS ignored: lsr_tpu's goldens gate compiles "
            "Mosaic kernels for the TPU; chip_smoke.py holds each CUDA "
            "kernel against its plain version")
    out = {"run_id": run_id, "floor_ms": floor_ms}
    args = (env, presets, filt, floor_ms, run_id, out_dir, device, log)
    for key, fn in (("LSR_PHASE_I", phase_i),
                    ("LSR_PHASE_I_POSTS", phase_i_posts),
                    ("LSR_PHASE_F", phase_f), ("LSR_PHASE_G", phase_g)):
        if _on(env, key):
            out.update(fn(*args))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--out-dir", default="artifacts",
                   help="directory of the JSONL rows")
    args = p.parse_args(argv)
    import torch

    if args.device is None or torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run(device=args.device, out_dir=args.out_dir,
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
