"""Where kernel S1's time goes on the card (csrc/engine_synth.cu): each
stage's busy cycles a sample, and variants of its design timed against it.

Each variant is a patched copy of engine_synth.cu built into its own library
under build/ (git-ignored); nothing of it is kept in the package.  The first
is the shipped kernel; the others each undo one choice of its design.  Every
variant is built twice: as it is, to time it, and with its barrier waits
timed by clock64 (a profiled copy), to split each warp's cycles into
waiting and busy.  The input is hello_engine_synth's whole voice (6 s at 48
kHz); every variant's output must equal the shipped kernel's bit for bit.

    python -m lsr_tpu_torch.utils.s1_stages

Prints the card and SM clock, each variant's registers / spilled bytes /
stack (`-Xptxas -v`), kernel ms (median over rounds in alternating order)
and cycles a sample at the SM's maximum clock, and, per role, the busy
cycles a sample of its warps (the most of them): the stage that never waits
sets the pace.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess

import torch

from lsr_tpu_torch.audio import engine_synth as es
from lsr_tpu_torch.utils import cuda_build

SRC = "engine_synth.cu"
ROLES = ("noise", "rpm", "low-pass", "level", "feed", "phases", "load",
         "output", "idle")

# name -> the (old, new) replacements made in engine_synth.cu.  The first
# is the shipped kernel.
VARIANTS = {
    "shipped": (),
    "every chunk wraps its phases with floorf": (
        ("if (lane < 4 && r.fast_wrap)", "if (false)"),),
    "one output group (8 output warps, 512 threads)": (
        ("constexpr int kOutGroups = 2;", "constexpr int kOutGroups = 1;"),
        ("constexpr int kThreads = 1024;", "constexpr int kThreads = 512;")),
    "warps in role order (no scheduler layout, 736 threads)": (
        ("""    if (warp % 4 >= 2) return kOutput;
    const int id = warp / 4 * 2 + warp % 4;
    return id < kOutput ? static_cast<Role>(id) : kIdle;""",
         """    return warp < kOutput ? static_cast<Role>(warp)
         : warp < kOutput + kOutWarps ? kOutput : kIdle;"""),
        ("    return warp / 4 * 2 + warp % 4 - 2;",
         "    return warp - kOutput;"),
        ("constexpr int kThreads = 1024;", "constexpr int kThreads = 736;"),
        ("static_assert(2 * kOutWarps == kThreads / 32,",
         "static_assert(true,")),
}

# The profiled copy: each wait's cycles and each warp's whole run, by warp.
PROFILE = (
    ("""    if (bar_try_wait(b, parity)) return;
    const unsigned long long t0 = now_ns();
    while (!bar_try_wait(b, parity))
        if (now_ns() - t0 > kWaitLimitNs) __trap();""",
     """    const long long c0 = clock64();
    while (!bar_try_wait(b, parity)) {}
    if (threadIdx.x % 32 == 0)
        atomicAdd(&g_wait[threadIdx.x / 32],
                  (unsigned long long)(clock64() - c0));"""),
    ("__device__ __forceinline__ void bar_wait(",
     "__device__ unsigned long long g_wait[32], g_total[32], g_role[32];\n"
     "__device__ __forceinline__ void bar_wait("),
    ("    const int chunks = (g.n + kChunk - 1) / kChunk;",
     "    const long long start = clock64();\n"
     "    const int chunks = (g.n + kChunk - 1) / kChunk;"),
    ("        case kIdle: break;\n    }",
     "        case kIdle: break;\n    }\n"
     "    if (lane == 0) {\n"
     "        g_total[warp] = clock64() - start;\n"
     "        g_role[warp] = role_of(warp);\n    }"),
    ("}  // namespace", """}  // namespace

extern "C" int s1_stages_read(unsigned long long* out) {
    cudaMemcpyFromSymbol(out, g_wait, 256);
    cudaMemcpyFromSymbol(out + 32, g_total, 256);
    cudaMemcpyFromSymbol(out + 64, g_role, 256);
    const unsigned long long zero[32] = {};
    cudaMemcpyToSymbol(g_wait, zero, 256);
    return (int)cudaMemcpyToSymbol(g_total, zero, 256);
}"""),
)


def _patched(patches):
    with open(os.path.join(cuda_build.CSRC, SRC)) as f:
        src = f.read()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"s1_stages: {old!r} not in {SRC}")
        src = src.replace(old, new)
    return src


def _build_all(builds):
    """{tag: (lib, ptxas resources)}, one nvcc per build, all at once."""
    d = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "s1_stages")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    procs = {}
    for i, (tag, src) in enumerate(builds.items()):
        cu, so = os.path.join(d, f"v{i}.cu"), os.path.join(d, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[tag] = so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    out = {}
    for tag, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"s1_stages: nvcc failed for {tag}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.lsr_engine_synth.argtypes = list(
            cuda_build.SIGNATURES["lsr_engine_synth"])
        lib.lsr_engine_synth.restype = ctypes.c_int
        if tag.endswith("[profiled]"):
            lib.s1_stages_read.argtypes = [ctypes.c_void_p]
            lib.s1_stages_read.restype = ctypes.c_int
        res = cuda_build.kernel_resources(f"== {SRC}\n{log}")[SRC][0]
        out[tag] = lib, {k: res[k] for k in
                         ("registers", "spill_bytes", "stack_bytes")}
    return out


def _launch(lib, args):
    return es._synth_launch(lib, *args)


def _ms(fn):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def _busy(lib, args, n):
    """{role: the largest busy cycles a sample of its warps}."""
    buf = (ctypes.c_ulonglong * 96)()
    lib.s1_stages_read(buf)
    _launch(lib, args)
    torch.cuda.synchronize()
    lib.s1_stages_read(buf)
    busy = {}
    for w in range(32):
        wait, total, role = buf[w], buf[32 + w], ROLES[buf[64 + w]]
        if total and role != "idle":
            busy[role] = max(busy.get(role, 0.0), (total - wait) / n)
    return {r: round(v, 2) for r, v in busy.items()}


def main(rounds=6):
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip()
    mhz = float(card.split(",")[-1])
    print(card, flush=True)
    builds = {}
    for name, patches in VARIANTS.items():
        builds[name] = _patched(patches)
        builds[f"{name} [profiled]"] = _patched(patches + PROFILE)
    libs = _build_all(builds)
    controls, noise = es.drive_cycle(6.0, 48000, 0, device=dev)
    args = ((controls.rpm, controls.throttle, controls.load,
             controls.torque_mul, controls.shift_burst, noise),
            es.harmonic_table(device=dev),
            torch.tensor(es.step_constants(48000, 16), device=dev),
            torch.cuda.current_stream(dev).cuda_stream)
    n = noise.shape[0]
    names = list(VARIANTS)
    ref = _launch(libs[names[0]][0], args)
    for tag, (lib, _) in libs.items():
        if not torch.equal(_launch(lib, args).view(torch.int32),
                           ref.view(torch.int32)):
            raise RuntimeError(f"s1_stages: {tag} differs from the shipped "
                               f"kernel")
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(_ms(lambda: _launch(libs[name][0], args)))
    for name in names:
        ms = statistics.median(times[name][1:])
        print(f"{name}: {libs[name][1]}, kernel {ms:.4f} ms (all "
              f"{[round(t, 4) for t in times[name]]}), "
              f"{ms * mhz * 1e3 / n:.2f} cycles a sample at {mhz:.0f} MHz; "
              f"busy cycles a sample by role "
              f"{_busy(libs[f'{name} [profiled]'][0], args, n)}", flush=True)


if __name__ == "__main__":
    main()
