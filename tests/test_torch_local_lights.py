"""Kernel G1 (lighting/light_runtime.accumulate_local_lights,
csrc/local_lights.cu): the general lighting branch's binned local-light sum.

On the CPU (tier 1): the wrapper runs the plain version for CPU tensors and
raises on what the kernel does not take; the plain version is unchanged bit
for bit when every term G1 leaves out (light_walk.local_light_skips and
a plane that reads 0) is set to +0, and a rule 20% too eager is caught; the
launch counter is listed and named by the benchmark's kernel file.

On the card (marked `card`, skipped without one): PyTorch's sum and cross
orders that G1 follows; G1 against accumulate_local_lights_plain on the card
with torch.equal over the four light kinds, every list length, caps 64 and
128, chunks 8 and 16, with and without planes, tiled and clustered, a band
height that is not whole tiles; and a whole forward_classic+ssao frame
through execute_jitted, kernel against plain.  Run them on the card with
    python -m pytest tests/test_torch_local_lights.py -q -m card
"""

import json
import os

import numpy as np
import pytest
import torch

from lsr_tpu_torch.core.util import cdiv
from lsr_tpu_torch.lighting import light_runtime as lr
from lsr_tpu_torch.lighting import light_walk
from lsr_tpu_torch.lighting.light_types import lights_from_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 96, 64          # CPU frames
CW, CH = 256, 144      # card frames: 144 tiles of 16 px, lists of 0..cap


def require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def make_lights(n, seed):
    """n lights of the four local kinds, mixed attenuation models, powers
    and cutoffs, around the surface of make_gbuffer."""
    rng = np.random.default_rng(seed)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa: E731
    cols = {
        "type": 1 + np.arange(n) % 4,
        "position": rng.uniform([-4, 0.2, -3], [4, 2.5, 3], (n, 3)),
        "direction": unit(rng.normal(size=(n, 3)) + [0, -2, 0]),
        "up": rng.normal(size=(n, 3)),
        "axis": rng.normal(size=(n, 3)),
        "color": rng.uniform(0.2, 1.0, (n, 3)),
        "intensity": rng.uniform(0.5, 3.0, n),
        "range": rng.uniform(1.0, 5.0, n),
        "inner_angle": rng.uniform(0.1, 0.6, n),
        "outer_angle": rng.uniform(0.3, 1.2, n),
        "rect_half_extents": rng.uniform(0.02, 0.8, (n, 2)),
        "tube_half_length": rng.uniform(0.05, 1.0, n),
        "tube_radius": np.full(n, 0.1),
        "atten_model": rng.integers(0, 3, n),
        "atten_power": rng.choice([1.0, 0.5, 2.0, 3.7], n),
        "atten_bias": rng.choice([1e-4, 0.0, 0.05], n),
        "atten_cutoff": rng.choice([0.0, 0.0, 0.02, 0.3], n),
        "enabled": np.ones(n, bool),
    }
    cols["intensity"][::7] = 0.0       # zero radiance
    cols["range"][5::11] = 0.0         # masked out of tiled lists
    return cols


def make_gbuffer(w, h, device):
    """A wavy floor under the lights (world positions, unit normals), with
    a background band of zeros, and the camera."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = xs / w * 8.0 - 4.0
    z = ys / h * 6.0 - 3.0
    y = 0.3 * np.sin(1.7 * x) * np.cos(1.3 * z)
    pos = np.stack([x, y, z], -1)
    nrm = np.stack([-0.3 * 1.7 * np.cos(1.7 * x) * np.cos(1.3 * z),
                    np.ones_like(x),
                    0.3 * 1.3 * np.sin(1.7 * x) * np.sin(1.3 * z)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    bg = ys < h // 10
    pos[bg] = 0.0
    nrm[bg] = 0.0
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    return f(pos), f(nrm), f(np.array([0.5, 3.0, -5.0]))


def make_lists(rows, cap, n_lights, seed, device):
    """-1-padded lists, row r of length r % (cap + 1): every length from 0
    to cap, light ids in random order, a few -1 holes inside a list."""
    rng = np.random.default_rng(seed)
    lists = np.full((rows, cap), -1, np.int64)
    for r in range(rows):
        k = r % (cap + 1)
        lists[r, :k] = rng.choice(n_lights, k, replace=k > n_lights)
        if k > 4 and r % 5 == 0:
            lists[r, rng.integers(0, k)] = -1
    return torch.as_tensor(lists, device=device)


def make_planes(w, h, n_lights, k, seed, device):
    """(H, W, k + 1) planes as a view of (k + 1, H, W), the layout
    local_shadow_vis_stack returns, plane k the constant 1; many texels
    exactly 0 or 1; each light's plane index."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.5, 1.5, (k + 1, h, w)).clip(0.0, 1.0)
    v[k] = 1.0
    planes = torch.as_tensor(v.astype(np.float32), device=device)
    sidx = torch.as_tensor(rng.integers(0, k + 1, n_lights), device=device)
    return planes.permute(1, 2, 0), sidx


def case_args(device, w, h, cap, chunk, planes, slices, n_lights=48,
              seed=3):
    """accumulate_local_lights' arguments for one case."""
    pos, nrm, cam = make_gbuffer(w, h, device)
    lights = lights_from_numpy(make_lights(n_lights, seed), device)
    rows = cdiv(w, 16) * cdiv(h, 16) * slices
    kw = dict(tile_size=16, chunk=chunk)
    if slices > 1:
        rng = np.random.default_rng(seed + 1)
        kw.update(cluster_of_pixel=torch.as_tensor(
            rng.integers(0, slices, (h, w)), device=device), slices=slices)
    if planes:
        vis, sidx = make_planes(w, h, n_lights, 6, seed + 2, device)
        kw.update(shadow_vis_stack=vis, light_shadow_index=sidx)
    lists = make_lists(rows, cap, n_lights, seed + 3, device)
    return (pos, nrm, cam, lights, lists, w, h), kw


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planes,slices", [(True, 1), (False, 1), (True, 4)])
def test_cpu_tensors_run_the_plain_version(planes, slices):
    args, kw = case_args("cpu", W, H, 32, 8, planes, slices)
    before = lr.accumulate_local_lights.launches
    d, s = lr.accumulate_local_lights(*args, **kw)
    dp, sp = lr.accumulate_local_lights_plain(*args, **kw)
    assert lr.accumulate_local_lights.launches == before
    assert torch.equal(d, dp) and torch.equal(s, sp)
    assert d.shape == (H, W, 3) and float(d.sum()) > 0.0


def _bad(args, kw, case):
    """One argument set the kernel does not take."""
    pos, nrm, cam, lights, lists, w, h = args
    if case == "chunk_0":
        kw["chunk"] = 0
    elif case == "chunk_64":
        kw["chunk"] = 64
    elif case == "tile_0":
        kw["tile_size"] = 0
    elif case == "gbuffer_f64":
        pos = pos.double()
    elif case == "gbuffer_shape":
        nrm = nrm[:-1]
    elif case == "camera_shape":
        cam = cam[None]
    elif case == "list_rows":
        lists = lists[:-1]
    elif case == "list_float":
        lists = lists.float()
    elif case == "planes_without_index":
        kw["light_shadow_index"] = None
    elif case == "planes_shape":
        kw["shadow_vis_stack"] = kw["shadow_vis_stack"][:, :-1]
    elif case == "cluster_shape":
        kw.update(cluster_of_pixel=torch.zeros((h, w + 1), dtype=torch.int64),
                  slices=2)
    elif case == "no_lights":
        lights = lights_from_numpy(
            {k: v[:0] for k, v in make_lights(4, 0).items()}, "cpu")
    return (pos, nrm, cam, lights, lists, w, h), kw


BAD = ["chunk_0", "chunk_64", "tile_0", "gbuffer_f64", "gbuffer_shape",
       "camera_shape", "list_rows", "list_float", "planes_without_index",
       "planes_shape", "cluster_shape", "no_lights"]


@pytest.mark.parametrize("case", BAD)
def test_kernel_refuses_what_it_does_not_take(case):
    """The CUDA route's checks (host metadata only), run on CPU tensors."""
    args, kw = case_args("cpu", W, H, 32, 8, True, 1)
    good = dict(cluster_of_pixel=None, slices=1, **kw)
    lr._kernel_args(*args, **good)
    args, bad = _bad(args, dict(good), case)
    with pytest.raises(ValueError, match="accumulate_local_lights"):
        lr._kernel_args(*args, **bad)


def test_meta_tensors_raise():
    args, kw = case_args("cpu", W, H, 32, 8, False, 1)
    meta = (args[0].to("meta"),) + args[1:]
    with pytest.raises(ValueError, match="unsupported device"):
        lr.accumulate_local_lights(*meta, **kw)


def _walked(monkeypatch, args, kw, eager=False):
    """The plain version as it is, and with every term G1 leaves out set to
    +0 before the chunk sums (local_light_skips, and a bounded pair whose
    plane reads 0); the share of pairs left out.  eager: a rule that also
    leaves out pairs beyond 80% of the range."""
    d, s = lr.accumulate_local_lights_plain(*args, **kw)
    evaluate, shadowed = lr.eval_local_lights, lr._shadowed
    seen = {"pairs": 0, "left": 0}

    def terms(cols, wp, n, v):
        dd, ss = evaluate(cols, wp, n, v)
        skip, bounded = light_walk.local_light_skips(cols, wp, n)
        if eager:
            p = wp[..., None, :]
            dist = torch.sqrt(((cols["position"] - p) ** 2).sum(-1))
            skip = skip | (bounded & (dist > 0.8 * cols["range"]))
        seen["bounded"] = bounded
        seen["pairs"] += skip.numel()
        seen["left"] += int(skip.sum())
        zero = torch.zeros((), dtype=dd.dtype)
        return (torch.where(skip[..., None], zero, dd),
                torch.where(skip[..., None], zero, ss))

    def planes(dd, ss, vis_t, sidx):
        dd, ss = shadowed(dd, ss, vis_t, sidx)
        t, px = vis_t.shape[:2]
        if sidx.ndim == 2:
            sidx = sidx[:, None, :].expand(t, px, sidx.shape[1])
        dark = seen["bounded"] & (torch.gather(vis_t, 2, sidx) == 0.0)
        seen["left"] += int((dark & (dd != 0.0).any(-1)).sum())
        zero = torch.zeros((), dtype=dd.dtype)
        return (torch.where(dark[..., None], zero, dd),
                torch.where(dark[..., None], zero, ss))

    monkeypatch.setattr(lr, "eval_local_lights", terms)
    monkeypatch.setattr(lr, "_shadowed", planes)
    dw, sw = lr.accumulate_local_lights_plain(*args, **kw)
    monkeypatch.undo()
    return torch.cat([d, s]), torch.cat([dw, sw]), seen


SKIP_CASES = {
    "cap128_chunk8_planes": (128, 8, True, 1, H),
    "cap64_chunk16": (64, 16, False, 1, H),
    "cap64_chunk8_clustered_planes": (64, 8, True, 3, H),
    "band_of_40_rows": (64, 8, True, 1, 40),
}


@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_plain_unchanged_by_what_g1_leaves_out(monkeypatch, case):
    """G1 leaves a pair out only where the plain version adds +0 (or -0)
    to a sum that starts at +0: every such term set to +0 before the chunk
    sums gives the plain version bit for bit, and G1 does leave out most
    of the pairs its lists hold."""
    cap, chunk, planes, slices, h = SKIP_CASES[case]
    args, kw = case_args("cpu", W, h, cap, chunk, planes, slices)
    out, walked, seen = _walked(monkeypatch, args, kw)
    assert torch.equal(walked.view(torch.int32), out.view(torch.int32))
    assert 0.5 * seen["pairs"] < seen["left"] < seen["pairs"], seen


def test_sweep_catches_an_eager_skip(monkeypatch):
    """The test of the test: leaving out the pairs beyond 80% of a light's
    range changes pixels."""
    args, kw = case_args("cpu", W, H, 64, 8, False, 1)
    out, walked, _ = _walked(monkeypatch, args, kw, eager=True)
    assert not torch.equal(walked.view(torch.int32), out.view(torch.int32))


def test_unbounded_pairs_are_not_left_out():
    """A light field or a pixel beyond the bound makes its pairs unbounded:
    G1 evaluates them in full."""
    cols = make_lights(4, 1)
    cols["intensity"][0] = 0.0
    cols["position"][1] = [2e6, 0.0, 0.0]
    lights = lights_from_numpy(cols, "cpu")
    g = lr._gather_light_columns(lights, torch.arange(4))
    g = {k: v[None] for k, v in g.items()}
    wp = torch.tensor([[0.0, 0.0, 0.0], [3e6, 0.0, 0.0]])
    n = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    skip, bounded = light_walk.local_light_skips(g, wp, n)
    assert bounded.tolist() == [[True, False, True, True],
                                [False, False, False, False]]
    assert skip[0, 0] and not skip[0, 1] and not skip[1].any()


def test_launch_counter_is_listed_and_named():
    from lsr_tpu_torch.utils.jit import launch_counters

    assert (lr.accumulate_local_lights, "launches") in launch_counters()
    path = os.path.join(HERE, "..", "renderbench", "kernels",
                        "local_lights.json")
    with open(path) as f:
        spec = json.load(f)
    assert spec["counters"] == ["accumulate_local_lights.launches"]
    src = os.path.join(HERE, "..", "lsr_tpu_torch", "csrc", "local_lights.cu")
    with open(src) as f:
        assert all(sym in f.read() for sym in spec["symbols"])


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.card
def test_torch_orders_on_the_card():
    """PyTorch's CUDA sum over a last dimension of 3 is ((x0 + x2) + 0) +
    x1, over a chunk of 1-32 slots (stride 3) accumulator j % 4 then ((a0 +
    a1) + a2) + a3, and its cross product fmaf(a1, b2, -(a2 * b1)): the
    orders csrc/local_lights.cu follows.  Candidates that differ are named."""
    require_card()
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: (torch.randn(*s, generator=g)  # noqa: E731
                      * torch.exp(2.0 * torch.randn(*s, generator=g)))
    x = rnd(4096, 3)
    for shape in ((4096, 3), (64, 1, 64, 3), (16, 256, 1, 3)):
        got = _f32(x.reshape(shape).cuda().sum(-1).cpu()).reshape(-1)
        a, b, c = (_f32(x[:, i]) for i in range(3))
        cands = {"(x0+x2)+x1": (a + c) + b, "(x0+x1)+x2": (a + b) + c,
                 "x0+(x1+x2)": a + (b + c)}
        match = [k for k, v in cands.items() if np.array_equal(v, got)]
        assert match == ["(x0+x2)+x1"], (shape, match)
    for chunk in (1, 2, 3, 5, 8, 12, 16, 24, 32):
        t = rnd(512, 16, chunk, 3)
        got = _f32(t.cuda().sum(-2).cpu())
        tn = _f32(t)
        acc = [np.zeros_like(tn[:, :, 0]) for _ in range(4)]
        for j in range(chunk):
            acc[j % 4] = acc[j % 4] + tn[:, :, j]
        want = ((acc[0] + acc[1]) + acc[2]) + acc[3]
        seq = tn[:, :, 0]
        for j in range(1, chunk):
            seq = seq + tn[:, :, j]
        assert np.array_equal(want, got), (chunk, np.array_equal(seq, got))
    p, q = rnd(8192, 3), rnd(8192, 3)
    got = _f32(torch.linalg.cross(p.cuda(), q.cuda()).cpu())
    pn, qn = p.double().numpy(), q.double().numpy()

    def fma(a, b, c):
        # a * b is exact in f64; one more rounding there is ~2^-29 likely.
        return _f32(a * b + c.astype(np.float64))

    def comp(i, j):
        return {"fma(a,b,-(c*d))": fma(pn[:, i], qn[:, j],
                                       -_f32(pn[:, j] * qn[:, i])),
                "fma(-c,d,a*b)": fma(-pn[:, j], qn[:, i],
                                     _f32(pn[:, i] * qn[:, j])),
                "a*b-c*d": _f32(pn[:, i] * qn[:, j])
                - _f32(pn[:, j] * qn[:, i])}

    for col, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
        match = [k for k, v in comp(i, j).items()
                 if (v == got[:, col]).mean() > 0.999]
        assert match == ["fma(a,b,-(c*d))"], (col, match)


CARD_CASES = {
    "cap128_chunk8_planes": (CW, CH, 128, 8, True, 1),
    "cap128_chunk16": (CW, CH, 128, 16, False, 1),
    "cap64_chunk8": (CW, CH, 64, 8, False, 1),
    "cap64_chunk16_planes": (CW, CH, 64, 16, True, 1),
    "clustered_cap64_chunk8_planes": (CW, CH, 64, 8, True, 4),
    "clustered_cap128_chunk16": (CW, CH, 128, 16, False, 3),
    "band_150_rows_cap64": (CW, 150, 64, 8, True, 1),
    "odd_frame_cap32_chunk8": (200, 77, 32, 8, True, 1),
}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_g1_equals_plain_on_the_card(case):
    """G1 against accumulate_local_lights_plain on the card, bit for bit:
    one launch, on a frame whose lists hold every length from 0 to cap."""
    require_card()
    w, h, cap, chunk, planes, slices = CARD_CASES[case]
    args, kw = case_args(torch.device("cuda", 0), w, h, cap, chunk, planes,
                         slices, n_lights=96)
    before = lr.accumulate_local_lights.launches
    d, s = lr.accumulate_local_lights(*args, **kw)
    assert lr.accumulate_local_lights.launches == before + 1
    dp, sp = lr.accumulate_local_lights_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float(dp.sum()) > 0.0
    assert torch.equal(d, dp), (case, float((d - dp).abs().max()),
                                int((d != dp).sum()))
    assert torch.equal(s, sp), (case, float((s - sp).abs().max()),
                                int((s != sp).sum()))


@pytest.mark.card
def test_ssao_frame_kernel_equals_plain_on_the_card(monkeypatch):
    """forward_classic+ssao through execute_jitted (warm-up, capture,
    replays) with G1, one launch a frame, against the same frame with the
    plain version: hdr and ldr bit for bit."""
    require_card()
    from lsr_tpu_torch.passes import standard_passes
    from lsr_tpu_torch.pipeline.executor import RenderContext
    from lsr_tpu_torch.render_paths import build_preset_pipelines

    dev = torch.device("cuda", 0)

    def frames():
        _, pipes = build_preset_pipelines(
            640, 360, {"forward_classic+ssao"}, local_map=256,
            local_point=128, device=dev, with_pipes=True)
        pipe, fp, state_fn = pipes["forward_classic+ssao"]
        ctx = RenderContext()
        for i in range(4):
            out = pipe.execute_jitted(ctx, state_fn(i % 2), fp)
        n0 = lr.accumulate_local_lights.launches
        out = pipe.execute_jitted(ctx, state_fn(1), fp)
        torch.cuda.synchronize()
        return out["hdr"].clone(), out["ldr"].clone(), \
            lr.accumulate_local_lights.launches - n0

    hdr_k, ldr_k, n_k = frames()
    monkeypatch.setattr(standard_passes, "accumulate_local_lights",
                        lr.accumulate_local_lights_plain)
    hdr_p, ldr_p, n_p = frames()
    assert (n_k, n_p) == (1, 0)
    assert torch.equal(hdr_k, hdr_p), float((hdr_k - hdr_p).abs().max())
    assert torch.equal(ldr_k, ldr_p)
