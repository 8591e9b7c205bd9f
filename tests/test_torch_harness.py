"""lsr_tpu_torch's measurement and presentation layer (gfx/framebuffer.py,
gfx/rt_registry.py, utils/devtime.py, utils/harness.py, utils/viewer.py)
against lsr_tpu's, on the CPU.

Values are compared exactly (framebuffers, registry targets, hash
digests, preview strings, PNG bytes read back); the harnesses' JSONL rows
must carry lsr_tpu's keys, one for one, on the same tiny frame functions.
Times are only checked to be finite and not negative.
"""

from __future__ import annotations

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu.utils import harness as jh
from lsr_tpu_torch.utils import harness as th


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _keys_by_phase(rows):
    out = {}
    for r in rows:
        out.setdefault(r["phase"], set()).update(r)
    return out


# ---------------------------------------------------------------------------
# gfx
# ---------------------------------------------------------------------------

def _registry_sequence(reg_cls, **kw):
    """lsr_tpu's call sequence (tests/test_harness_util.py:45-58), with
    every kind and set / get / names; returns what it observed."""
    seen = []
    rtr = reg_cls(64, 64, **kw)
    a = rtr.ensure_transient("hdr", "color_hdr")
    b = rtr.ensure_transient("hdr", "color_hdr")
    seen.append(("cached", b is a, rtr.rebuild_count))
    rtr.ensure_transient("hdr", "color_hdr", 32, 32)
    seen.append(("size", rtr.rebuild_count))
    rtr.ensure_transient("hdr", "color_hdr4", 32, 32)
    seen.append(("kind", rtr.rebuild_count))
    rtr.resize(128, 128)
    rtr.resize(128, 128)
    seen.append(("resize", rtr.rebuild_count, rtr.valid("hdr"),
                 rtr.extent()))
    for kind in ("color_ldr", "color_hdr", "color_hdr4", "depth", "motion",
                 "shadow", "tid"):
        t = rtr.ensure_transient(kind + "_t", kind, 8, 6)
        arr = np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
        seen.append((kind, arr.shape, str(arr.dtype), arr.ravel()[0].item(),
                     bool((arr == arr.ravel()[0]).all())))
    rtr.set("ldr", np.zeros((4, 4, 3), np.uint8))
    seen.append(("set", rtr.valid("ldr"), rtr.get("missing") is None,
                 rtr.names(), rtr.rebuild_count))
    with pytest.raises(KeyError):
        rtr.ensure_transient("x", "nope")
    return seen


def test_rt_registry_matches_jax():
    from lsr_tpu.gfx.rt_registry import RTRegistry as J
    from lsr_tpu_torch.gfx.rt_registry import RTRegistry as T

    got = _registry_sequence(T, device="cpu")
    assert got == _registry_sequence(J)
    assert got[0] == ("cached", True, 0) and got[3][1] == 3


@pytest.mark.parametrize("size", [(4, 6), (17, 9)])
def test_framebuffer_helpers_match_jax(size):
    from lsr_tpu.gfx import framebuffer as jf
    from lsr_tpu_torch.gfx import framebuffer as tf

    h, w = size
    jfb = jf.make_framebuffer(h, w, (0.1, 0.2, 0.3, 0.4))
    tfb = tf.make_framebuffer(h, w, (0.1, 0.2, 0.3, 0.4), device="cpu")
    pairs = [(tfb, jfb),
             (tf.clear_color(tfb, (1.5, 0.0, 2.0, 1.0)),
              jf.clear_color(jfb, (1.5, 0.0, 2.0, 1.0))),
             (tf.clear_depth(tfb, 0.25), jf.clear_depth(jfb, 0.25)),
             (tf.clear_depth(tfb), jf.clear_depth(jfb))]
    for t, j in pairs:
        assert (t.height, t.width) == (j.height, j.width) == (h, w)
        for f in ("color", "depth", "motion"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
            assert getattr(t, f).dtype == torch.float32
    with pytest.raises(Exception):
        tfb.color = None                      # frozen, as lsr_tpu's
    for t, j in ((tf.make_ldr(h, w, (9, 8, 7), device="cpu"),
                  jf.make_ldr(h, w, (9, 8, 7))),
                 (tf.make_shadow_depth(w, 0.5, device="cpu"),
                  jf.make_shadow_depth(w, 0.5))):
        assert str(t.dtype).split(".")[-1] == str(np.asarray(j).dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    ldr = tf.make_ldr(h, w, device="cpu")
    ldr[0, 0] = 255                            # a writable copy
    assert int(ldr.sum()) == 3 * 255


# ---------------------------------------------------------------------------
# ldr_hash and the harnesses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 3), (4, 16, 3), (27, 31, 3)])
def test_ldr_hash_equals_jax(shape):
    """The same digest from both packages for the same image, given as a
    numpy array, a torch tensor or a jax array; shape-aware."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = jh.ldr_hash(jnp.asarray(img))
    assert th.ldr_hash(img) == th.ldr_hash(torch.as_tensor(img)) == want
    assert jh.ldr_hash(img) == want
    flat = img.reshape(shape[0] * shape[1], 1, 3)
    assert th.ldr_hash(flat) == jh.ldr_hash(flat) != want
    img[0, 0, 0] ^= 1
    assert th.ldr_hash(img) != want


def _frames(lib):
    """The tiny frame functions of lsr_tpu's harness test, in each
    package's arrays."""
    if lib == "jax":
        def full(v):
            return jnp.full((4, 4, 3), v % 256, jnp.uint8)
    else:
        def full(v):
            return torch.full((4, 4, 3), v % 256, dtype=torch.uint8)

    def boom(i):
        raise RuntimeError("frame failed")

    return {"a": lambda i: full(i * 7), "b": lambda i: full(i * 7),
            "bad": lambda i: full(i * 7 + 1), "boom": boom}


def _run_harness(mod, lib, tmp):
    fr = _frames(lib)
    res = mod.run_benchmark("tiny", fr["a"], warmup=2, samples=5, chunk=2,
                            jsonl_path=str(tmp / "f.jsonl"),
                            meta={"lights": 0}, floor_ms=0.001)
    par = mod.run_backend_parity(
        {"same": {"x": fr["a"], "y": fr["b"]},
         "diff": {"x": fr["a"], "y": fr["bad"]}},
        warmup=1, samples=3, jsonl_path=str(tmp / "i.jsonl"), run_id="r1")
    kw = {"device": "cpu"} if lib == "torch" else {}
    soak = mod.run_soak({"a": fr["a"], "b": fr["b"]}, duration_s=0.2,
                        frames_per_cycle=10, drain_every=4,
                        acceptance=mod.SoakAcceptance(max_avg_frame_ms=1e3),
                        jsonl_path=str(tmp / "g.jsonl"), run_id="r1", **kw)
    failing = mod.run_soak({"a": fr["a"], "boom": fr["boom"]},
                           duration_s=0.2, frames_per_cycle=6,
                           acceptance=mod.SoakAcceptance(
                               max_avg_frame_ms=1e3),
                           jsonl_path=str(tmp / "g2.jsonl"), controls=False,
                           **kw)
    return res, par, soak, failing


@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    out = {}
    for lib, mod in (("jax", jh), ("torch", th)):
        tmp = tmp_path_factory.mktemp(lib)
        out[lib] = (tmp, _run_harness(mod, lib, tmp))
    return out


def test_run_benchmark_rows_match_jax(harness_runs):
    (jt, (jr, *_)), (tt, (tr, *_)) = harness_runs["jax"], harness_runs["torch"]
    assert tr.frames == jr.frames == 5
    assert 0.0 <= tr.ms_min <= tr.ms_avg <= tr.ms_max
    assert math.isfinite(tr.ms_avg)
    jrows, trows = _rows(jt / "f.jsonl"), _rows(tt / "f.jsonl")
    assert len(trows) == len(jrows) == 1
    assert set(trows[0]) == set(jrows[0])
    assert trows[0]["lights"] == 0 and trows[0]["chunk"] == 2
    assert {k: v for k, v in trows[0].items() if "ms" not in k
            and k != "fps_avg"} == {k: v for k, v in jrows[0].items()
                                    if "ms" not in k and k != "fps_avg"}


def test_run_backend_parity_flags_mismatch(harness_runs):
    """Identical backends match, a differing one is flagged; the hashes and
    rows equal lsr_tpu's (the frames hold the same bytes)."""
    (jt, (_, jp, *_)), (tt, (_, tp, *_)) = (harness_runs["jax"],
                                          harness_runs["torch"])
    assert tp["same"]["match"] and not tp["diff"]["match"]
    assert tp == jp
    assert _rows(tt / "i.jsonl") == _rows(jt / "i.jsonl")


def test_run_soak_rows_and_controls(harness_runs):
    """Chunk, control and report rows with lsr_tpu's keys; one chunk row a
    drain; the controls bracket the window."""
    (jt, (*_, js, _)), (tt, (*_, ts, _)) = (harness_runs["jax"],
                                          harness_runs["torch"])
    assert set(ts) == set(js)
    assert ts["accepted"] and ts["frames"] > 0 and ts["cycle_failures"] == 0
    tk, jk = (_keys_by_phase(_rows(p / "g.jsonl")) for p in (tt, jt))
    assert tk == jk and set(tk) == {"G", "G_chunk", "G_control"}
    rows = _rows(tt / "g.jsonl")
    chunks = [r for r in rows if r["phase"] == "G_chunk"]
    assert len(chunks) == ts["drains"]
    assert sum(c["frames"] for c in chunks) == ts["frames"]
    controls = [r for r in rows if r["phase"] == "G_control"]
    assert len(controls) == ts["cycles"] + 1
    assert ts["control_fixed_ms_min"] >= 0.0


def test_run_soak_counts_a_raising_cycle(harness_runs):
    """A cycle whose frame raises is counted, the soak carries on, and it
    is not accepted (lsr_tpu's semantics, kept)."""
    (_, (*_, jf)), (_, (*_, tf)) = harness_runs["jax"], harness_runs["torch"]
    for rep in (tf, jf):
        assert rep["cycle_failures"] >= 1 and not rep["accepted"]
        assert rep["cycles"] >= 2 and "control_noop_ms_min" not in rep
    assert set(tf) == set(jf)


def test_soak_acceptance_thresholds_match_jax():
    import dataclasses

    assert (dataclasses.asdict(th.SoakAcceptance())
            == dataclasses.asdict(jh.SoakAcceptance()))
    assert th.measure_sync_floor(n=3, device="cpu") >= 0.0


# ---------------------------------------------------------------------------
# devtime
# ---------------------------------------------------------------------------

def test_devtime_probe_and_slopes():
    """probe reads the sum of the first 128 elements of the first tensor
    leaf (of a tensor, dict, list or dataclass); slope_ms returns (out,
    ms), slope_ms_paired (out, ms >= 0, stderr >= 0)."""
    import dataclasses

    from lsr_tpu.utils.devtime import probe as jprobe
    from lsr_tpu_torch.utils import devtime

    x = np.arange(300, dtype=np.float32).reshape(10, 30)
    want = jprobe(jnp.asarray(x))
    assert devtime.probe(torch.as_tensor(x)) == want == float(x.ravel()[:128]
                                                             .sum())

    @dataclasses.dataclass
    class Box:
        name: str
        t: torch.Tensor

    nested = {"meta": 3, "v": [Box("b", torch.as_tensor(x))]}
    assert devtime.probe(nested) == want
    assert devtime.probe(torch.ones(4, dtype=torch.uint8)) == 4.0
    with pytest.raises(TypeError):
        devtime.probe({"a": 1})

    calls = []

    def fn(a):
        calls.append(1)
        return a * 2.0

    out, ms = devtime.slope_ms(fn, torch.ones(8), iters=(2, 5))
    assert torch.equal(out, torch.full((8,), 2.0)) and math.isfinite(ms)
    assert len(calls) == 1 + 2 + 5
    out, ms, err = devtime.slope_ms_paired(fn, torch.ones(8), iters=(1, 3),
                                           reps=4)
    assert ms >= 0.0 and err >= 0.0 and len(calls) == 8 + 1 + 4 * 4


# ---------------------------------------------------------------------------
# viewer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,rc", [((48, 64), (28, 76)), ((9, 7), (5, 11))])
def test_ascii_preview_equals_jax(size, rc):
    from lsr_tpu.utils.viewer import ascii_preview as jap
    from lsr_tpu_torch.utils.viewer import ascii_preview as tap

    rng = np.random.default_rng(size[0])
    img = rng.integers(0, 256, size + (3,)).astype(np.uint8)
    s = tap(torch.as_tensor(img), *rc)
    assert s == jap(jnp.asarray(img), *rc)
    assert len(s.splitlines()) == rc[0]
    gray = img[..., 0]
    assert tap(torch.as_tensor(gray), *rc) == jap(jnp.asarray(gray), *rc)


def test_headless_viewer_pngs_read_back_equal(tmp_path, capsys):
    """Both packages' viewers run the same frame function: the same file
    names, PNGs that read back equal to each other and to the frames
    (flipped to top-down rows), and the ASCII echo."""
    from lsr_tpu.io.png import read_png as jread
    from lsr_tpu.utils.viewer import HeadlessViewer as JV
    from lsr_tpu_torch.io.png import read_png
    from lsr_tpu_torch.utils.viewer import HeadlessViewer as TV

    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (12, 20, 3)).astype(np.uint8)
              for _ in range(3)]
    seen = []

    def on_frame(i, dt):
        seen.append((i, dt >= 0.0))

    tv = TV(str(tmp_path / "t"), name="f", echo_ascii=True)
    tpaths, ms = tv.run(lambda t, dt: torch.as_tensor(frames[tv.clock.frame
                                                             - 1]),
                        frames=3, on_frame=on_frame)
    jv = JV(str(tmp_path / "j"), name="f")
    jpaths, _ = jv.run(lambda t, dt: jnp.asarray(frames[jv.clock.frame - 1]),
                       frames=3)
    assert [p.split("/")[-1] for p in tpaths] == \
        [p.split("/")[-1] for p in jpaths] == ["f_0000.png", "f_0001.png",
                                               "f_0002.png"]
    for tp_, jp_, f in zip(tpaths, jpaths, frames):
        np.testing.assert_array_equal(read_png(tp_), jread(jp_))
        np.testing.assert_array_equal(read_png(tp_), f[::-1])
    assert ms >= 0.0 and seen == [(0, True), (1, True), (2, True)]
    assert capsys.readouterr().out.count("\n") >= 3 * 28
