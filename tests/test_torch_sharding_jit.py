"""lsr_tpu_torch's four sharded steps as one program each (CPU):
parallel.sharding returns utils.jit.jit(step) where every rank of the mesh
lies on one device, as lsr_tpu returns jax.jit(step) (sharding.py:320,
:368, :500, :614).

On a recording fake card (torch_scenes.RecordingCard: CPU tensors count as
the card's, a capture records every aten op, and kernel B1's plain
versions are fake kernels recorded whole and counted), each step, built
on a mesh of ranks that share the one device, warms up, captures once and
replays at other cameras without running its Python: every replay equals
the undecorated eager step (Jitted.fn) bit for bit, and its B1 and B1b
launches equal the eager step's.  A mesh over several CUDA devices keeps
the eager step.  On the CPU each jitted step (eager there, as jit runs CPU
inputs) matches lsr_tpu's jitted step at 64x32 on meshes (1, 2) / (2, 1)
within ROADMAP C1's bounds (LDR within 1 LSB on >= 99.9% of pixels; the
light-sharded frame at most 1 LSB on under 2% of pixels, lsr_tpu's own
bound).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsr_tpu_torch.parallel import sharding as tsh
from lsr_tpu_torch.utils.jit import Jitted
from test_torch_sharding import (
    _cams,
    _ldr_close,
    _lit_scene,
    _lp_close,
    _t,
    _tiny_scene,
    _to_torch,
    cpus,
)
from torch_scenes import RecordingCard

W, H = 64, 32
SHADOW = 128
PATHS = ("render", "flagship", "light_sharded", "pipelined")


@pytest.fixture(scope="module")
def scenes():
    tiny = _tiny_scene()
    lit = _lit_scene(2, 8, 1.5, 2.0)
    return {"tiny": (tiny, _to_torch(*tiny)),
            "lit": (lit, _to_torch(*lit))}


def _build(path, scenes, shape, devices=None):
    """The port's step of `path` on a mesh of `shape` (every rank on the
    CPU unless devices is given), and a function of a camera list giving
    its arguments."""
    n = int(np.prod(shape))
    devs = cpus(n) if devices is None else devices
    if path == "render":
        tg, to, tc = scenes["tiny"][1]
        mesh = tsh.make_mesh(n, dp=shape[0], devices=devs)
        step = tsh.make_sharded_render(mesh, tg, to, tc, W, H, cap=256)
        return step, lambda cams: (torch.stack([c.viewproj for c in cams]),
                                   cams[0].zn, cams[0].zf)
    if path == "flagship":
        tg, to, tc, tl = scenes["lit"][1]
        mesh = tsh.make_mesh(n, dp=shape[0], devices=devs)
        step = tsh.make_sharded_flagship(mesh, tg, to, tc, tl, W, H,
                                         shadow_size=SHADOW)
        return step, lambda cams: (
            torch.stack([c.viewproj for c in cams]),
            torch.stack([c.view for c in cams]), cams[0].proj, cams[0].zn,
            cams[0].zf, _t([0.35, -0.7, 0.5]))
    if path == "light_sharded":
        mesh = tsh.make_mesh_lp(n, sp=shape[0], lp=shape[1], devices=devs)
        step, _ = tsh.make_light_sharded_forward(mesh, *scenes["lit"][1], W,
                                                 H, cap=32)
        return step, lambda cams: (cams[0].viewproj, cams[0].view,
                                   cams[0].proj, cams[0].zn, cams[0].zf)
    tg, to, tc = scenes["tiny"][1]
    mesh = tsh.make_mesh_pp(2, devices=devs)
    step = tsh.make_pipelined_render(mesh, tg, to, tc, W, H)
    return step, lambda cams: (torch.stack([c.viewproj for c in cams]),
                               cams[0].zn, cams[0].zf)


# Per path: the mesh shape of the fake-card run and the cameras a step.
CARD_MESH = {"render": (2, 2), "flagship": (2, 2), "light_sharded": (2, 2),
             "pipelined": (2,)}
STEP_CAMS = {"render": 2, "flagship": 2, "light_sharded": 1, "pipelined": 3}


@pytest.mark.parametrize("path", PATHS)
def test_step_replays_as_its_eager_step(monkeypatch, scenes, path):
    """On the recording fake card: camera set 0 warms up, then captures;
    sets 1-2 (the orbit moved on, and for set 2 another zn / zf, data)
    replay the tape.  One capture; every call bit for bit the eager step
    on the same inputs; B1 and B1b launches a call equal to the eager
    step's, and at least one of them B1b where the frame is banded."""
    from lsr_tpu.scene.scene import make_camera

    from lsr_tpu_torch import convert
    from lsr_tpu_torch.raster import tiled

    card = RecordingCard().install(monkeypatch)
    b1 = card.kernel(monkeypatch, tiled, "rasterize_brute")
    b1a = card.kernel(monkeypatch, tiled, "_banded_brute")
    step, args_of = _build(path, scenes, CARD_MESH[path])
    assert isinstance(step, Jitted)
    k = STEP_CAMS[path]
    sets = []
    for i, (zn, zf) in enumerate(((0.1, 100.0), (0.1, 100.0),
                                  (0.25, 40.0))):
        cams = [convert.camera_state(make_camera(
            W, H, (np.sin(a) * -3.5, 1.8, np.cos(a) * -3.5), (0, 0, 0),
            zn=zn, zf=zf), "cpu") for a in np.linspace(0.3 * i,
                                                       0.3 * i + 0.4, k)]
        sets.append(args_of(cams))
    counts = lambda: (b1.launches + b1a.launches,  # noqa: E731
                      b1.band_launches)
    for i, args in enumerate([sets[0]] + sets):
        before = counts()
        got = step(*args)
        moved = [a - b for a, b in zip(counts(), before)]
        before = counts()
        want = step.fn(*args)
        ref = [a - b for a, b in zip(counts(), before)]
        assert torch.equal(got, want), (path, i)
        assert moved == ref and ref[0] > 0, (path, i, moved, ref)
        if path != "pipelined":
            assert ref[1] > 0, (path, i, ref)
    assert step.captures == 1 and len(step.graphs) == 1
    # The replays ran the tape: the last set's frame is not the capture's.
    assert not torch.equal(step(*sets[1]), step(*sets[2]))


def test_multi_device_mesh_keeps_the_eager_step(scenes):
    """A mesh whose ranks lie on two devices is built eager (the step
    itself, not a Jitted); one device gives a Jitted, the CPU included."""
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = tsh.make_mesh(2, dp=2, devices=devs)
    assert tsh._program(mesh, len, "x") is len
    one = tsh.make_mesh(2, dp=2, devices=cpus(2))
    assert isinstance(tsh._program(one, len, "x"), Jitted)


def _jax_step(path, scenes, shape, jcams):
    """lsr_tpu's jitted step of `path` on a mesh of `shape`, called."""
    from lsr_tpu.parallel import sharding as jsh

    n = int(np.prod(shape))
    if path == "render":
        jg, jo, jc = scenes["tiny"][0]
        step = jsh.make_sharded_render(jsh.make_mesh(n, dp=shape[0]), jg, jo,
                                       jc, W, H, cap=256)
        return step(jnp.stack([c.viewproj for c in jcams]), jcams[0].zn,
                    jcams[0].zf)
    if path == "flagship":
        jg, jo, jc, jl = scenes["lit"][0]
        step = jsh.make_sharded_flagship(jsh.make_mesh(n, dp=shape[0]), jg,
                                         jo, jc, jl, W, H,
                                         shadow_size=SHADOW)
        return step(jnp.stack([c.viewproj for c in jcams]),
                    jnp.stack([c.view for c in jcams]), jcams[0].proj,
                    jcams[0].zn, jcams[0].zf,
                    jnp.asarray([0.35, -0.7, 0.5], jnp.float32))
    if path == "light_sharded":
        step, _ = jsh.make_light_sharded_forward(
            jsh.make_mesh_lp(n, sp=shape[0], lp=shape[1]),
            *scenes["lit"][0], W, H, cap=32)
        c = jcams[0]
        return step(c.viewproj, c.view, c.proj, c.zn, c.zf)
    jg, jo, jc = scenes["tiny"][0]
    step = jsh.make_pipelined_render(jsh.make_mesh_pp(2), jg, jo, jc, W, H)
    return step(jnp.stack([c.viewproj for c in jcams]), jcams[0].zn,
                jcams[0].zf)


@pytest.mark.parametrize("path,shape", [
    ("render", (2, 1)), ("render", (1, 2)), ("flagship", (1, 2)),
    ("flagship", (2, 1)), ("light_sharded", (1, 2)),
    ("light_sharded", (2, 1)), ("pipelined", (2,))])
def test_jitted_step_matches_jax(scenes, path, shape):
    """The port's jitted step (eager on the CPU) against lsr_tpu's jitted
    step on the same mesh shape at 64x32: LDR within 1 LSB on >= 99.9% of
    pixels (the light-sharded frame: lsr_tpu's bound)."""
    jcams, tcams = _cams(STEP_CAMS[path] if path != "light_sharded" else 1,
                         W, H, 3.5, 1.8, 0.5)
    if path in ("render", "flagship"):
        jcams, tcams = jcams[:shape[0]], tcams[:shape[0]]
    step, args_of = _build(path, scenes, shape)
    assert isinstance(step, Jitted)
    out = step(*args_of(tcams))
    ref = np.asarray(_jax_step(path, scenes, shape, jcams))
    assert out.shape == ref.shape and out.numpy().any()
    if path == "light_sharded":
        _lp_close(out.numpy(), ref)
    else:
        _ldr_close(out.numpy(), ref)
    assert step.captures == 0
