"""lsr_tpu's hello_rendering_paths (demos/hello_rendering_paths.py) through
lsr_tpu_torch.demos.hello_rendering_paths, against lsr_tpu's script on the
same scene (CPU).

The demo renders 72 frames through six jitted plans, which lsr_tpu cannot
do on the CPU in time.  So lsr_tpu's own main() runs at 64x48 on the
UV-sphere stand-in scene (torch_scenes.jax_render_path_scene; ROADMAP C2)
with execute_jitted recorded: the compositions, chains, FrameParams and
frame states its code builds.  The port's demo must build the same, and one
frame of a composition, rendered by the port on lsr_tpu's recorded state,
is held to ROADMAP C1 against lsr_tpu's passes op by op
(torch_scenes.jax_chain_frame), the sun map 128^2 and the occluder proxy
80x45 on both sides.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_demos import jax_demo
from torch_scenes import (
    frame_contract,
    jax_chain_frame,
    jax_render_path_scene,
    state_to_torch,
)

RW, RH = 64, 48
SUN = 128
OCC = (80, 45)


# ---------------------------------------------------------------------------
# hello_rendering_paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rendering_paths():
    """lsr_tpu's hello_rendering_paths main() at RW x RH on
    jax_render_path_scene, execute_jitted recorded (frames stubbed); the
    port's pipelines; {name: (lsr_tpu's chain, its fp, its first state)}."""
    mp = pytest.MonkeyPatch()
    try:
        mod = jax_demo("hello_rendering_paths", mp, size=(RW, RH))
        mod.scene_state = lambda w, h: jax_render_path_scene(w, h)
        seen = {}

        class Recording(mod.PluggablePipeline):
            def configure_from_recipe(self, recipe, reg, *a, **k):
                self.recipe_name = recipe.name
                return super().configure_from_recipe(recipe, reg, *a, **k)

            def execute_jitted(self, ctx, state, fp):
                order = [self.passes[i].pass_id
                         for i in self.build_plan(fp).order]
                seen.setdefault(self.recipe_name, []).append(
                    (order, fp, state))
                return {"ldr": jnp.zeros((RH, RW, 3), jnp.uint8)}

        mod.PluggablePipeline = Recording
        mod.main()
    finally:
        mp.undo()
    return seen, mod.saved


def test_hello_rendering_paths_compositions_match_jax(rendering_paths):
    """The port's demo builds lsr_tpu's six compositions (one configure +
    plan each: 6 rebuilds) with its chains and FrameParams, and its loop
    renders the same frames: 2 cycles of 1 + 5, the cameras of lsr_tpu's
    orbit; the sheet has lsr_tpu's layout."""
    from lsr_tpu.core.frame import FrameParams as JFrameParams
    from lsr_tpu_torch import convert
    from lsr_tpu_torch.demos import hello_rendering_paths as demo

    seen, saved = rendering_paths
    pipes, rebuilds = demo.build_pipelines(RW, RH)
    assert rebuilds == 6 and list(pipes) == list(seen)
    scene = demo.build_scene(RW, RH, "cpu")
    for name, (pipe, fp, _) in pipes.items():
        calls = seen[name]
        assert len(calls) == demo.CYCLES * (1 + demo.FRAMES)
        order, jfp, _ = calls[0]
        assert [pipe.passes[i].pass_id
                for i in pipe.build_plan(fp).order] == order
        assert convert._dataclass_like(JFrameParams, fp) == jfp
        for k, (_, _, jstate) in enumerate(calls):
            i = (k // (1 + demo.FRAMES)) * 7 + max(0, k % (1 + demo.FRAMES)
                                                    - 1)
            cam = demo.frame_state(scene, RW, RH, i)["camera"]
            np.testing.assert_allclose(cam.viewproj.numpy(),
                                       np.asarray(jstate["camera"].viewproj),
                                       rtol=0, atol=1e-5)
    assert saved[0].shape == (RH, 6 * RW, 3)
    shots = {n: torch.full((RH, RW, 3), k, dtype=torch.uint8)
             for k, n in enumerate(pipes)}
    assert tuple(demo.contact_sheet(shots).shape) == saved[0].shape


@pytest.mark.parametrize("name", ["forward_plus", "clustered_forward",
                                  "forward_classic+ssao"])
def test_hello_rendering_paths_frame_matches_jax(rendering_paths, name):
    """One frame of a composition: the port's demo on lsr_tpu's recorded
    frame state against lsr_tpu's passes op by op on its own fp, the sun
    map 128^2 and the occluder proxy 80x45 on both sides, under C1."""
    from lsr_tpu_torch.demos import hello_rendering_paths as demo

    seen, _ = rendering_paths
    order, _, jstate = seen[name][0]
    pipes, _ = demo.build_pipelines(RW, RH)
    pipe, fp, _ = pipes[name]
    fp.pass_params.shadow.map_size = SUN
    fp.pass_params.culling.occ_width, fp.pass_params.culling.occ_height = OCC
    ldr = demo.render({"device": torch.device("cpu")}, pipes, name,
                      state_to_torch(jstate))
    st = pipe.execute_jitted(pipes[name][2], state_to_torch(jstate), fp)
    assert torch.equal(ldr, st["ldr"])
    ref = jax_chain_frame(jstate, fp, order, RW, RH, OCC, SUN)
    frame_contract(st["tid"], ref["tid"], st["hdr"], ref["hdr"], st["ldr"],
                   ref["ldr"])
    assert float((st["tid"] >= 0).float().mean()) > 0.3


def test_hello_rendering_paths_loop_cpu():
    """The port's loop on the CPU: every composition gives a frame of the
    size asked, the timings are finite, the sheet is their row."""
    from lsr_tpu_torch.demos import hello_rendering_paths as demo

    w, h = 32, 24
    scene = demo.build_scene(w, h, "cpu")
    pipes, _ = demo.build_pipelines(w, h)
    for _, fp, _ in pipes.values():
        fp.pass_params.shadow.map_size = 64
        fp.pass_params.culling.occ_width = 40
        fp.pass_params.culling.occ_height = 24
    lines = []
    shots, times = demo.cycle(scene, pipes, w, h, cycles=1, frames=1,
                              log=lines.append)
    assert len(times) == len(lines) == 6
    assert all(np.isfinite(t[2]) and np.isfinite(t[3]) for t in times)
    assert tuple(demo.contact_sheet(shots).shape) == (h, 6 * w, 3)
    assert all(s.shape == (h, w, 3) and bool(s.any()) for s in shots.values())
