"""lsr_tpu's remaining render entry points through lsr_tpu_torch, against
lsr_tpu's own scripts on the same scenes (CPU): demos/hello_wireframe.py,
hello_pixel_primitives.py, hello_full_pipeline.py, hello_rendering_paths.py,
hello_parallelization.py and scripts/run_phases.py
(hello_rendering_paths.py: tests/test_torch_demo_paths.py).

lsr_tpu's scripts are loaded as tests/test_torch_demos.py's jax_demo loads
them (the frame size patched, load_obj giving the UV-sphere stand-in,
ROADMAP C2; the PNG edge handing the frame back), and the state they build
is carried into the port where XLA:CPU's camera differs by an ulp (C19).
The 2D demos must equal lsr_tpu's bit for bit; the 3D frames are held to
ROADMAP C1 (torch_scenes.frame_contract; lp frames to lsr_tpu's light-sum
bound).  Sizes are cut for the CPU: the sun map 128^2 (its 2048^2 default
takes minutes on the plain raster), on both sides alike, and lsr_tpu's
rasters run on rasterize_brute, its Pallas kernels' XLA anchor.

run_phases: lsr_tpu's main() with its builders stubbed to hand out the
port's pipelines writes its rows; the port's run() at tiny sizes must write
rows with the same keys, phase by phase.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_demos import _Recorder, jax_demo, port_state
from torch_scenes import frame_contract

W, H = 96, 72
SUN = 128
OCC = (80, 45)


def _mesh_patches(monkeypatch):
    """load_obj of lsr_tpu's modules giving the stand-in."""
    from lsr_tpu.io import obj as jobj

    stand_in = jobj.make_uv_sphere(rings=16, sectors=32)
    monkeypatch.setattr(jobj, "load_obj", lambda _p: stand_in)


def _brute(setup, width, height, zn, zf, y_offset=0, full_height=None,
           depth_mode=None, **_kw):
    """lsr_tpu's rasterize_direct through rasterize_brute: the whole frame
    of full_height rows, the band's rows sliced (y_offset may be traced,
    under shard_map)."""
    from lsr_tpu.raster.brute import rasterize_brute

    mode = {} if depth_mode is None else {"depth_mode": depth_mode}
    fh = height if full_height is None else full_height
    depth, tid = rasterize_brute(setup, width, fh, zn, zf, **mode)
    if fh != height:
        depth = jax.lax.dynamic_slice_in_dim(depth, y_offset, height, 0)
        tid = jax.lax.dynamic_slice_in_dim(tid, y_offset, height, 0)
    return depth, tid, jnp.int32(0)


# ---------------------------------------------------------------------------
# The 2D demos: bit for bit
# ---------------------------------------------------------------------------

def test_hello_wireframe_matches_jax(monkeypatch, capsys):
    """At its own 600x600: the canvas and the printed lit-pixel count."""
    from lsr_tpu_torch.demos import hello_wireframe as demo
    from lsr_tpu_torch.demos.common import stand_in_mesh

    mod = jax_demo("hello_wireframe", monkeypatch)
    mod.main()
    j_msg = capsys.readouterr().out
    ldr = demo.render(demo.build_scene(stand_in_mesh(), "cpu"), 600,
                      600)["ldr"]
    np.testing.assert_array_equal(ldr.numpy(), mod.saved[0])
    lit = demo.lit_pixels(ldr)
    assert f"({lit} lit pixels)" in j_msg and lit > 1000


def test_hello_pixel_primitives_matches_jax(monkeypatch, tmp_path, capsys):
    """The five panels and the sheet equal lsr_tpu's; main writes the PNG
    and keeps lsr_tpu's lit > 5000 check, raising on an empty sheet."""
    from lsr_tpu_torch.demos import hello_pixel_primitives as demo
    from lsr_tpu_torch.io.png import read_png

    mod = jax_demo("hello_pixel_primitives", monkeypatch)
    mod.main()
    out = demo.render(demo.build_scene("cpu"))
    np.testing.assert_array_equal(out["ldr"].numpy(), mod.saved[0])
    for fn, panel in zip((mod.panel_pixels, mod.panel_lines,
                          mod.panel_triangles, mod.panel_circle,
                          mod.panel_texture), out["panels"]):
        np.testing.assert_array_equal(panel.numpy(), np.asarray(fn()))
    capsys.readouterr()
    assert demo.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    png = read_png(str(tmp_path / "torch_hello_pixel_primitives.png"))
    np.testing.assert_array_equal(png, mod.saved[0][::-1])
    assert f"lit px: {demo.lit_pixels(out['ldr'])}" in capsys.readouterr().out
    monkeypatch.setattr(demo, "PANELS", (lambda d: demo._blank(d),) * 5)
    with pytest.raises(RuntimeError, match="unexpectedly empty"):
        demo.main(["--device", "cpu", "--out", str(tmp_path)])


# ---------------------------------------------------------------------------
# hello_full_pipeline (Config #5)
# ---------------------------------------------------------------------------

def test_hello_full_pipeline_matches_jax(monkeypatch):
    """lsr_tpu's script at 96x72 (sun map 128^2 op by op, its camera
    raster on rasterize_brute) and the port's demo on the scene state it
    built: the same pass order, tids, the final HDR (the post stack spreads
    a lit pixel's difference over its windows: 99.5%, as
    test_torch_compositions) and LDR under C1; the port's IBL within 5e-4
    of lsr_tpu's."""
    from lsr_tpu.passes import shadow as jshadow
    from lsr_tpu.raster import tiled as jtiled
    from lsr_tpu_torch import convert
    from lsr_tpu_torch.demos import hello_full_pipeline as demo
    from lsr_tpu_torch.demos.common import stand_in_mesh

    orig = jshadow.render_shadow_map.__wrapped__
    monkeypatch.setattr(
        jshadow, "render_shadow_map",
        lambda g, o, sun, map_size=2048, **k: orig(g, o, sun, map_size=SUN,
                                                   use_tiled=False))
    monkeypatch.setattr(jtiled, "rasterize_direct", _brute)
    mod = jax_demo("hello_full_pipeline", monkeypatch)
    mod.make_camera = _Recorder(mod.make_camera)
    runs = []

    class Recording(mod.PluggablePipeline):
        def execute(self, ctx, state, fp):
            out = super().execute(ctx, state, fp)
            runs.append((self, fp, out))
            return out

    mod.PluggablePipeline = Recording
    mod.main()
    (pipe, fp, ref), = runs
    j_order = [pipe.passes[i].pass_id for i in pipe.build_plan(fp).order]

    carried = port_state(mod)
    state = {"geom": carried["geom"], "objects": carried["objects"],
             "lights": carried["lights"], "shade_ctx": carried["ctx"],
             "camera": convert.camera_state(mod.make_camera.calls[0][2],
                                            "cpu")}
    out = demo.render({"state": state, "device": torch.device("cpu")}, W, H,
                      shadow_size=SUN)
    assert out["pass_order"] == j_order and len(j_order) == 12
    assert set(out["pass_ms"]) == set(j_order)
    frame_contract(out["tid"], ref["tid"], out["hdr"], ref["hdr"],
                   out["ldr"], ref["ldr"], hdr_share=0.995)
    np.testing.assert_array_equal(mod.saved[0], np.asarray(ref["ldr"]))

    own = demo.build_scene(stand_in_mesh(), "cpu")
    (irr, pref), jibl = own["ibl"], mod.make_shade_context.calls[0][2].ibl
    for a, b in zip((irr,) + tuple(pref), (jibl[0],) + tuple(jibl[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=5e-4)


# ---------------------------------------------------------------------------
# hello_parallelization
# ---------------------------------------------------------------------------

def test_hello_parallelization_matches_jax(monkeypatch):
    """lsr_tpu's script on its 8 virtual CPU devices (tests/conftest.py),
    its rasters on rasterize_brute, and the port's demo on 8 CPU ranks on
    the scene and camera lsr_tpu built: both pass their three checks (dp2 x
    sp4 bit for bit the (1, 1) mesh, pp deterministic and under 0.1% off);
    the single, dp2xsp4 and pp2 panels within 1 LSB on >= 99.9% of pixels
    of lsr_tpu's, the light-sharded panel within lsr_tpu's light-sum bound
    (1 LSB on under 2% of values)."""
    from lsr_tpu.lighting import light_types as jlt
    from lsr_tpu.raster import tiled as jtiled
    from lsr_tpu.scene import scene as jscene
    from lsr_tpu.shading import models as jmodels
    from test_torch_demos import _recording_builder, jax_cameras, same_state
    from lsr_tpu_torch.demos import hello_parallelization as demo
    from lsr_tpu_torch.demos.common import stand_in_mesh

    assert len(jax.devices()) >= 8
    pw, ph = 128, 64
    _mesh_patches(monkeypatch)
    monkeypatch.setattr(jtiled, "rasterize_direct", _brute)
    mod = jax_demo("hello_parallelization", monkeypatch, size=(pw, ph))
    saved = []
    from lsr_tpu.io import png as jpng

    monkeypatch.setattr(jpng, "save_canvas_png",
                        lambda _p, img: saved.append(np.asarray(img)))
    monkeypatch.setattr(jscene, "SceneBuilder", _recording_builder(
        jscene.SceneBuilder, mod.built, "SceneBuilder"))
    monkeypatch.setattr(jlt, "LightSetBuilder", _recording_builder(
        jlt.LightSetBuilder, mod.built, "LightSetBuilder"))
    mod.make_shade_context = _Recorder(jmodels.make_shade_context)
    monkeypatch.setattr(jmodels, "make_shade_context",
                        mod.make_shade_context)
    mod.main()
    (j_row,) = saved
    carried = port_state(mod)
    same_state(demo.build_scene(stand_in_mesh(), "cpu"), carried)
    jax_cameras(monkeypatch, demo)
    scene = {"geom": carried["geom"], "objects": carried["objects"],
             "ctx": carried["ctx"], "lights": carried["lights"],
             "device": torch.device("cpu")}
    logs = []
    out = demo.render(scene, pw, ph, log=logs.append)
    assert len(logs) == 3 and out["pp_diff"] < demo.PP_MAX_DIFF
    row = out["ldr"].numpy()
    assert row.shape == j_row.shape == (ph, 4 * pw, 3)
    for k, name in enumerate(demo.PANELS):
        a = row[:, k * pw:(k + 1) * pw].astype(int)
        b = j_row[:, k * pw:(k + 1) * pw].astype(int)
        d = np.abs(a - b)
        if name == "sp4xlp2":
            assert d.max() <= 1 and (d != 0).mean() < 0.02, name
        else:
            assert (d.max(-1) <= 1).mean() >= 0.999, name
    assert int((row[:, :pw] != row[:1, :1]).any(-1).sum()) > 500


def test_hello_parallelization_checks_raise(monkeypatch):
    """A dp/sp frame that differs from the (1, 1) mesh raises."""
    from lsr_tpu_torch.demos import hello_parallelization as demo
    from lsr_tpu_torch.demos.common import stand_in_mesh

    scene = demo.build_scene(stand_in_mesh(), "cpu")
    orig = demo.make_sharded_render

    def skewed(mesh, *a, **k):
        step = orig(mesh, *a, **k)
        if mesh.devices.size == 1:
            return step
        return lambda *s: step(*s) ^ 1

    monkeypatch.setattr(demo, "make_sharded_render", skewed)
    with pytest.raises(RuntimeError, match="dp/sp mismatch"):
        demo.render(scene, 32, 32, log=lambda m: None)


# ---------------------------------------------------------------------------
# run_phases
# ---------------------------------------------------------------------------

_ENV = {"LSR_PHASE_W": "32", "LSR_PHASE_H": "24", "LSR_PHASE_F_W": "32",
        "LSR_PHASE_F_H": "24", "LSR_PHASE_F_WARMUP": "1",
        "LSR_PHASE_F_SAMPLES": "2", "LSR_PHASE_G_SECONDS": "0.3",
        "LSR_PHASE_PRESETS": "forward_plus"}


def _cut_builder(orig):
    """build_preset_pipelines cut for the CPU on every fp it builds: sun
    64^2, occluders 40x24, one shadowed spot of the ten casters at 32^2."""
    def build(*a, with_pipes=False, **k):
        fns, pipes = orig(*a, with_pipes=True, **k)
        for _, fp, _ in pipes.values():
            lp = fp.pass_params.local_shadow
            fp.pass_params.shadow.map_size = 64
            fp.pass_params.local_shadow = dataclasses.replace(
                lp, spot_ids=lp.spot_ids[:1], point_ids=(), map_size=32)
            fp.pass_params.culling.occ_width = 40
            fp.pass_params.culling.occ_height = 24
        return (fns, pipes) if with_pipes else fns
    return build


@pytest.fixture(scope="module")
def phase_runs(tmp_path_factory):
    """The port's run() with every phase at 32x24 on forward_plus (and
    forward_plus+full in Phase F), and lsr_tpu's main() with its builders
    stubbed to hand out the port's frames and states (so every row is
    lsr_tpu's own code on the same data).  Returns (port result, port rows,
    lsr_tpu rows), rows by file name."""
    from lsr_tpu_torch import render_paths, run_phases

    tmp = tmp_path_factory.mktemp("phases")
    mp = pytest.MonkeyPatch()
    try:
        for mod in (run_phases, render_paths):
            mp.setattr(mod, "build_preset_pipelines",
                       _cut_builder(render_paths.build_preset_pipelines))
        res = run_phases.run(dict(_ENV, LSR_PHASE_GOLDENS="1"), device="cpu",
                             out_dir=str(tmp / "port"), log=lambda m: None)
        port_rows = {f: [json.loads(x) for x in open(tmp / "port" / f)]
                     for f in os.listdir(tmp / "port")}
        jax_rows = _jax_run_phases(mp, tmp / "jax")
    finally:
        mp.undo()
    return res, port_rows, jax_rows


def _jax_run_phases(mp, cwd):
    """lsr_tpu's scripts/run_phases.py main() in cwd, its
    build_preset_pipelines handing out the port's cut pipelines as jax
    frames and a stub pipeline whose states carry the port's frame-0
    light grid, setup validity and SSAO mask."""
    import importlib.util
    import types

    from lsr_tpu_torch.render_paths import build_preset_pipelines as tbuild

    spec = importlib.util.spec_from_file_location(
        "jax_run_phases", os.path.join(os.path.dirname(__file__), "..",
                                       "scripts", "run_phases.py"))
    mod = importlib.util.module_from_spec(spec)
    mp.setattr("sys.path", list(__import__("sys").path))
    spec.loader.exec_module(mod)
    build = _cut_builder(tbuild)

    class Stub:
        def __init__(self, pipe, fp, state_fn):
            self.pipe, self.fp, self.state_fn = pipe, fp, state_fn

        def execute_jitted(self, ctx, state, fp):
            from lsr_tpu_torch.pipeline.executor import RenderContext

            st = self.pipe.execute_jitted(RenderContext(), self.state_fn(0),
                                          self.fp)
            out = {}
            if st.get("light_grid") is not None:
                g = st["light_grid"]
                out["light_grid"] = {
                    "counts": g["counts"].numpy(),
                    "max_count": int(g["max_count"]),
                    "overflow_bins": int(g["overflow_bins"]),
                    "slices": g["slices"]}
            if st.get("setup") is not None:
                out["setup"] = types.SimpleNamespace(
                    valid=st["setup"].valid.numpy())
            if st.get("ssao_mask") is not None:
                out["ssao_mask"] = st["ssao_mask"].numpy()
            return out

        def execute_segmented(self, ctx, state, fp, iters=(2, 8)):
            ids = [self.pipe.passes[i].pass_id
                   for i in self.pipe.build_plan(self.fp).order]
            ctx.debug.pass_ms.update({k: 1.0 for k in ids})
            ctx.debug.pass_ms_err.update({k: 0.0 for k in ids})
            return {}

    def jbuild(width, height, presets=None, post=("fxaa",), use_tiled=True,
               local_map=1024, local_point=512, with_pipes=False,
               shadow_filter=None):
        fns, pipes = build(width, height, presets, post=post,
                           use_tiled=use_tiled, local_map=local_map,
                           local_point=local_point, device="cpu",
                           with_pipes=True)
        # The rows' keys do not depend on the pixels: each frame is a
        # cheap function of its index and the composition.
        jfns = {n: (lambda i, k=k: jnp.full((height, width, 3),
                                            (7 * i + k) % 256, jnp.uint8))
                for k, n in enumerate(fns)}
        jpipes = {n: (Stub(*p), None, lambda i: None)
                  for n, p in pipes.items()}
        return (jfns, jpipes) if with_pipes else jfns

    mod.build_preset_pipelines = jbuild
    for k, v in dict(_ENV, LSR_PHASE_GOLDENS="0").items():
        mp.setenv(k, v)
    os.makedirs(cwd)
    mp.chdir(cwd)
    mod.main()
    art = cwd / "artifacts"
    return {f: [json.loads(x) for x in open(art / f)]
            for f in os.listdir(art)}


def test_run_phases_rows_match_jax(phase_runs):
    """Each phase's rows carry lsr_tpu's keys, one for one, file by file
    (artifacts/phase_X.jsonl against torch_phase_X.jsonl)."""
    _, port_rows, jax_rows = phase_runs
    assert sorted(port_rows) == sorted("torch_" + f for f in jax_rows)
    assert len(jax_rows) == 4
    def keys(rows):
        """{phase: the distinct key sets of its rows} (a soak's row count
        depends on its frame times)."""
        out = {}
        for r in rows:
            out.setdefault(r["phase"], set()).add(frozenset(r))
        return out

    for f, rows in jax_rows.items():
        assert keys(port_rows["torch_" + f]) == keys(rows), f


def test_run_phases_results(phase_runs):
    """The phases' results: Phase I on both backends (the hash match is
    data; on the CPU both routes are plain rasters of the same setup),
    four distinct post-stack images, Phase F net of the floor with pass
    ms, a soak with no failed cycle and lsr_tpu's thresholds."""
    from lsr_tpu_torch.pipeline.recipe import POST_STACK_PRESETS

    res, port_rows, _ = phase_runs
    assert set(res["I"]) == {"forward_plus"}
    assert set(res["I"]["forward_plus"]["hashes"]) == {"cuda_tiled",
                                                      "torch_brute"}
    assert res["I_posts_distinct"]["forward_plus"] == (
        len(POST_STACK_PRESETS), len(POST_STACK_PRESETS))
    assert set(res["F"]) == {"forward_plus", "forward_plus+full"}
    assert all(r.frames == 2 and r.ms_avg >= 0.0 for r in res["F"].values())
    assert "local_shadows" in res["F_pass"]["forward_plus"]["pass_ms"]
    g = res["G"]
    assert g["cycle_failures"] == 0 and g["frames"] > 0
    assert g["rebuilds"] == 0
    assert g["accepted"] == (g["avg_frame_ms"] <= 50.0)
    header = port_rows["torch_phase_f_metrics.jsonl"][0]
    assert header["phase"] == "header" and header["floor_ms"] >= 0.0
    ids = {r.get("run_id") for rows in port_rows.values() for r in rows}
    assert ids == {res["run_id"]}
