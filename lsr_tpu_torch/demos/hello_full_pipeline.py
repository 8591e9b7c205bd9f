"""Config #5: the full multi-pass frame, deferred G-buffer + IBL skybox +
motion blur / DoF / FXAA post chain, driven through the pluggable pipeline
(port of demos/hello_full_pipeline.py; parity target: HelloMultiPass and
the composition presets of hello_rendering_paths).

The scene, recipe and FrameParams are full_pipeline.py's (the demo's, TAA
off for its single still frame).  One frame through the instrumented
PluggablePipeline.execute, each pass timed with a sync after it (wall ms,
the card's work included); prints the pass order and the pass ms."""

from __future__ import annotations

from lsr_tpu_torch.demos.common import (
    parser, setup_device, stand_in_mesh, write_frame)
from lsr_tpu_torch.full_pipeline import (
    bake_ibl,
    full_frame_params,
    full_multipass_recipe,
    full_scene,
)
from lsr_tpu_torch.passes.standard_passes import make_standard_registry
from lsr_tpu_torch.pipeline.executor import RenderContext
from lsr_tpu_torch.pipeline.pipeline import PluggablePipeline


def build_scene(mesh, device=None):
    """The mesh standing in for the monkey and the IBL baked from the
    procedural sky on `device`; the frame state is made per size by
    render (or given as scene["state"])."""
    device = setup_device(device)
    return {"mesh": mesh, "ibl": bake_ibl(device), "device": device}


def build_pipeline(width: int, height: int):
    """(pipeline, fp): the demo's recipe configured and planned."""
    fp = full_frame_params(width, height)
    pipe = PluggablePipeline(preexisting_semantics=())
    rep = pipe.configure_from_recipe(full_multipass_recipe(),
                                     make_standard_registry())
    if not rep.ok:
        raise RuntimeError(f"full_multipass: {rep.errors}")
    plan = pipe.build_plan(fp)
    if not plan.ok:
        raise RuntimeError(f"full_multipass: {plan.errors}")
    return pipe, fp


def render(scene, width: int, height: int, shadow_size: int | None = None):
    """One frame: {"ldr", "hdr", "tid", "gbuffer", "velocity", "pass_order",
    "pass_ms"}.  shadow_size: the sun map's size (default: the demo's
    2048)."""
    state = scene.get("state") or full_scene(
        width, height, ibl=scene["ibl"], device=scene["device"],
        mesh=scene["mesh"])
    pipe, fp = build_pipeline(width, height)
    if shadow_size is not None:
        fp.pass_params.shadow.map_size = shadow_size
    order = [pipe.passes[i].pass_id for i in pipe.build_plan(fp).order]
    ctx = RenderContext(sync_timing=True)
    st = pipe.execute(ctx, state, fp)
    return {"ldr": st["ldr"], "hdr": st["hdr"], "tid": st["tid"],
            "gbuffer": st["gbuffer"], "velocity": st["velocity"],
            "pass_order": order, "pass_ms": dict(ctx.debug.pass_ms)}


def main(argv=None):
    args = parser(__doc__, 800, 600).parse_args(argv)
    scene = build_scene(stand_in_mesh(args.obj), args.device)
    out = render(scene, args.width, args.height)
    print("pass order:", out["pass_order"])
    path = write_frame(args.out, "torch_hello_full_pipeline.png", out["ldr"])
    ms = {k: round(v, 1) for k, v in out["pass_ms"].items()}
    print(f"wrote {path}; pass ms: {ms}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
