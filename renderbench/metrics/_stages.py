"""The stage phase's readings (renderbench/stages.py) reduced to the numbers
of the stage metrics, from the phase's dict alone (nothing of the port):

- stage_ms.<family> (ms): the median over the phase's frames of the
  family's top-level stages' device ms, summed a frame;
- stage_kernels.<family> (count): the kernel and memcpy nodes those stages
  added to the captured graph, the operations they run a replay (the
  classes glue_kernels counts), exact;
- stage_cover (%): the top-level stages' device ms over the graph's own
  device span (an external event pair as its first and last nodes), the
  median over the frames;
- launch_ms (ms): the median host ms of the span jit.replay, frames issued
  as the measured window issues them;
- capture_record_s, capture_instantiate_s (s): the set-up spans
  jit.capture.record (the frame run under torch.cuda.graph and
  CaptureCheck) and jit.capture.instantiate (the capture's end and the
  graph's instantiation) of the measured program's first capture.

Each function takes the phase's dict (or None) and returns None where the
phase found nothing to read: a port without utils.trace, a family that no
stage of the cell belongs to.  A reader of one of these metrics is
read(t) = f(t.get("stages"), ...) once the harness puts the phase's dict
into the trace dict (PERF.md, section 7).
"""

import statistics

FAMILIES = ("cull", "shadows", "raster", "lighting", "ssao", "post")


def family_ms(s, family: str):
    v = (s or {}).get("family_ms", {}).get(family)
    return statistics.median(v) if v else None


def family_kernels(s, family: str):
    return (s or {}).get("family_kernels", {}).get(family)


def stage_cover(s):
    v = (s or {}).get("cover")
    return 100.0 * statistics.median(v) if v else None


def launch_ms(s):
    v = (s or {}).get("replay_ms")
    return statistics.median(v) if v else None


def setup_s(s, key: str):
    return (s or {}).get("setup_spans", {}).get(key)


def readings(s) -> dict:
    """{metric name: value} of every stage metric the phase's dict has a
    value for."""
    out = {}
    for fam in FAMILIES:
        out[f"stage_ms.{fam}"] = family_ms(s, fam)
        out[f"stage_kernels.{fam}"] = family_kernels(s, fam)
    out["stage_cover"] = stage_cover(s)
    out["launch_ms"] = launch_ms(s)
    for key in ("capture_record_s", "capture_instantiate_s"):
        out[key] = setup_s(s, key)
    return {k: v for k, v in out.items() if v is not None}
