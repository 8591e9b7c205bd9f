"""Save bench.py's whole frame, in the four configurations of
chip_smoke.py's phase 4a-d, as the card renders it through jit, so that
two trees' frames can be compared bit for bit.

Each configuration (the ESM default on the B2 route with the "map" and the
"packed" atlas, the resolve route, the PCF control; 1920x1080, the
flagship scene, cameras 0-3 of the bench orbit) runs as one program:
camera 0 eager, camera 1 captured, cameras 2 and 3 replayed.  Every output
of every frame goes to OUT (torch.save, on the CPU).  Run it with another
tree's package first on the path to dump that tree's frames:

    PYTHONPATH=<tree> python <this file> OUT.pt
    python <this file> --compare A.pt B.pt

--compare prints, per configuration and output, whether the two dumps are
equal bit for bit, and exits non-zero where they are not.
"""

from __future__ import annotations

import sys

import torch


def dump(path):
    from lsr_tpu_torch.frame import (
        bench_config, build_flagship_scene, flagship_camera,
        make_flagship_frame)
    from lsr_tpu_torch.utils.jit import jit

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    w, h = 1920, 1080
    geom, objects, lights, ctx = build_flagship_scene(256, 42, device=dev)
    cams = [flagship_camera(i, ctx, w, h, device=dev) for i in range(4)]
    esm, pcf = bench_config("esm", w, h), bench_config("pcf", w, h)
    out = {}
    for name, route, cfg in (("esm_b2", False, esm),
                             ("esm_b2_packed", False,
                              dict(esm, atlas_packed=True)),
                             ("esm_resolve", True, esm),
                             ("pcf_b2", False, pcf)):
        jf = jit(make_flagship_frame(geom, objects, lights, ctx, w, h,
                                     use_resolve=route, **cfg))
        frames = []
        for cam in cams:
            o = jf(*cam)
            frames.append([t.detach().cpu() if torch.is_tensor(t) else t
                           for t in o])
        torch.cuda.synchronize()
        out[name] = frames
    torch.save(out, path)
    print(f"# {path}: {list(out)}, {len(cams)} frames each", flush=True)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    bad = 0
    for name in a:
        same = [all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                    for x, y in zip(fa, fb))
                for fa, fb in zip(a[name], b[name])]
        bad += not all(same)
        print(f"{name}: frames bit for bit {same}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    dump(sys.argv[1])
