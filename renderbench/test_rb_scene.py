"""The seeded inputs: a configuration's scene seed gives the same scene
every time, another scene seed another; a run's seed (any whole number)
draws where the camera cycle starts."""

import json
import os

import numpy as np
import pytest

from renderbench import scene

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind, name):
    return json.load(open(os.path.join(HERE, kind, f"{name}.json")))


def flat(inp):
    return ([m[1] for m in inp.objects], [(li["position"], li["color"])
                                          for li in inp.lights])


@pytest.mark.parametrize("cfg_name", ["flagship_1080p", "paths_720p"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**32 + 1, -12])
def test_same_seed_same_scene(cfg_name, seed):
    cfg = load("configs", cfg_name)
    cfg["scene"]["seed"] = seed
    a, b = scene.scene_inputs(cfg), scene.scene_inputs(cfg)
    (ma, la), (mb, lb) = flat(a), flat(b)
    assert all(np.array_equal(x, y) for x, y in zip(ma, mb)) and la == lb
    cfg["scene"]["seed"] = seed + 1
    assert flat(scene.scene_inputs(cfg))[1] != la


def test_scene_sizes():
    f = scene.scene_inputs(load("configs", "flagship_1080p"))
    assert len(f.objects) == 26 and len(f.lights) == 256
    assert sum(o[0]["indices"].shape[0] for o in f.objects) == 25602
    assert [li["kind"] for li in f.lights[:11]] == ["spot"] * 8 + [
        "point"] * 2 + ["spot"]
    p = scene.scene_inputs(load("configs", "paths_720p"))
    assert len(p.objects) == 3 and len(p.lights) == 384
    assert sum(o[0]["indices"].shape[0] for o in p.objects) == 2050


def test_lights_inside_their_boxes():
    cfg = load("configs", "flagship_1080p")
    inp = scene.scene_inputs(cfg)
    grp = cfg["scene"]["lights"][2]
    for j, li in enumerate(inp.lights[10:]):
        t = grp["cycle"][j % 4]
        assert li["kind"] == t["kind"]
        assert all(lo <= v <= hi for v, lo, hi in
                   zip(li["position"], t["lo"], t["hi"]))


def test_uv_sphere_matches_the_loop_order():
    m = scene.uv_sphere(0.5, 2, 3)
    want = []
    for r in range(2):
        for s in range(3):
            a = r * 4 + s
            want += [(a, a + 4, a + 1), (a + 1, a + 4, a + 5)]
    assert m["indices"].tolist() == [list(t) for t in want]
    assert np.allclose(np.linalg.norm(m["positions"], axis=1), 0.5,
                       atol=1e-6)


def test_camera_cycle():
    cfg, orbit = load("configs", "flagship_1080p"), load("traffic", "orbit")
    assert scene.camera_eye(cfg, orbit, 0) == tuple(cfg["camera"]["eye"])
    x, y, z = scene.camera_eye(cfg, orbit, 10)
    assert np.isclose(np.hypot(x, z), np.hypot(6.0, -10.0)) and y == 6.5
    assert scene.camera_of(orbit, 310, 7) == 2
    starts = {scene.first_camera(orbit, s) for s in range(50)}
    assert len(starts) > 30 and all(0 <= s < 315 for s in starts)
    assert scene.first_camera(orbit, 2**33) == scene.first_camera(orbit,
                                                                  2**33)
    paths, ssao = load("configs", "paths_720p"), load("traffic", "ssao")
    x, y, z = scene.camera_eye(paths, ssao, 50)
    assert np.isclose(x, 0.6 + 0.2 * np.sin(1.5)) and (y, z) == (1.6, -4.5)
