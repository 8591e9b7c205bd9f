"""The benchmark's inputs, made from the seed: meshes, model matrices, the
light set, materials, the texture, the sun and the camera path.

Everything here is numpy and plain numbers (build_with aside), and
depends on the configuration file, the traffic file and the seed alone.
Both sides take these same inputs: the port through its own builders (port_side.py), the
plain reference through its frozen copies of them (ref_side.py).

The scene arithmetic follows lsr_tpu's frame.build_flagship_scene and
render_paths.scene_state: UV spheres and a ground plane, each placed by
translate @ rotate_y, and groups of lights drawn uniformly inside boxes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of a seed (0: the scene, from the
    configuration's scene seed; 1: where a run's camera cycle starts and 2:
    the frames sampled for its check, from the run's seed).  Any whole
    number is a seed; a negative one is taken modulo 2**64."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def uv_sphere(radius: float, rings: int, sectors: int) -> dict:
    """A UV sphere: 2 * rings * sectors triangles, as io.obj.make_uv_sphere."""
    ring = np.linspace(0.0, np.pi, rings + 1)
    sect = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    rr, ss = np.meshgrid(ring, sect, indexing="ij")
    x = np.sin(rr) * np.cos(ss)
    y = np.cos(rr)
    z = np.sin(rr) * np.sin(ss)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([ss / (2 * np.pi), 1.0 - rr / np.pi],
                  -1).reshape(-1, 2).astype(np.float32)
    stride = sectors + 1
    a = (np.arange(rings)[:, None] * stride + np.arange(sectors)[None, :])
    a = a.reshape(-1)
    b = a + stride
    idx = np.stack([np.stack([a, b, a + 1], -1),
                    np.stack([a + 1, b, b + 1], -1)], 1).reshape(-1, 3)
    return dict(positions=pos * np.float32(radius), normals=pos.copy(),
                uvs=uv, indices=idx.astype(np.int32))


def plane(size: float, y: float) -> dict:
    """The XZ ground plane of extent [-size, size] at height y, +Y normal,
    2 triangles, front-facing from above."""
    s = float(size)
    pos = np.array([[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]],
                   np.float32)
    nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return dict(positions=pos, normals=nrm, uvs=uv, indices=idx)


def mesh(spec: dict) -> dict:
    if spec["kind"] == "uv_sphere":
        return uv_sphere(spec["radius"], spec["rings"], spec["sectors"])
    if spec["kind"] == "plane":
        return plane(spec["size"], spec["y"])
    raise ValueError(f"unknown mesh kind {spec['kind']!r}")


def model_matrix(translate, angle: float) -> np.ndarray:
    """translate(t) @ rotate_y(angle) as a (4, 4) f32 matrix."""
    c, s = np.cos(angle), np.sin(angle)
    m = np.array([[c, 0.0, s, translate[0]],
                  [0.0, 1.0, 0.0, translate[1]],
                  [-s, 0.0, c, translate[2]],
                  [0.0, 0.0, 0.0, 1.0]], np.float64)
    return m.astype(np.float32)


def checkerboard(size: int, squares: int, c0, c1) -> np.ndarray:
    """(size, size, 3) f32 checkerboard in linear colour."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((xx * squares // size) + (yy * squares // size)) % 2
    return np.where(cell[..., None] == 0, np.float32(c0),
                    np.float32(c1)).astype(np.float32)


@dataclasses.dataclass
class SceneInputs:
    """objects: [(mesh dict, (4, 4) model, material, casts_shadow)];
    lights: [dict(kind, position, color, intensity, range[, direction,
    inner_angle, outer_angle])]; materials: make_materials' arguments;
    texture: (S, S, 3) f32 or None; sun: direction, color, intensity;
    eye: the camera's resting eye (the shade context's camera_pos)."""

    objects: list
    lights: list
    materials: dict
    texture: np.ndarray | None
    sun: dict
    eye: tuple


def scene_inputs(cfg: dict) -> SceneInputs:
    """The configuration's scene, drawn from its scene seed: the grids'
    rotations first (where they are "seed"), then each light group in
    order, per light its position (x, y, z) and its colour (r, g, b).
    Every run of a configuration renders the same scene, so that every
    seed gives the same work, in another order."""
    sc = cfg["scene"]
    rng = rng_for(sc["seed"], 0)
    objects = []
    for g in sc["grids"]:
        m = mesh(g["mesh"])
        n, mats = g["n"], g["materials"]
        for i in range(n * n):
            x = (i % n - n // 2) * g["spacing"]
            z = (i // n - n // 2) * g["spacing"]
            rot = (float(rng.uniform(0, 2 * np.pi)) if g["rotate_y"] == "seed"
                   else float(g["rotate_y"]))
            objects.append((m, model_matrix((x, g["y"], z), rot),
                            mats[i % len(mats)], g["casts_shadow"]))
    for o in sc["objects"]:
        rot = (float(rng.uniform(0, 2 * np.pi)) if o["rotate_y"] == "seed"
               else float(o["rotate_y"]))
        objects.append((mesh(o["mesh"]), model_matrix(o["translate"], rot),
                        o["material"], o["casts_shadow"]))
    lights = []
    for grp in sc["lights"]:
        for j in range(grp["count"]):
            t = grp["cycle"][j % len(grp["cycle"])]
            pos = rng.uniform(t["lo"], t["hi"])
            col = rng.uniform(t["color_lo"], t["color_hi"], 3)
            light = dict(kind=t["kind"], position=tuple(float(v) for v in pos),
                         color=tuple(float(v) for v in col),
                         intensity=t["intensity"], range=t["range"])
            if t["kind"] == "spot":
                light.update(direction=tuple(t["direction"]),
                             inner_angle=t["inner_angle"],
                             outer_angle=t["outer_angle"])
            lights.append(light)
    tex = sc["texture"]
    texture = None if tex is None else checkerboard(
        tex["size"], tex["squares"], tex["c0"], tex["c1"])
    return SceneInputs(objects, lights, dict(sc["materials"]), texture,
                       dict(sc["sun"]), tuple(cfg["camera"]["eye"]))


def first_camera(traffic: dict, seed: int) -> int:
    """Where the seed starts the camera cycle: an index in [0, staged)."""
    return int(rng_for(seed, 1).integers(traffic["path"]["staged"]))


def camera_eye(cfg: dict, traffic: dict, index: int) -> tuple:
    """The eye of staged camera `index` (0 <= index < staged): at angle a =
    step_rad * index, the resting eye turned about y by a (rotate_y) plus
    sway * sin(a)."""
    path = traffic["path"]
    a = path["step_rad"] * index
    x, y, z = cfg["camera"]["eye"]
    if path["rotate_y"]:
        x, z = (x * np.cos(a) - z * np.sin(a), x * np.sin(a) + z * np.cos(a))
    sw = path["sway"]
    s = np.sin(a)
    return (float(x + sw[0] * s), float(y + sw[1] * s), float(z + sw[2] * s))


def camera_of(traffic: dict, start: int, ordinal: int) -> int:
    """The staged camera that frame `ordinal` (0 = the first call of the
    program, warm-up included) renders: the cycle from `start` on."""
    return (start + ordinal) % traffic["path"]["staged"]


def build_with(mods, inputs: SceneInputs, device):
    """The scene on `device` through one side's own builders: mods has
    MeshData, SceneBuilder, LightSetBuilder, make_materials and
    make_shade_context (the port's modules, or the reference's copies of
    them).  Returns (geom, objects, lights, ctx)."""
    sb = mods.SceneBuilder()
    for m, model, material, casts in inputs.objects:
        sb.add(mods.MeshData(m["positions"], m["normals"], m["uvs"],
                             m["indices"]), model, material=material,
               casts_shadow=casts)
    geom, objects = sb.build(device)
    lb = mods.LightSetBuilder()
    for li in inputs.lights:
        kw = dict(color=li["color"], intensity=li["intensity"],
                  range=li["range"])
        if li["kind"] == "spot":
            lb.spot(li["position"], li["direction"],
                    inner_angle=li["inner_angle"],
                    outer_angle=li["outer_angle"], **kw)
        else:
            lb.point(li["position"], **kw)
    lights = lb.build(device)
    mats = mods.make_materials(device=device, **inputs.materials)
    tex = None if inputs.texture is None else torch.as_tensor(
        inputs.texture, device=device)[None]
    sun = inputs.sun
    ctx = mods.make_shade_context(
        mats, light_dir_ws=tuple(sun["direction"]),
        light_color=tuple(sun["color"]), light_intensity=sun["intensity"],
        camera_pos=inputs.eye, textures=tex, device=device)
    return geom, objects, lights, ctx
