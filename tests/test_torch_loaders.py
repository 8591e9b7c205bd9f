"""The mesh loaders through lsr_tpu_torch against lsr_tpu (CPU): io/ply,
io/stl, io/gltf, io/mesh_loader (its OBJ route through the native loader),
the port's io/mesh_writer, and frame.build_flagship_scene's mesh_path.

Every fixture of lsr_tpu's own loader tests (tests/test_ply.py,
tests/test_mesh_loaders.py, the OBJ text of tests/test_io.py and
tests/test_fast_obj.py) is written once and loaded by both packages; every
MeshData array must be equal (np.array_equal).  A mesh loaded and rendered
through the port on the CPU gives lsr_tpu's setup bit for bit (ROADMAP C1)
and lsr_tpu's rasterize_brute tids off the edges two triangles share.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from lsr_tpu.io import mesh_loader as jml
from lsr_tpu_torch.io import mesh_loader as tml
from lsr_tpu_torch.io import mesh_writer
from test_mesh_loaders import _IDX, _POS, _gltf_doc
from test_ply import ASCII_PLY

MESH_FIELDS = ("positions", "normals", "uvs", "indices")


def _same_meshes(path):
    """load_meshes of both packages on `path`: equal arrays, equal dtypes;
    returns the port's."""
    tm, jm = tml.load_meshes(str(path)), jml.load_meshes(str(path))
    assert len(tm) == len(jm) > 0
    for a, b in zip(tm, jm):
        for f in MESH_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            assert np.array_equal(x, y), f
    return tm


# --- lsr_tpu's fixtures -------------------------------------------------------

def _binary_ply():
    verts = np.asarray([
        [0, 0, 0, 0, 0, 1], [1, 0, 0, 0, 0, 1],
        [1, 1, 0, 0, 0, 1], [0, 1, 0, 0, 0, 1],
    ], np.float32)
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex 4\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"property float nx\nproperty float ny\nproperty float nz\n"
              b"element face 2\n"
              b"property list uchar uint vertex_indices\n"
              b"end_header\n")
    return header + verts.tobytes() + struct.pack("<B3I", 3, 0, 1, 2) \
        + struct.pack("<B3I", 3, 0, 2, 3)


# A PLY of both float-pair UV names, an element neither loader knows and
# a pentagon (a fan of three), ascii and binary.
_EXTRA_PLY = """ply
format ascii 1.0
element vertex 5
property float x
property float y
property float z
property float s
property float t
element material 2
property uchar r
property uchar g
element face 2
property list uchar int vertex_indices
end_header
0 0 0 0 0
1 0 0.5 1 0
1.5 1 0 1 1
0.5 1.5 -0.25 0.5 1
-0.5 1 0 0 1
10 20
30 40
5 0 1 2 3 4
3 0 2 4
"""


def _extra_ply_binary():
    v = np.asarray([[0, 0, 0, 0, 0], [1, 0, 0.5, 1, 0], [1.5, 1, 0, 1, 1],
                    [0.5, 1.5, -0.25, 0.5, 1], [-0.5, 1, 0, 0, 1]],
                   np.float32)
    header = (b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"property float u\nproperty float v\n"
              b"element material 2\nproperty uchar r\nproperty uchar g\n"
              b"element face 2\nproperty list uchar int vertex_indices\n"
              b"end_header\n")
    return header + v.tobytes() + bytes([10, 20, 30, 40]) \
        + struct.pack("<B5i", 5, 0, 1, 2, 3, 4) \
        + struct.pack("<B3i", 3, 0, 2, 4)


def _stl_binary():
    rec = b""
    for t in _POS[_IDX.astype(int)]:
        rec += struct.pack("<3f", 0, 0, 1)
        for c in t:
            rec += struct.pack("<3f", *c)
        rec += b"\0\0"
    return b"\0" * 80 + struct.pack("<I", 2) + rec


def _stl_ascii():
    lines = ["solid t"]
    for t in _POS[_IDX.astype(int)]:
        lines += ["facet normal 0 0 1", "outer loop"]
        lines += [f"vertex {c[0]} {c[1]} {c[2]}" for c in t]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid t")
    return "\n".join(lines)


def _glb(doc, buf):
    doc = dict(doc, buffers=[{"byteLength": len(buf)}])
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    bin_c = buf + b"\0" * ((4 - len(buf) % 4) % 4)
    return (b"glTF" + struct.pack("<II", 2, 12 + 8 + len(js) + 8 + len(bin_c))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(bin_c), 0x004E4942) + bin_c)


def _gltf_rich():
    """Two meshes: interleaved POSITION / NORMAL under a byteStride,
    normalized uint16 TEXCOORD_0, no indices; a line primitive (skipped);
    then a sparse POSITION accessor over an indexed triangle."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5],
                      [2, 1, 0], [1, 2, 0.25]], np.float32)
    nrm = np.tile(np.asarray([[0, 0.6, 0.8]], np.float32), (6, 1))
    inter = np.concatenate([pos, nrm], 1).tobytes()
    uv16 = np.asarray([[0, 0], [65535, 0], [0, 65535], [65535, 65535],
                       [32768, 100], [7, 40000]], np.uint16).tobytes()
    idx = np.asarray([0, 1, 2], np.uint8).tobytes() + b"\0"
    sp_idx = np.asarray([1], np.uint16).tobytes() + b"\0\0"
    sp_val = np.asarray([[3, 0, 0]], np.float32).tobytes()
    buf = inter + uv16 + idx + sp_idx + sp_val
    o = np.cumsum([0, len(inter), len(uv16), len(idx), len(sp_idx)])
    views = [{"buffer": 0, "byteOffset": int(o[0]), "byteLength": len(inter),
              "byteStride": 24},
             {"buffer": 0, "byteOffset": int(o[1]), "byteLength": len(uv16)},
             {"buffer": 0, "byteOffset": int(o[2]), "byteLength": 3},
             {"buffer": 0, "byteOffset": int(o[3]), "byteLength": 2},
             {"buffer": 0, "byteOffset": int(o[4]), "byteLength": 12}]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3"},
        {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
         "count": 6, "type": "VEC3"},
        {"bufferView": 1, "componentType": 5123, "normalized": True,
         "count": 6, "type": "VEC2"},
        {"bufferView": 2, "componentType": 5121, "count": 3,
         "type": "SCALAR"},
        {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3",
         "sparse": {"count": 1,
                    "indices": {"bufferView": 3, "componentType": 5123},
                    "values": {"bufferView": 4}}},
    ]
    doc = {"asset": {"version": "2.0"}, "bufferViews": views,
           "accessors": accessors,
           "buffers": [{"byteLength": len(buf),
                        "uri": "data:application/octet-stream;base64,"
                               + base64.b64encode(buf).decode()}],
           "meshes": [
               {"primitives": [
                   {"attributes": {"POSITION": 0, "NORMAL": 1,
                                   "TEXCOORD_0": 2}},
                   {"attributes": {"POSITION": 0}, "mode": 1}]},
               {"primitives": [{"attributes": {"POSITION": 4},
                                "indices": 3}]}]}
    return json.dumps(doc)


OBJ_TEXTS = {
    # tests/test_io.py::test_obj_text_parse
    "quad_vt_vn": "\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\n"
                  "vn 0 0 -1\nf 1/1/1 2/1/1 3/1/1 4/1/1\n",
    # tests/test_fast_obj.py::test_text_variants
    "fan_negative": "\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3 4\n"
                    "f -1 -2 -3\n",
    # v//vn, v/vt, comments and a shared corner
    "mixed": "# mixed\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 1\nvt 0.5 0.25\n"
             "vn 0 0 1\nf 1//1 2//1 3//1\nf 1/1 3/1 4/1\nf 1//1 3//1 4//1\n",
}

FIXTURES = {
    "ascii.ply": ASCII_PLY,
    "binary.ply": _binary_ply(),
    "extra_ascii.ply": _EXTRA_PLY,
    "extra_binary.ply": _extra_ply_binary(),
    "uvs.gltf": json.dumps(_gltf_doc(with_uvs=True)[0]),
    "normals.gltf": json.dumps(_gltf_doc(with_normals=True,
                                         with_uvs=False)[0]),
    "container.glb": _glb(*_gltf_doc(with_normals=True)),
    "rich.gltf": _gltf_rich(),
    "binary.stl": _stl_binary(),
    "ascii.stl": _stl_ascii(),
    **{f"{k}.obj": v for k, v in OBJ_TEXTS.items()},
    "fan_negative.rawobj": OBJ_TEXTS["fan_negative"],
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_loaders_match_jax(tmp_path, name):
    """Each fixture through load_meshes of both packages: equal MeshData."""
    data = FIXTURES[name]
    path = tmp_path / name
    if isinstance(data, bytes):
        path.write_bytes(data)
    else:
        path.write_text(data)
    meshes = _same_meshes(path)
    assert meshes[0].num_triangles >= 1
    np.testing.assert_array_equal(tml.load_mesh(str(path)).indices,
                                  meshes[0].indices)


def test_rich_gltf_meshes(tmp_path):
    """The rich glTF: the line primitive skipped, the sparse value applied,
    the normalized texcoords scaled to [0, 1]."""
    p = tmp_path / "rich.gltf"
    p.write_text(_gltf_rich())
    a, b = tml.load_meshes(str(p))
    assert a.num_triangles == 2 and b.num_triangles == 1
    np.testing.assert_array_equal(b.positions[1], [3, 0, 0])
    assert a.uvs.max() == 1.0 and a.uvs.min() == 0.0


def test_dispatcher_errors_match_jax(tmp_path):
    """An unknown extension raises lsr_tpu's ValueError; a glTF without
    triangle meshes raises in load_mesh, as lsr_tpu's does."""
    for fn in (tml.load_mesh, jml.load_mesh):
        with pytest.raises(ValueError) as t_err:
            fn(str(tmp_path / "x.dae"))
        assert str(t_err.value) == \
            f"unsupported mesh format: '.dae' ({tmp_path / 'x.dae'})"
    p = tmp_path / "empty.gltf"
    p.write_text(json.dumps({"asset": {"version": "2.0"}, "meshes": []}))
    for fn in (tml.load_mesh, jml.load_mesh):
        with pytest.raises(ValueError, match="no meshes"):
            fn(str(p))


# --- the port's writer --------------------------------------------------------

@pytest.mark.parametrize("ext", sorted(mesh_writer.WRITERS))
def test_written_sphere_loads_in_every_format(tmp_path, ext):
    """A UV sphere written by mesh_writer in each format: both packages
    load the same MeshData; every triangle's corners come back as the
    written float32 positions, and where the format carries them (OBJ,
    glTF) its normals and UVs too (PLY renormalizes its normals; STL
    welds its corners and has neither)."""
    from lsr_tpu_torch.io.obj import make_uv_sphere

    mesh = make_uv_sphere(rings=12, sectors=20)
    path = tmp_path / f"sphere{ext}"
    mesh_writer.write_mesh(str(path), mesh)
    (got,) = _same_meshes(path)
    assert got.num_triangles == mesh.num_triangles
    corners = lambda m, f: getattr(m, f)[m.indices]  # noqa: E731
    np.testing.assert_array_equal(corners(got, "positions"),
                                  corners(mesh, "positions"))
    if ext in (".obj", ".gltf", ".glb"):
        for f in ("normals", "uvs"):
            np.testing.assert_array_equal(corners(got, f), corners(mesh, f))
    if ext == ".ply":
        np.testing.assert_array_equal(corners(got, "uvs"),
                                      corners(mesh, "uvs"))
        np.testing.assert_allclose(corners(got, "normals"),
                                   corners(mesh, "normals"), atol=1e-6)


def test_write_mesh_rejects_unknown_format(tmp_path):
    from lsr_tpu_torch.io.obj import make_cube

    with pytest.raises(ValueError, match="unsupported mesh format"):
        mesh_writer.write_mesh(str(tmp_path / "x.dae"), make_cube())


# --- through the pipeline -----------------------------------------------------

def _setup_both(jmesh, tmesh, w, h, eye, target):
    """lsr_tpu's scene_setup of jmesh and the port's of tmesh (its own
    SceneBuilder, on the CPU), under lsr_tpu's camera carried over."""
    from lsr_tpu.raster.setup import scene_setup as jsetup
    from lsr_tpu.scene.scene import SceneBuilder as JBuilder
    from lsr_tpu.scene.scene import make_camera
    from lsr_tpu_torch.raster.setup import scene_setup
    from lsr_tpu_torch.scene.scene import SceneBuilder

    jb, tb = JBuilder(), SceneBuilder()
    jb.add(jmesh, np.eye(4, dtype=np.float32))
    tb.add(tmesh, np.eye(4, dtype=np.float32))
    (jg, jo), (tg, to) = jb.build(), tb.build("cpu")
    cam = make_camera(w, h, eye, target)
    js = jsetup(jg.positions, jg.normals, jg.uvs, jg.indices, jg.vtx_obj,
                jg.tri_obj, jo.model, jo.normal_mat, cam.viewproj, w, h,
                cull_mode=0)
    ts = scene_setup(tg.positions, tg.normals, tg.uvs, tg.indices,
                     tg.vtx_obj, tg.tri_obj, to.model, to.normal_mat,
                     torch.tensor(np.asarray(cam.viewproj)), w, h,
                     cull_mode=0)
    v = np.asarray(js.valid)
    np.testing.assert_array_equal(ts.valid.numpy(), v)
    for f in ("coef", "iw", "ziw", "bbox"):
        np.testing.assert_array_equal(getattr(ts, f).numpy()[v],
                                      np.asarray(getattr(js, f))[v],
                                      err_msg=f)
    return js, ts, cam


@pytest.mark.parametrize("fmt", ["ply", "gltf"])
def test_loaded_mesh_renders_as_jax(tmp_path, fmt):
    """lsr_tpu's test_ply_renders_through_pipeline (ASCII PLY quad) and
    test_gltf_renders_through_pipeline (glTF quad), at 64x64: the port's
    setup equals lsr_tpu's bit for bit, and its raster (rasterize_brute
    for the PLY, as lsr_tpu's test; the direct raster's plain version for
    the glTF) gives lsr_tpu's rasterize_brute tids, but on pixels of an
    edge that two triangles share at the same depth: XLA:CPU fuses the
    edge function's multiply-adds inside lsr_tpu's scan, which puts such a
    pixel (an edge function exactly 0 here) just outside one triangle (the
    C1 contract's "FMA difference in A*x + B*y + C"), or just inside the
    other.  On such pixels lsr_tpu's winner covers the pixel in the port's
    arithmetic too, up to the rounding of its edge functions (1e-6).
    Depth within 2e-5 (C1; measured 9.3e-9)."""
    from lsr_tpu.raster.brute import rasterize_brute as jbrute
    from lsr_tpu_torch.raster.brute import rasterize_brute
    from lsr_tpu_torch.raster.tiled import rasterize_direct

    path = tmp_path / f"quad.{fmt}"
    path.write_text(ASCII_PLY if fmt == "ply"
                    else json.dumps(_gltf_doc()[0]))
    js, ts, cam = _setup_both(jml.load_mesh(str(path)),
                              tml.load_mesh(str(path)), 64, 64,
                              (0.5, 0.5, -2.0), (0.5, 0.5, 0.0))
    jd, jtid = (np.asarray(x) for x in jbrute(js, 64, 64, cam.zn, cam.zf))
    zn, zf = float(cam.zn), float(cam.zf)
    if fmt == "ply":
        depth, tid = rasterize_brute(ts, 64, 64, zn, zf)
    else:
        depth, tid, _ = rasterize_direct(ts, 64, 64, zn, zf)
    depth, tid = depth.numpy(), tid.numpy()
    assert int((tid >= 0).sum()) > 200
    np.testing.assert_allclose(depth, jd, rtol=0, atol=2e-5)
    off = tid != jtid          # the shared diagonal: 13 / 10 px here
    assert (tid[off] >= 0).all() and (jtid[off] >= 0).all()
    # lsr_tpu's winner covers each of these pixels in the port's arithmetic
    # too, up to the rounding of its edge functions: an edge pixel.
    ys, xs = np.nonzero(off)
    c = ts.coef.numpy()[jtid[off]].astype(np.float64)
    bc = [c[:, 3 * k] * (xs + 0.5) + c[:, 3 * k + 1] * (ys + 0.5)
          + c[:, 3 * k + 2] for k in range(3)]
    assert np.min(bc, axis=0).min() >= -1e-6


# --- frame.build_flagship_scene(mesh_path=...) --------------------------------

def test_flagship_scene_from_obj_equals_default(tmp_path):
    """The flagship scene built from a written UV-sphere OBJ (the native
    loader, as bench.py loads the monkey) equals the default scene tensor
    for tensor: objects, lights and shade context equal; the geometry's
    vertex count equal and every triangle's corners (position, normal, UV,
    object) equal, the OBJ numbering its vertices by first use in the
    faces; and the setup of one orbit camera equal bit for bit."""
    from lsr_tpu_torch.frame import build_flagship_scene, flagship_camera
    from lsr_tpu_torch.io.obj import make_uv_sphere
    from lsr_tpu_torch.raster.setup import scene_setup

    path = str(tmp_path / "sphere.obj")
    mesh_writer.write_obj(path, make_uv_sphere(rings=16, sectors=32))
    a = build_flagship_scene(16, device="cpu")
    b = build_flagship_scene(16, device="cpu", mesh_path=path)

    def tensors(x):
        if torch.is_tensor(x):
            return [x]
        if dataclasses.is_dataclass(x):
            return [t for f in dataclasses.fields(x)
                    for t in tensors(getattr(x, f.name))]
        return []

    for xa, xb in zip(a[1:], b[1:]):
        ta, tb = tensors(xa), tensors(xb)
        assert len(ta) == len(tb) > 0
        for u, v in zip(ta, tb):
            assert torch.equal(u, v)
    ga, gb = a[0], b[0]
    assert ga.positions.shape == gb.positions.shape
    assert torch.equal(ga.tri_obj, gb.tri_obj)
    for f in ("positions", "normals", "uvs", "vtx_obj"):
        assert torch.equal(getattr(ga, f)[ga.indices],
                           getattr(gb, f)[gb.indices]), f
    cam, _ = flagship_camera(0, a[3], 64, 36, device="cpu")
    sa, sb = [scene_setup(g.positions, g.normals, g.uvs, g.indices,
                          g.vtx_obj, g.tri_obj, o.model, o.normal_mat,
                          cam.viewproj, 64, 36) for g, o, *_ in (a, b)]
    assert torch.equal(sa.valid, sb.valid)
    for f in ("coef", "iw", "ziw", "bbox"):
        assert torch.equal(getattr(sa, f)[sa.valid],
                           getattr(sb, f)[sb.valid]), f
