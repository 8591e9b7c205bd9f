"""The reference's raster (reference/raster/brute.py walks each chunk of
rows over the chunk's joint bbox) against a plain per-pixel raster that
tests every valid triangle at every pixel centre: bit for bit, on a frame
of many chunks, whole and in screen bands (y_offset)."""

import numpy as np
import pytest
import torch

from renderbench.reference.raster.brute import depth_params, rasterize_brute
from renderbench.reference.raster.setup import CULL_NONE, build_setup

W, H = 80, 48
ZN, ZF = 0.1, 10.0


def scene(n=1200, seed=11):
    """n small triangles in clip space, scattered over and past the
    frame, some overlapping in depth, some off screen or behind."""
    g = np.random.default_rng(seed)
    w = g.uniform(0.5, 4.0, (n, 1))
    centre = g.uniform(-1.3, 1.3, (n, 1, 2))
    corners = centre + g.uniform(-0.25, 0.25, (n, 3, 2))
    z = g.uniform(-0.9, 0.9, (n, 3, 1))
    clip = np.concatenate([corners, z, np.ones((n, 3, 1))], -1) * w[:, None]
    clip[::97, :, 3] = -1.0                       # behind the camera
    clip = torch.tensor(clip, dtype=torch.float32)
    return build_setup(clip, {}, torch.ones(n, dtype=torch.bool),
                       torch.zeros(n, dtype=torch.int64), W, H,
                       cull_mode=CULL_NONE)


def plain(st, rows):
    """Every valid triangle at every pixel centre of `rows` (global rows
    of the H-row frame), the lexicographic (depth, triangle id) minimum
    below depth 1, in the reference's float32 operations and order."""
    f = np.float32
    c = st.coef.numpy()[:, :, None, None]
    iw = st.iw.numpy()[:, :, None, None]
    px = (np.arange(W, dtype=f) + f(0.5))[None, None, :]
    py = (np.asarray(rows, dtype=f) + f(0.5))[None, :, None]
    bc = [(c[:, 3 * i] * px + c[:, 3 * i + 1] * py) + c[:, 3 * i + 2]
          for i in range(3)]
    denom = (bc[0] * iw[:, 0] + bc[1] * iw[:, 1]) + bc[2] * iw[:, 2]
    inside = ((bc[0] >= 0) & (bc[1] >= 0) & (bc[2] >= 0) & (px <= W - 1)
              & (py <= H - 1) & (denom > f(1e-10))
              & st.valid.numpy()[:, None, None])
    zn, inv = (f(v) for v in depth_params(ZN, ZF))
    view_z = f(1.0) / np.maximum(denom, f(1e-10))
    z01 = np.clip((view_z - zn) * inv, f(0), f(1))
    cand = np.where(inside & (z01 < 1), z01, np.inf).astype(f)
    tid = np.argmin(cand, 0).astype(np.int32)      # first minimum: lowest id
    depth = np.take_along_axis(cand, tid[None].astype(np.int64), 0)[0]
    hit = np.isfinite(depth)
    return (np.where(hit, depth, f(1)).astype(f),
            np.where(hit, tid, -1).astype(np.int32))


@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("bands", [[(0, H)], [(0, 16), (16, 5), (21, 27)]],
                         ids=["whole", "bands"])
def test_brute_is_the_plain_per_pixel_raster(chunk, bands):
    st = scene()
    assert int(st.valid.sum()) // chunk >= 8       # many chunks
    for y0, rows in bands:
        depth, tid = rasterize_brute(st, W, rows, ZN, ZF, chunk=chunk,
                                     y_offset=y0, full_height=H)
        want_d, want_t = plain(st, range(y0, y0 + rows))
        assert (want_t >= 0).mean() > 0.3
        assert np.array_equal(tid.numpy(), want_t), (y0, chunk)
        assert np.array_equal(depth.numpy(), want_d), (y0, chunk)


def test_the_plain_raster_sees_a_lost_triangle():
    """The comparison's own check: the reference with one triangle's
    coverage dropped is caught."""
    st = scene()
    want_d, want_t = plain(st, range(H))
    ids, counts = np.unique(want_t[want_t >= 0], return_counts=True)
    drop = int(ids[np.argmax(counts)])
    st.valid[drop] = False
    _, tid = rasterize_brute(st, W, H, ZN, ZF)
    assert not np.array_equal(tid.numpy(), want_t)
