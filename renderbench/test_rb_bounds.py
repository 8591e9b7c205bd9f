"""The bound-counting functions of kernels B1 and B2, held to a tiny frame
counted by hand."""

import dataclasses

import torch

from renderbench.kernels import bounds


@dataclasses.dataclass
class Setup:
    bbox: torch.Tensor
    valid: torch.Tensor


def test_raster_direct_by_hand():
    # Three rows: a 3x2 bbox, a bbox half off a 10x8 target (x 8..11,
    # y 6..7 -> 2x2 on it), and an invalid row that counts nothing.
    st = Setup(bbox=torch.tensor([[1, 1, 3, 2], [8, 6, 11, 7], [0, 0, 9, 7]]),
               valid=torch.tensor([True, True, False]))
    ids = dict(setup=st, width=10, height=8, band_h=0, depth_mode=0,
               track_ids=True)
    depth_only = dict(ids, track_ids=False)
    n_bytes, n_ops = bounds.raster_direct([ids, depth_only])
    # records: 2 valid rows x 64 B, twice; depth + id (8 B) then depth
    # alone (4 B) for 80 pixels.
    assert n_bytes == 2 * (2 * 64) + 80 * 8 + 80 * 4
    assert n_ops == 2 * 25 * (3 * 2 + 2 * 2)
    assert bounds.bound_ms(3.35e9, 0) == 1.0
    assert bounds.bound_ms(0, 67e9) == 1.0


def test_shade_fused_by_hand():
    # A 128x64 frame (one 64x128 tile): 2 covered pixels facing +z, one
    # point light 1 unit in front of the first (range 2: live there) and
    # one out of range of both; no planes.
    h, w = 64, 128
    gbuf = torch.zeros(16, h, w)
    gbuf[5] = 1.0                          # normals +z
    gbuf[6, 0, 0] = gbuf[6, 0, 5] = 1.0    # covered
    gbuf[0, 0, 5] = 10.0                   # the second pixel far off in x
    rec = torch.zeros(1, 8, 32)

    from renderbench.reference.lighting.light_runtime import (
        pack_light_records)
    from renderbench.reference.lighting.light_types import LightSetBuilder

    lb = LightSetBuilder()
    lb.point((0.0, 0.0, 1.0), range=2.0)
    lb.point((-50.0, 0.0, 1.0), range=2.0)
    lights = lb.build("cpu")
    packed = pack_light_records(lights)
    rec[0, :2] = packed
    counts = torch.tensor([2])
    live, shadowed = bounds.live_pairs(gbuf, rec, counts, lights.kinds, 0, 0)
    assert (live, shadowed) == (1, 0)
    n_bytes, n_ops = bounds.shade_fused([dict(
        gbuf=gbuf, tile_rec=rec, counts=counts, vis_planes=None,
        lights=lights, width=w, height=h, slices=0)])
    assert n_bytes == (52 * 2 + 4 * (w * h - 2) + 4 * 1 + 4 * 2 + 128 * 2
                       + 12 * w * h)
    assert n_ops == 60 * 1 + 60 * 2
