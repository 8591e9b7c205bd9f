"""Wireframe rendering: the HelloWireframe capability (port of
lsr_tpu/raster/wireframe.py; hello_wireframe.cpp:11).

Reference semantics reproduced exactly:
- pixel mapping: x = int((v.x + 1) * W / 2), y = int((v.y + 1) * H / 2)
  (truncation, bottom-left canvas origin, no aspect correction),
- per face only edges (v0,v1) and (v1,v2) are drawn (the k>0 loop),
- an edge is drawn only when BOTH endpoints are strictly inside (0, W) x (0, H),
- Bresenham coverage, single color.

Edges and the projection are built on the host in float64 numpy, as
lsr_tpu builds them; the draw is rasterize_lines on the device (lsr_tpu
jits it; here it runs eagerly).
"""

from __future__ import annotations

import numpy as np
import torch

from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.io.obj import MeshData
from lsr_tpu_torch.raster.lines import rasterize_lines


def wireframe_edges(mesh: MeshData) -> np.ndarray:
    """(E, 2) vertex-index pairs: edges (v0,v1), (v1,v2) per triangle."""
    idx = mesh.indices
    return np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]]], axis=0)


def project_ndc_unit(positions: np.ndarray, width: int, height: int) -> np.ndarray:
    """Identity 'projection' of the demo: model coords treated as NDC.

    Computed in float64 with truncation toward zero, as the C++ demo's
    double-precision int casts do.
    """
    p = positions.astype(np.float64)
    x = ((p[:, 0] + 1.0) * width / 2.0).astype(np.int32)
    y = ((p[:, 1] + 1.0) * height / 2.0).astype(np.int32)
    return np.stack([x, y], axis=-1)


def render_wireframe(mesh: MeshData, width: int, height: int,
                     color=(0, 255, 0), bg=(0, 0, 0),
                     device=None) -> torch.Tensor:
    """Render a mesh wireframe to a (H, W, 3) u8 canvas (bottom-left
    origin) on `device` (default: the card)."""
    device = resolve_device(device)
    edges = wireframe_edges(mesh)
    pix = project_ndc_unit(mesh.positions, width, height)
    p0, p1 = pix[edges[:, 0]], pix[edges[:, 1]]

    def inside(p):  # the demo's strict interior test
        return ((p[:, 0] > 0) & (p[:, 0] < width) & (p[:, 1] > 0)
                & (p[:, 1] < height))

    keep = inside(p0) & inside(p1)
    canvas = torch.as_tensor(bg, dtype=torch.uint8, device=device).expand(
        height, width, 3)
    return rasterize_lines(canvas, p0[keep], p1[keep], color,
                           max_steps=width + height)
