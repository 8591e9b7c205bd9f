"""Shared plumbing of the demos: the command line, the stand-in mesh, a
scene's geometry as render_forward's batch, and the PNG edge."""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.io.obj import load_obj, make_uv_sphere
from lsr_tpu_torch.io.png import save_canvas_png
from lsr_tpu_torch.utils.host import fetch_image


def stand_in_mesh(obj_path: str | None = None):
    """The OBJ at obj_path, or the procedural UV sphere (16 rings, 32
    sectors) that stands in for lsr_tpu's monkey."""
    if obj_path:
        return load_obj(obj_path)
    return make_uv_sphere(rings=16, sectors=32)


def parser(doc: str, width: int | None, height: int | None,
           mesh: bool = True):
    """The demos' common flags: --device, --width, --height (not when width
    is None: a fixed-size demo), --obj, --out."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    if width is not None:
        p.add_argument("--width", type=int, default=width)
        p.add_argument("--height", type=int, default=height)
    if mesh:
        p.add_argument("--obj", default=None,
                       help="OBJ mesh in place of the UV-sphere stand-in")
    p.add_argument("--out", default="out", help="directory of the PNG")
    return p


def setup_device(device):
    """resolve_device, with full-float32 matmuls on the card (TF32 off)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def batch_of(geom) -> dict:
    """A GeometryBatch as render_forward's batch dict."""
    return {f.name: getattr(geom, f.name) for f in dataclasses.fields(geom)}


def covered(gb) -> int:
    return int(gb.covered.sum())


def lit_pixels(ldr) -> int:
    """Pixels of an LDR canvas with any channel above 0."""
    return int((ldr > 0).any(-1).sum())


def write_frame(out_dir: str, name: str, ldr) -> str:
    """Save an LDR canvas (bottom-left origin) as out_dir/name; returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    save_canvas_png(path, fetch_image(ldr))
    return path
