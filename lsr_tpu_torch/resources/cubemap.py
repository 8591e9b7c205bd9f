"""Cubemap loading from image files (port of lsr_tpu/resources/cubemap.py:
FACE_FILES, load_cubemap).

The analog of the reference's 6-face cubemap load (hello_ibl_skybox.cpp:
1613-1618: right / left / top / bottom / front / back into CubemapData)
that feeds CubemapSky sampling (cubemap_sky.hpp:73-115).  sky_models.
sample_cubemap uses the same face and (u, v) conventions, so a loaded set
goes straight into the sky pass and the IBL precompute (as a tensor:
torch.as_tensor(faces, device=...)).  Host-side numpy, as lsr_tpu's.
"""

from __future__ import annotations

import os

import numpy as np

from lsr_tpu_torch.io.png import read_png

# The reference's file-name order: face k of [+X, -X, +Y, -Y, +Z, -Z].
FACE_FILES = ("right", "left", "top", "bottom", "front", "back")


def _srgb_to_linear(x):
    a = x / 12.92
    b = ((x + 0.055) / 1.055) ** 2.4
    return np.where(x <= 0.04045, a, b)


def _box_downsample(img, out_size: int):
    s = img.shape[0]
    if s == out_size:
        return img
    if s % out_size != 0:
        raise ValueError(f"cubemap face {s} not divisible by {out_size}")
    f = s // out_size
    return img.reshape(out_size, f, out_size, f, img.shape[-1]).mean((1, 3))


def load_cubemap(path_or_paths, size: int | None = 512, srgb: bool = True,
                 ext: str = "png"):
    """A 6-face cubemap image set -> (6, S, S, 3) f32 LINEAR numpy.

    path_or_paths: a directory holding right / left / top / bottom / front /
    back images (the reference's names), or a list of 6 paths in [+X, -X,
    +Y, -Y, +Z, -Z] order.  size: an optional box-downsample target.  Each
    face is flipped vertically on load, so its row 0 (v = 0) is the BOTTOM
    texel row, as sample_cubemap reads it; sRGB faces are decoded with the
    exact piecewise sRGB curve."""
    if isinstance(path_or_paths, (list, tuple)):
        paths = list(path_or_paths)
    else:
        paths = [os.path.join(path_or_paths, f"{n}.{ext}")
                 for n in FACE_FILES]
    if len(paths) != 6:
        raise ValueError("need exactly 6 cubemap faces")

    faces = []
    for p in paths:
        img = read_png(p).astype(np.float32) / 255.0
        img = img[..., :3]
        img = img[::-1]  # row 0 becomes the bottom (v = 0)
        if srgb:
            img = _srgb_to_linear(img)
        if size is not None:
            img = _box_downsample(img, size)
        faces.append(img.astype(np.float32))
    shapes = {f.shape for f in faces}
    if len(shapes) != 1:
        raise ValueError(f"cubemap face shapes differ: {shapes}")
    return np.stack(faces)
