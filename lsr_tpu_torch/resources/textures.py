"""Texture loading + registry (port of lsr_tpu/resources/textures.py:
load_texture_linear, ResourceRegistry).

PNGs come in through the dependency-free reader, are decoded sRGB ->
linear at upload (gamma 2.2, as the reference decodes each sample,
builtin_shaders.hpp:25-54) and stack into the (NT, S, S, 3) array the
samplers take (as a tensor: torch.as_tensor(registry.texture_array(),
device=...)).  The handle registry mirrors the reference's
ResourceRegistry (resources/resource_registry.hpp:23).  Host-side numpy,
as lsr_tpu's.
"""

from __future__ import annotations

import numpy as np

from lsr_tpu_torch.io.png import read_png


def load_texture_linear(path: str, size: int | None = None) -> np.ndarray:
    """PNG -> (S, S, 3) f32 linear.  Optional nearest resize to `size`."""
    img = read_png(path).astype(np.float32)
    if img.shape[-1] == 4:
        img = img[..., :3]
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    img = (img / 255.0) ** 2.2
    if size is not None and img.shape[:2] != (size, size):
        ys = (np.arange(size) * img.shape[0] / size).astype(np.int32)
        xs = (np.arange(size) * img.shape[1] / size).astype(np.int32)
        img = img[ys][:, xs]
    return img.astype(np.float32)


class ResourceRegistry:
    """Handle tables for meshes / textures / materials (handles are dense
    ints)."""

    def __init__(self):
        self._meshes = []
        self._textures = []
        self._materials = []

    def add_mesh(self, mesh) -> int:
        self._meshes.append(mesh)
        return len(self._meshes) - 1

    def get_mesh(self, handle: int):
        return self._meshes[handle] if 0 <= handle < len(self._meshes) \
            else None

    def add_texture(self, tex_linear: np.ndarray) -> int:
        if self._textures and tex_linear.shape != self._textures[0].shape:
            raise ValueError(
                "texture array requires uniform sizes; resize at load "
                f"(got {tex_linear.shape}, have {self._textures[0].shape})")
        self._textures.append(np.asarray(tex_linear, np.float32))
        return len(self._textures) - 1

    def load_texture(self, path: str, size: int | None = None) -> int:
        want = size
        if want is None and self._textures:
            want = self._textures[0].shape[0]
        return self.add_texture(load_texture_linear(path, want))

    def texture_array(self):
        """(NT, S, S, 3) stacked linear texture array (None when empty)."""
        if not self._textures:
            return None
        return np.stack(self._textures)

    def add_material(self, **fields) -> int:
        self._materials.append(fields)
        return len(self._materials) - 1

    def materials(self):
        return list(self._materials)

    def counts(self):
        return {"meshes": len(self._meshes),
                "textures": len(self._textures),
                "materials": len(self._materials)}
