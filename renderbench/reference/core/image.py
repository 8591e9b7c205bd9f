"""Bilinear resizing with jax.image.resize(..., "bilinear") semantics.

jax.image.resize (jax/_src/image/scale.py: compute_weight_mat,
_scale_and_translate) builds one weight matrix per resized axis: output
sample j sits at s = (j + 0.5) / scale - 0.5 in input pixels (half-pixel
centres), input pixel i weighs max(0, 1 - |s - i|) (the triangle kernel),
each column is divided by its sum (the weights that fall outside the image
are dropped and the rest renormalised), and a column whose sample lies
outside [-0.5, m - 0.5] is zeroed.  Everything is computed in float32, as
there.  F.interpolate rounds its scale differently on odd sizes, so the
matrices are built here explicitly.

For upsampling the triangle kernel reaches only floor(s) and floor(s) + 1,
so each output is the two-tap sum w0 * x[i0] + w1 * x[i1] with both weights
read from the matrix: the same function as the matrix product, whose other
terms are exact zeros, without its (m, n) multiply.  Downsampling widens
the kernel to 1 / scale input pixels (jax's antialias), so every input in
reach weighs in: that axis is the matrix product itself (in float32, summed
in torch's order, not XLA's).
"""

from __future__ import annotations

import functools

import torch


def _samples(m: int, n: int):
    """(n,) f32 sample positions in input pixels and 1 / scale, rounded to
    f32 from Python's double 1 / (n / m) as jax rounds it."""
    inv_scale = torch.tensor(1.0 / (n / m), dtype=torch.float32)
    return (torch.arange(n, dtype=torch.float32) + 0.5) * inv_scale - 0.5, \
        inv_scale


def resize_weights(m: int, n: int, device=None):
    """(m, n) f32: jax.image.resize's bilinear weight matrix for resizing an
    axis of m samples to n (weight of input i in output j)."""
    sample, inv_scale = _samples(m, n)
    x = torch.abs(sample[None, :]
                  - torch.arange(m, dtype=torch.float32)[:, None])
    # Upsampling: the kernel is not widened (kernel_scale = max(1/scale, 1)).
    x = x / torch.clamp(inv_scale, min=1.0)
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


@functools.cache
def _weights_on(m: int, n: int, device):
    """resize_weights(m, n) on `device`, made once per (m, n, device): a
    constant of the frame, which a captured frame reads and never
    uploads."""
    return resize_weights(m, n, device)


@functools.cache
def _taps(m: int, n: int, device):
    """The two taps of each output of an upsampled axis: (i0, i1) int64 and
    (w0, w1) f32, each (n,) on `device`, read from resize_weights; made
    once per (m, n, device), as _weights_on."""
    w = resize_weights(m, n)
    j = torch.arange(n)
    sample, _ = _samples(m, n)
    i0 = torch.clamp(torch.floor(sample).to(torch.int64), 0, m - 1)
    i1 = torch.clamp(i0 + 1, max=m - 1)
    w0 = w[i0, j]
    w1 = torch.where(i1 != i0, w[i1, j], torch.zeros_like(w0))
    return (i0.to(device), i1.to(device), w0.to(device), w1.to(device))


def _resize_axis(x, axis: int, n: int):
    m = x.shape[axis]
    if n == m:
        return x
    if n < m:
        w = _weights_on(m, n, x.device)
        return torch.movedim(
            torch.tensordot(torch.movedim(x, axis, -1), w, dims=1), -1, axis)
    i0, i1, w0, w1 = _taps(m, n, x.device)
    shape = [1] * x.ndim
    shape[axis] = n
    a = torch.index_select(x, axis, i0)
    b = torch.index_select(x, axis, i1)
    return a * w0.view(shape) + b * w1.view(shape)


def resize_bilinear(x, shape):
    """x resized to `shape` (same rank), every axis whose size changes
    resized bilinearly as jax.image.resize(x, shape, "bilinear") does;
    axes are resized in order.  Float32 in, float32 out."""
    if len(shape) != x.ndim:
        raise ValueError(f"resize_bilinear: shape {tuple(shape)} does not "
                         f"match rank {x.ndim}")
    for axis, n in enumerate(shape):
        x = _resize_axis(x, axis, int(n))
    return x
