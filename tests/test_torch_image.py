"""lsr_tpu_torch.core.image.resize_bilinear vs jax.image.resize(..., "bilinear")
(CPU), the upsampling that lsr_tpu's strided sun visibility and local-shadow
planes use (passes/forward_plus.py:99-107, lighting/local_shadows.py:954)
and the downsampling of the engine synth's spectrogram.

Inputs are seeded numpy arrays, on odd and even sizes.  The weight matrices
are jax's own computation in f32, so they are equal bit for bit; the resized
values agree within 1e-6 (jax contracts with a dot whose summation order and
fused multiply-adds differ from the two-tap sum; inputs lie in [0, 1]).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CASES = [((3, 54, 96), (3, 108, 192)), ((1, 5, 7), (1, 9, 13)),
         ((2, 3, 3), (2, 7, 5)), ((1, 270, 480), (1, 540, 960)),
         ((4, 6, 1), (4, 11, 1)), ((1, 4, 6), (1, 4, 11))]


@pytest.mark.parametrize("src,dst", CASES)
def test_resize_bilinear_matches_jax(src, dst):
    from lsr_tpu_torch.core.image import resize_bilinear

    x = np.random.default_rng(sum(src)).uniform(0.0, 1.0, src).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    got = resize_bilinear(torch.as_tensor(x), dst).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("m,n", [(5, 9), (54, 108), (3, 7), (7, 7), (270, 541),
                                 (9, 5), (512, 128)])
def test_resize_weights_match_jax(m, n):
    """The (m, n) weight matrix equals jax's compute_weight_mat bit for bit:
    half-pixel centres, the triangle kernel, out-of-range weights dropped
    and the rest renormalised."""
    from jax._src.image.scale import ResizeMethod, _kernels, compute_weight_mat

    from lsr_tpu_torch.core.image import resize_weights

    want = np.asarray(compute_weight_mat(
        m, n, n / m, 0.0, _kernels[ResizeMethod.LINEAR], True))
    np.testing.assert_array_equal(resize_weights(m, n).numpy(), want)


def test_resize_bilinear_refuses_downsampling():
    """The name is kept from when the port refused to downsample: an axis
    that shrinks now widens the triangle kernel to 1 / scale input pixels
    (jax's antialias) and is the matrix product, as jax.image.resize does
    (the engine synth's spectrogram at 12 kHz: 682 bins to 64 rows, 512
    columns to 128).  Values within 1e-6; a rank mismatch still raises."""
    from lsr_tpu_torch.core.image import resize_bilinear

    rng = np.random.default_rng(8)
    for src, dst in (((8, 8), (4, 8)), ((682, 512), (64, 128)),
                     ((3, 9, 5), (3, 4, 11))):
        x = rng.uniform(0.0, 1.0, src).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
        got = resize_bilinear(torch.as_tensor(x), dst).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    with pytest.raises(ValueError, match="rank"):
        resize_bilinear(torch.zeros(8, 8), (4,))
