"""Port resize ops vs the JAX package (CPU, float32).

The interpolation matrices are built by the same numpy code and must be
equal.  Resampled tensors agree to rtol 1e-5 (float32 matmuls in another
summation order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openpose_tpu.ops import resize as jresize
from openpose_tpu_torch.ops import resize
from tests import oracle


@pytest.mark.parametrize("args", [
    (48, 6, 8.0), (36, 9, 4.0), (80, 10, 8.0 / 0.7),        # Catmull-Rom
    (40, 23, 1.8, -0.75, False), (16, 30, 0.5, -0.75, False),  # Keys, grid
])
def test_cubic_matrix_equal(args):
    np.testing.assert_array_equal(resize._cubic_matrix(*args),
                                  jresize._cubic_matrix(*args))


@pytest.mark.parametrize("args", [(16, 30, 0.5), (368, 720, 0.511),
                                  (12, 20, 0.6, True)])
def test_bilinear_matrix_equal(args):
    np.testing.assert_array_equal(resize._bilinear_matrix(*args),
                                  jresize._bilinear_matrix(*args))


@pytest.mark.parametrize("in_hw,scale,target", [
    ((20, 30), 0.5, (16, 16)),       # downscale: bilinear, black border
    ((37, 53), 0.43, (16, 32)),
    ((9, 13), 1.7, (16, 32)),        # upscale: Keys cubic, rows zeroed
])
def test_resize_fixed_aspect_matches_jax(in_hw, scale, target):
    img = np.random.RandomState(0).uniform(
        0, 255, (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_fixed_aspect(jnp.asarray(img), scale,
                                                  target))
    got = resize.resize_fixed_aspect(torch.from_numpy(img), scale,
                                     target).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_upsample_merge_two_scales_matches_jax():
    rng = np.random.RandomState(1)
    s0 = rng.randn(2, 6, 10, 5).astype(np.float32)
    s1 = rng.randn(2, 4, 8, 5).astype(np.float32)
    ratios = [1.0, 0.7]
    want = np.asarray(jresize.upsample_merge(
        [jnp.asarray(s0), jnp.asarray(s1)], ratios, (48, 80)))
    got = resize.upsample_merge([torch.from_numpy(s0), torch.from_numpy(s1)],
                                ratios, (48, 80)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resize_bicubic_matches_oracle():
    src = np.random.RandomState(2).randn(9, 7).astype(np.float32)
    want = oracle.cubic_resize_oracle(src, 36, 28)
    got = resize.resize_bicubic(torch.from_numpy(src[None, :, :, None]),
                                (36, 28))[0, :, :, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_normalize_vgg():
    x = np.arange(0, 256, 17, dtype=np.float32)
    np.testing.assert_array_equal(
        resize.normalize_vgg(torch.from_numpy(x)).numpy(),
        np.asarray(jresize.normalize_vgg(jnp.asarray(x))))
