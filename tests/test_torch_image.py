"""The port's image transforms (gifgan_tpu_torch/ops/image.py) against the
JAX package's (gifgan_tpu/ops/image.py), on the same numpy inputs.

resize_bilinear is jax.image.resize(..., "linear"), which filters on a
downscale; the tolerance 1e-5 relative to the values' range (0-255) is
float32 summation order of the two weight contractions. F.interpolate's
bilinear, which does not filter, is shown to be another function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gifgan_tpu.ops import image as jimage
from gifgan_tpu_torch.ops import image as timage

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("shape,out", [
    ((2, 37, 53, 3), (16, 20)),       # downscale both axes
    ((2, 16, 20, 3), (37, 53)),       # upscale both axes
    ((1, 64, 64, 1), (64, 21)),       # one axis kept, the other down
    ((3, 10, 7, 3), (10, 7)),         # identity
    ((5, 48, 48, 3), (64, 64)),       # batched leading axes, up
])
def test_resize_bilinear_equals_jax_image_resize(shape, out):
    x = RNG.uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), *out))
    got = timage.resize_bilinear(torch.from_numpy(x), *out).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * 1e-5)


def test_resize_bilinear_is_not_two_tap_bilinear_on_a_downscale():
    x = RNG.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    got = timage.resize_bilinear(torch.from_numpy(x), 16, 16)
    two_tap = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                            (16, 16), mode="bilinear", align_corners=False,
                            antialias=False).permute(0, 2, 3, 1)
    assert float((got - two_tap).abs().max()) > 10.0
    # the filtered downscale averages: a noise image loses most variance
    assert float(got.std()) < 0.5 * float(two_tap.std())


def test_uint8_input_and_a_single_image():
    x = RNG.integers(0, 256, (40, 30, 3), dtype=np.uint8)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), 20, 45))
    got = timage.resize_bilinear(torch.from_numpy(x), 20, 45).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * 1e-5)


def test_transform_pair_and_to_uint8():
    u8 = RNG.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    t = timage.transform(torch.from_numpy(u8))
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(jimage.transform(jnp.asarray(u8))))
    x = RNG.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    inv = timage.inverse_transform(torch.from_numpy(x))
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jimage.inverse_transform(jnp.asarray(x))))
    y = np.concatenate([RNG.uniform(-0.2, 1.2, 500),
                        np.arange(256) / 255.0, [0.5 / 255, 1.5 / 255]])
    y = y.astype(np.float32)
    np.testing.assert_array_equal(
        timage.to_uint8(torch.from_numpy(y)).numpy(),
        np.asarray(jimage.to_uint8(jnp.asarray(y))))


@pytest.mark.parametrize("n", [12, 16])
def test_merge_grid(n):
    x = RNG.uniform(0, 1, (n, 5, 7, 3)).astype(np.float32)
    got = timage.merge_grid(torch.from_numpy(x), 4, 4).numpy()
    want = np.asarray(jimage.merge_grid(jnp.asarray(x), 4, 4))
    assert got.shape == (20, 28, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("crop", [(10, None), (9, 12), (16, 16)])
def test_center_crop(crop):
    x = RNG.uniform(0, 1, (16, 21, 3)).astype(np.float32)
    got = timage.center_crop(torch.from_numpy(x), *crop).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jimage.center_crop(jnp.asarray(x), *crop)))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_write_png_round_trips(tmp_path, c):
    """The stdlib writer's file decodes (imageio, a test-only reader) to the
    pixels written."""
    imageio = pytest.importorskip("imageio.v2")
    img = RNG.integers(0, 256, (13, 17, c), dtype=np.uint8)
    path = str(tmp_path / "g.png")
    timage.write_png(path, img)
    back = np.asarray(imageio.imread(path))
    np.testing.assert_array_equal(back.reshape(img.shape), img)
