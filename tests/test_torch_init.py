"""The port's initializers (gifgan_tpu_torch/ops/nn.py) against the JAX
package's (gifgan_tpu/ops/nn.py:32-46, :240-245), as distributions: the
parity tests elsewhere overwrite the state with converted JAX params, so
these are the only check of a port-side init.

Samples of 10^6 values each. Tolerances, each with its reason: the sample
std of N draws has a relative standard error of at most sqrt(2/(4N)) =
7.1e-4 (kurtosis 3 or less), so 1 % is 14 of them, and two samples'
stds agree within 1.5 %; a mean within 1e-4 is more than five standard
errors of 0.02/sqrt(N); the 5 %, 25 %, 50 %, 75 % and 95 % quantiles of
two samples agree within 0.02 sigma, 6.7 standard errors of the
difference at the 5 % quantile (sqrt(2 p (1 - p) / N) / density there)
and more nearer the median.
"""

import jax
import numpy as np
import pytest
import torch

from gifgan_tpu.ops import nn as jnn
from gifgan_tpu_torch.ops import nn as tnn

N, STD = 1_000_000, 0.02
# std of a unit normal truncated to +-2
TRUNC_STD = 0.879596


def _port(kind, shape, stddev=STD, seed=0):
    gen = torch.Generator().manual_seed(seed)
    fn = tnn.truncated_normal_init if kind == "trunc" else tnn.normal_init
    return fn(gen, shape, stddev).numpy()


def _jax(kind, shape, stddev=STD):
    fn = jnn.truncated_normal_init if kind == "trunc" else jnn.normal_init
    return np.asarray(fn(jax.random.PRNGKey(0), shape, stddev))


def _same_distribution(a, b, sigma):
    a, b = a.ravel(), b.ravel()
    assert abs(a.mean()) < 1e-4 * sigma / STD
    np.testing.assert_allclose(a.std(), b.std(), rtol=0.015)
    q = [0.05, 0.25, 0.5, 0.75, 0.95]
    np.testing.assert_allclose(np.quantile(a, q), np.quantile(b, q),
                               rtol=0, atol=0.02 * sigma)


@pytest.mark.parametrize("kind", ["trunc", "normal"])
def test_initializer_matches_the_jax_distribution(kind):
    got, want = _port(kind, (N,)), _jax(kind, (N,))
    assert got.dtype == np.float32 and got.shape == (N,)
    _same_distribution(got, want, STD)
    if kind == "trunc":
        # +-2 sigma, reached: a truncated normal, not a clipped one
        assert np.abs(got).max() <= 2 * STD
        assert np.abs(got).max() > 1.99 * STD
        assert (np.abs(got) == 2 * STD).mean() < 1e-5
        np.testing.assert_allclose(got.std(), TRUNC_STD * STD, rtol=0.01)
    else:
        assert np.abs(got).max() > 4 * STD
        np.testing.assert_allclose(got.std(), STD, rtol=0.01)


def test_the_stddev_argument_scales():
    got = _port("trunc", (N,), stddev=0.5)
    assert np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got.std(), TRUNC_STD * 0.5, rtol=0.01)


@pytest.mark.parametrize("layer", ["conv2d", "deconv2d", "conv3d", "linear"])
def test_layer_inits(layer):
    """Each layer's weight has the JAX layer's distribution (truncated for
    the convs, normal for the deconv and the linear) in the port's layout,
    and its bias is zero, or bias_start for the linear."""
    gen = torch.Generator().manual_seed(1)
    key = jax.random.PRNGKey(1)
    if layer == "conv2d":
        got = tnn.conv2d_init(gen, 256, 160)
        want = jnn.conv2d_init(key, 256, 160)
        shape = (160, 256, 5, 5)
    elif layer == "deconv2d":
        got = tnn.deconv2d_init(gen, 160, 256)
        want = jnn.deconv2d_init(key, 160, 256)
        shape = (160, 256, 5, 5)
    elif layer == "conv3d":
        got = tnn.conv3d_init(gen, 200, 190)
        want = jnn.conv3d_init(key, 200, 190)
        shape = (190, 200, 3, 3, 3)
    else:
        got = tnn.linear_init(gen, 1000, 1000, bias_start=0.5)
        want = jnn.linear_init(key, 1000, 1000, bias_start=0.5)
        shape = (1000, 1000)
    w, jw = got["w"].numpy(), np.asarray(want["w"])
    assert w.shape == shape and w.dtype == np.float32
    assert w.size == jw.size
    _same_distribution(w, jw, STD)
    if layer in ("conv2d", "conv3d"):
        assert np.abs(w).max() <= 2 * STD
    else:
        assert np.abs(w).max() > 4 * STD
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
    assert got["b"].dtype == torch.float32
    assert float(got["b"][0]) == (0.5 if layer == "linear" else 0.0)
