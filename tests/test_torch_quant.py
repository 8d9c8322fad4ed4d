"""The port's int8 layers (gifgan_tpu_torch/ops/quant.py) against the JAX
package's (gifgan_tpu/ops/quant.py) on the same numpy inputs, and against
the numpy integer oracles of tests/test_quant.py.

Weights are made in the JAX layouts and transposed into the port's
(linear (in, out) both; deconv (k, k, out, in) -> (in, out, k, k); conv2d
HWIO -> OIHW). Per-layer comparisons start from identical folded float32
weights: the two packages' rsqrt differ by an ulp on about a third of
inputs, so folding itself is held to rtol 1e-6, not to bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.ops import quant as jquant
from gifgan_tpu_torch.ops import nn as tnn
from gifgan_tpu_torch.ops import quant

_PERM = {"linear": (0, 1), "deconv": (3, 2, 0, 1), "conv2d": (3, 2, 0, 1)}
_JAX_OUT_AXIS = {"linear": 1, "deconv": 2, "conv2d": 3}
_PORT_OUT_AXIS = {"linear": 1, "deconv": 1, "conv2d": 0}
_SHAPES = {"linear": (24, 40), "deconv": (5, 5, 8, 16),
           "conv2d": (5, 5, 6, 12)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    in each keeps the many small ops of calibration and finishing from
    oversubscribing the cores (with 8 threads a worker, a finishing run
    took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_w(kind, w):
    return _t(np.transpose(w, _PERM[kind]))


def _jax_w(kind, w):
    return np.transpose(np.asarray(w), np.argsort(_PERM[kind]))


def _rand_bn(rng, ch):
    params = {"scale": (1.0 + 0.3 * rng.standard_normal(ch)).astype(
        np.float32), "bias": (0.2 * rng.standard_normal(ch)).astype(
        np.float32)}
    state = {"mean": (0.5 * rng.standard_normal(ch)).astype(np.float32),
             "var": np.exp(0.5 * rng.standard_normal(ch)).astype(np.float32)}
    return params, state


@pytest.mark.parametrize("kind", ["linear", "deconv"])
def test_fold_bn_matches_jax(kind):
    """rtol 1e-6 (atol 1e-7 for biases that fold to ~0): the folded
    weight is w * scale * rsqrt(var + eps) in both, and the two rsqrt
    differ by up to one ulp."""
    rng = np.random.default_rng(0)
    shape = _SHAPES[kind]
    out = shape[_JAX_OUT_AXIS[kind]]
    w = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    b = (0.1 * rng.standard_normal(out)).astype(np.float32)
    bp, bs = _rand_bn(rng, out)
    want = jquant.fold_bn({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          bp, bs, out_axis=_JAX_OUT_AXIS[kind])
    got = quant.fold_bn({"w": _port_w(kind, w), "b": _t(b)},
                        {k: _t(v) for k, v in bp.items()},
                        {k: _t(v) for k, v in bs.items()},
                        out_axis=_PORT_OUT_AXIS[kind])
    np.testing.assert_allclose(_jax_w(kind, got["w"].numpy()),
                               np.asarray(want["w"]), rtol=1e-6)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["linear", "deconv", "conv2d"])
def test_quantize_weight_bit_equal(kind):
    """From identical folded float32 weights: wq and ws bit-equal after the
    layout transpose (both divide by the scale and round half to even)."""
    rng = np.random.default_rng(1)
    shape = _SHAPES[kind]
    out = shape[_JAX_OUT_AXIS[kind]]
    w = (5 * rng.standard_normal(shape)).astype(np.float32)
    b = rng.standard_normal(out).astype(np.float32)
    want = jquant.quantize_weight({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                  out_axis=_JAX_OUT_AXIS[kind])
    got = quant.quantize_weight({"w": _port_w(kind, w), "b": _t(b)},
                                out_axis=_PORT_OUT_AXIS[kind])
    assert got["wq"].dtype == torch.int8
    np.testing.assert_array_equal(_jax_w(kind, got["wq"].numpy()),
                                  np.asarray(want["wq"]))
    np.testing.assert_array_equal(got["ws"].numpy(), np.asarray(want["ws"]))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


def test_quantize_act_bit_equal_with_ties():
    """Random activations bit-equal; and with max|x| = 127 (scale exactly
    1) planted .5 ties round half to even in both: 2.5 -> 2, -3.5 -> -4,
    0.5 -> 0, 126.5 -> 126."""
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((7, 9, 11))).astype(np.float32)
    for v in (x, np.array([127.0, 2.5, -3.5, 0.5, 126.5, -1.5],
                          np.float32)):
        wq, ws = jquant.quantize_act(jnp.asarray(v))
        gq, gs = quant.quantize_act(_t(v))
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert gs.ndim == 0 and gq.dtype == torch.int8
    np.testing.assert_array_equal(gq.numpy(), [127, 2, -4, 0, 126, -2])


def _oracle_xq(x):
    s_x = max(np.abs(x).max() / 127.0, 1e-12)
    return np.clip(np.round(x / s_x), -127, 127).astype(np.int64), s_x


def test_qlinear_matches_int_oracle_and_jax():
    """tests/test_quant.py's numpy int64 oracle and JAX's qlinear:
    rtol/atol 1e-6 (the int32 accumulator is exact; the epilogue is one
    float32 product and add)."""
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((9, 32))).astype(np.float32)
    layer = {"w": (2 * rng.standard_normal((32, 16))).astype(np.float32),
             "b": (np.arange(16) / 7).astype(np.float32)}
    q = quant.quantize_weight({k: _t(v) for k, v in layer.items()}, 1)
    got = quant.qlinear(q, _t(x)).numpy()
    xq, s_x = _oracle_xq(x)
    want = (xq @ q["wq"].numpy().astype(np.int64)).astype(np.float32) \
        * (s_x * q["ws"].numpy()) + layer["b"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jq = jquant.quantize_weight({k: jnp.asarray(v) for k, v in
                                 layer.items()}, 1)
    np.testing.assert_allclose(got, np.asarray(jquant.qlinear(
        jq, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c", [3, 4, 8])
def test_qconv2d_matches_int_oracle_and_jax(c):
    """qconv2d (OIHW, stride-2 TF SAME) against the int64 oracle of
    tests/test_quant.py and JAX's qconv2d: rtol/atol 1e-6. Channel counts
    that the im2col copies a byte, 4 bytes and 8 bytes at a time."""
    rng = np.random.default_rng(4)
    x = (2 * rng.standard_normal((3, 8, 8, c))).astype(np.float32)
    w = rng.standard_normal((5, 5, c, 6)).astype(np.float32)       # HWIO
    b = np.linspace(-1, 1, 6).astype(np.float32)
    q = quant.quantize_weight({"w": _port_w("conv2d", w), "b": _t(b)}, 0)
    got = quant.qconv2d(q, _t(x)).numpy()
    assert got.shape == (3, 4, 4, 6)

    xq, s_x = _oracle_xq(x)
    wq = _jax_w("conv2d", q["wq"].numpy()).astype(np.int64)
    # TF SAME, n=8 k=5 s=2: pad_total = 3 -> (low 1, high 2)
    xp = np.pad(xq, ((0, 0), (1, 2), (1, 2), (0, 0)))
    acc = np.zeros((3, 4, 4, 6), np.int64)
    for i in range(5):
        for j in range(5):
            acc += np.einsum("bhwc,co->bhwo", xp[:, i:i + 8:2, j:j + 8:2],
                             wq[i, j])
    want = acc.astype(np.float32) * (s_x * q["ws"].numpy()) + b
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jq = jquant.quantize_weight({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                3)
    np.testing.assert_allclose(got, np.asarray(jquant.qconv2d(
        jq, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,ch", [(4, 6), (8, 16)])
def test_qdeconv2d_on_the_exact_grid(size, ch):
    """Activations and weights on the int8 grid (s_x = 1 by a planted 127):
    the sub-pixel int8 deconv equals the port's float deconv2d (atol 1e-5,
    as tests/test_quant.py; the float sums stay below 2^24) and JAX's
    lhs-dilated qdeconv2d; its accumulator is JAX's conv output exactly."""
    rng = np.random.default_rng(5 + size)
    x = rng.integers(-126, 127, (2, size, size, ch)).astype(np.float32)
    x[0, 0, 0, 0] = 127.0
    wq = rng.integers(-15, 16, (5, 5, 3, ch)).astype(np.int8)  # (k,k,o,i)
    s_w = np.array([0.25, 0.5, 0.125], np.float32)
    bias = np.array([1.0, -2.0, 0.5], np.float32)
    q = {"wq": _port_w("deconv", wq), "ws": _t(s_w), "b": _t(bias)}
    layer = {"w": _port_w("deconv", wq.astype(np.float32)
                          * s_w[None, None, :, None]), "b": _t(bias)}
    got = quant.qdeconv2d(q, _t(x)).numpy()
    assert got.shape == (2, 2 * size, 2 * size, 3)
    np.testing.assert_allclose(got, tnn.deconv2d(layer, _t(x)).numpy(),
                               rtol=0, atol=1e-5)
    jq = {"wq": jnp.asarray(wq), "ws": jnp.asarray(s_w),
          "b": jnp.asarray(bias)}
    np.testing.assert_allclose(got, np.asarray(jquant.qdeconv2d(
        jq, jnp.asarray(x))), rtol=0, atol=1e-5)

    acc = quant._deconv_acc(_t(x.astype(np.int8)), q["wq"])
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.astype(np.int8)),
        jnp.transpose(jnp.flip(jnp.asarray(wq), (0, 1)), (0, 1, 3, 2)),
        (1, 1), ((3, 2), (3, 2)), lhs_dilation=(2, 2),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [1, 16, 17, 1024])
@pytest.mark.parametrize("k", [100, 121, 576])
@pytest.mark.parametrize("n", [3, 12, 100, 8192])
def test_int8_matmul_pads_exactly(m, k, n):
    """The shapes of the flagship stack (vid/lin0 k = 121, vid/lin3 n =
    100, img/h0_lin k = 100, img/h4_deconv n = 12 in the sub-pixel form, a
    one-video request m = 16) padded to what torch._int_mm takes on the
    card: equal to the int64 product, exactly."""
    g = torch.Generator().manual_seed(m * 7 + k * 3 + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g)
    got = quant.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.long(), a.long() @ b.long())


def test_is_q_dispatch_on_a_mixed_tree():
    """A float_last tree keeps h4_deconv as float32 {'w','b'}: _is_q sends
    it to the float deconv (TF32 off), the int8 layers to the int8 path,
    in both packages alike."""
    rng = np.random.default_rng(7)
    w = (0.1 * rng.standard_normal((5, 5, 3, 8))).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    flt = {"w": _port_w("deconv", w), "b": _t(b)}
    q8 = quant.quantize_weight(flt, 1)
    assert not quant._is_q(flt) and quant._is_q(q8)
    np.testing.assert_array_equal(quant.qdeconv2d(flt, _t(x)).numpy(),
                                  tnn.deconv2d(flt, _t(x)).numpy())
    jflt = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    for tl, jl in ((flt, jflt), (q8, jquant.quantize_weight(jflt, 2))):
        np.testing.assert_allclose(
            quant.qdeconv2d(tl, _t(x)).numpy(),
            np.asarray(jquant.qdeconv2d(jl, jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)
    lin = {"w": _t((0.1 * rng.standard_normal((8, 5))).astype(np.float32)),
           "b": _t(np.zeros(5, np.float32))}
    xl = _t(rng.standard_normal((3, 8)).astype(np.float32))
    np.testing.assert_array_equal(quant.qlinear(lin, xl).numpy(),
                                  (xl @ lin["w"]).numpy())


@pytest.mark.parametrize("outlier", [True, False])
def test_mse_sweep_matches_jax(outlier):
    """tests/test_quant.py:382's cases: the sweep's values within 1e-5
    relative of JAX's (float32 means in another order), the same argmin
    (below 1.0 with the outlier, 1.0 without)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, 20000).astype(np.float32)
    if outlier:
        x[7] = 100.0
    s = np.float32(float(np.abs(x).max()) / quant.QMAX)
    want = np.asarray(jquant._mse_sweep(jnp.asarray(x), jnp.float32(s)))
    got = quant._mse_sweep(_t(x), torch.tensor(s)).numpy()
    assert quant.MSE_FRACTIONS == jquant.MSE_FRACTIONS
    np.testing.assert_allclose(got, want, rtol=1e-5)
    best = int(np.argmin(got))
    assert best == int(np.argmin(want))
    assert (quant.MSE_FRACTIONS[best] < 1.0) == outlier


@pytest.mark.cuda
def test_int8_contractions_on_card_equal_cpu():
    """int8_matmul over the padded shapes, and a deconv layer's accumulator
    (sub-pixel im2col, 8-byte copy units, column-major weights), on the
    card against the CPU: equal, integer for integer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's card path")
    g = torch.Generator().manual_seed(8)
    for m, k, n in ((1, 121, 100), (16, 100, 8192), (17, 576, 3),
                    (1024, 576, 12)):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g)
        got = quant.int8_matmul(a.cuda(), b.cuda())
        assert torch.equal(got.cpu(), a.long().mm(b.long()).int())
    x = torch.randint(-127, 128, (4, 8, 8, 64), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (64, 3, 5, 5), dtype=torch.int8, generator=g)
    got = quant._deconv_acc(x.cuda(), w.cuda())
    assert torch.equal(got.cpu(), quant._deconv_acc(x, w))
