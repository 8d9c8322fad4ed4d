"""The port's layers (gifgan_tpu_torch/ops/nn.py) against the JAX package's
(gifgan_tpu/ops/nn.py): forward and VJP on the same numpy inputs, float32
on the CPU.

Tolerance: rtol 1e-5 plus an atol of 1e-5 x the largest |value| of the
compared array. The sums run in another order than XLA's (a 5x5 conv adds
25*C products), which moves results by a few ulp of the largest partial
sum; an element that cancels to near 0 has no relative precision left, so
a pure rtol would fail on it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.ops import nn as jnn
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.ops import nn as tnn


def _close(got, want, rtol=1e-5, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _port_params(name, jparams):
    """One layer's JAX params -> the port's, through core/interop."""
    flat = {f"{name}/{k}": np.asarray(v) for k, v in jparams.items()}
    return interop.from_jax_flat(flat, device="cpu").get(name, {})


def _check_vjp(jax_fn, port_fn, name, jparams, x, seed=0):
    """Forward and VJP (params and input) of one layer, both packages."""
    rng = np.random.default_rng(seed)
    y_j, vjp = jax.vjp(jax_fn, jparams, jnp.asarray(x))
    ct = rng.standard_normal(y_j.shape).astype(np.float32)
    dp_j, dx_j = vjp(jnp.asarray(ct))

    tparams = {k: v.requires_grad_(True)
               for k, v in _port_params(name, jparams).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y_t = port_fn(tparams, tx)
    _close(y_t.detach(), y_j, err_msg="forward")
    keys = sorted(tparams)
    grads = torch.autograd.grad(y_t, [tparams[k] for k in keys] + [tx],
                                torch.from_numpy(ct))
    _close(grads[-1], dx_j, err_msg="d input")
    back = interop.to_jax_flat({name: dict(zip(keys, grads[:-1]))})
    for k in keys:
        _close(back[f"{name}/{k}"], dp_j[k], err_msg=f"d {k}")


def _normal(rng, shape, std=1.0):
    return (std * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("hw,impl", [((8, 8), None), ((7, 9), None),
                                     ((8, 6), "s2d"), ((1, 2), None)])
def test_conv2d(hw, impl):
    rng = np.random.default_rng(1)
    p = {"w": _normal(rng, (5, 5, 3, 4), 0.2), "b": _normal(rng, (4,), 0.1)}
    x = _normal(rng, (2, *hw, 3))
    _check_vjp(lambda p, x: jnn.conv2d(p, x, impl=impl),
               lambda p, x: tnn.conv2d(p, x, impl=impl), "h0_conv", p, x)


@pytest.mark.parametrize("dhw", [(4, 4, 4), (3, 5, 2), (1, 1, 1)])
def test_conv3d(dhw):
    rng = np.random.default_rng(2)
    p = {"w": _normal(rng, (3, 3, 3, 4, 5), 0.2), "b": _normal(rng, (5,), 0.1)}
    x = _normal(rng, (2, *dhw, 4))
    _check_vjp(jnn.conv3d, tnn.conv3d, "h1_conv", p, x)


@pytest.mark.parametrize("impl", [None, "subpixel"])
@pytest.mark.parametrize("hw", [(4, 4), (3, 5)])
def test_deconv2d(impl, hw):
    rng = np.random.default_rng(3)
    p = {"w": _normal(rng, (5, 5, 3, 6), 0.2), "b": _normal(rng, (3,), 0.1)}
    x = _normal(rng, (2, *hw, 6))
    _check_vjp(lambda p, x: jnn.deconv2d(p, x, impl=impl),
               lambda p, x: tnn.deconv2d(p, x, impl=impl), "h1_deconv", p, x)


def test_deconv2d_output_shape_and_padding():
    """(m, m) -> (2m, 2m) with the (3, 2) transposed pads: a one-hot input
    pixel lands on the taps the gradient-of-conv form puts it on."""
    w = np.zeros((5, 5, 1, 1), np.float32)
    w[0, 0] = 1.0                                  # top-left tap only
    x = np.zeros((1, 3, 3, 1), np.float32)
    x[0, 1, 1] = 1.0
    p = {"w": w, "b": np.zeros(1, np.float32)}
    want = np.asarray(jnn.deconv2d(p, jnp.asarray(x)))
    got = tnn.deconv2d(_port_params("d_deconv", p), torch.from_numpy(x))
    assert got.shape == (1, 6, 6, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_linear():
    rng = np.random.default_rng(4)
    p = {"w": _normal(rng, (7, 5), 0.3), "b": _normal(rng, (5,), 0.1)}
    _check_vjp(jnn.linear, tnn.linear, "lin0", p, _normal(rng, (6, 7)))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(16, 6), (2, 3, 4, 5)])
def test_batch_norm(train, shape):
    rng = np.random.default_rng(5)
    c = shape[-1]
    p = {"scale": 1 + _normal(rng, (c,), 0.1), "bias": _normal(rng, (c,), 0.1)}
    s = {"mean": _normal(rng, (c,), 0.1),
         "var": (1 + 0.2 * rng.random(c)).astype(np.float32)}
    x = _normal(rng, shape, 2.0) + 0.5
    js = jax.tree_util.tree_map(jnp.asarray, s)
    _check_vjp(lambda p, x: jnn.batch_norm(p, js, x, train)[0],
               lambda p, x: tnn.batch_norm(p, {k: torch.from_numpy(v)
                                               for k, v in s.items()},
                                           x, train)[0], "bn0", p, x)
    _, ns_j = jnn.batch_norm(p, js, jnp.asarray(x), train)
    _, ns_t = tnn.batch_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             {k: torch.from_numpy(v) for k, v in s.items()},
                             torch.from_numpy(x), train)
    for k in ("mean", "var"):
        _close(ns_t[k], ns_j[k], err_msg=f"state {k}")
        assert not ns_t[k].requires_grad


def test_batch_norm_bf16_math_in_f32():
    """bf16 input: moments in f32, the output cast back to bf16."""
    rng = np.random.default_rng(6)
    x = _normal(rng, (32, 4), 3.0)
    p, s = tnn.batch_norm_init(4)
    y, ns = tnn.batch_norm(p, s, torch.from_numpy(x).to(torch.bfloat16),
                           True)
    assert y.dtype == torch.bfloat16 and ns["var"].dtype == torch.float32
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    _close(ns["var"], 0.9 + 0.1 * xb.var(0), err_msg="biased var EMA")


@pytest.mark.parametrize("fn", ["lrelu", "sigmoid_ce", "get_std"])
def test_elementwise_and_reductions(fn):
    rng = np.random.default_rng(7)
    x = _normal(rng, (6, 5), 2.0)
    labels = (rng.random((6, 5)) > 0.5).astype(np.float32)
    jf = {"lrelu": lambda p, x: jnn.lrelu(x),
          "sigmoid_ce": lambda p, x: jnn.sigmoid_ce(x, jnp.asarray(labels)),
          "get_std": lambda p, x: jnn.get_std(x)}[fn]
    tf = {"lrelu": lambda p, x: tnn.lrelu(x),
          "sigmoid_ce": lambda p, x: tnn.sigmoid_ce(x,
                                                    torch.from_numpy(labels)),
          "get_std": lambda p, x: tnn.get_std(x)}[fn]
    _check_vjp(jf, tf, "none", {}, x)


def test_add_noise_rules():
    """Python 0 skips the draw; a tensor std always draws; no generator
    adds none."""
    x = torch.ones(64, 8)
    g = torch.Generator().manual_seed(0)
    assert tnn.add_noise(g, x, 0.0) is x
    assert tnn.add_noise(None, x, 0.5) is x
    state = g.get_state()
    y = tnn.add_noise(g, x, torch.tensor(0.0))
    assert torch.equal(y, x) and not torch.equal(g.get_state(), state)
    y = tnn.add_noise(g, x, torch.tensor(0.5))
    assert 0.4 < float((y - x).std()) < 0.6


def test_truncated_normal_init_two_sigma():
    g = torch.Generator().manual_seed(0)
    w = tnn.truncated_normal_init(g, (200, 200), stddev=0.02)
    assert float(w.abs().max()) <= 0.04
    # a +-2 sigma truncation keeps ~0.88 of the normal's std
    assert 0.016 < float(w.std()) < 0.019


@pytest.mark.parametrize("packed", ["s2d", "subpixel"])
def test_packed_forms_match_plain_port(packed):
    """The s2d conv and the subpixel deconv compute the plain layers'
    function (same terms, other order)."""
    rng = np.random.default_rng(8)
    g = torch.Generator().manual_seed(1)
    if packed == "s2d":
        p = tnn.conv2d_init(g, 3, 4, stddev=0.2)
        x = torch.from_numpy(_normal(rng, (2, 8, 8, 3)))
        got, want = tnn.conv2d(p, x, impl="s2d"), tnn.conv2d(p, x)
    else:
        p = tnn.deconv2d_init(g, 6, 3, stddev=0.2)
        x = torch.from_numpy(_normal(rng, (2, 4, 4, 6)))
        got, want = tnn.deconv2d(p, x, impl="subpixel"), tnn.deconv2d(p, x)
    _close(got, want)


# ---------------------------------------------------------------------------
# inference batch norm folded into the layer before it (bn_after, fold_bn)
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(a)


def _random_bn(rng, c):
    """BN params and running moments far from the init's (1, 0) and
    (0, 1), so a fold that misuses one of them shows."""
    return ({"scale": _t(1 + _normal(rng, (c,), 0.3)),
             "bias": _t(_normal(rng, (c,), 0.5))},
            {"mean": _t(_normal(rng, (c,), 0.5)),
             "var": _t(rng.uniform(0.3, 3.0, c).astype(np.float32))})


def _fold_case(kind):
    """(layer params, BN params, BN state, x, out_axis, reps, run): run(p,
    x) is the layer's output as the BN sees it. The linear's BN follows a
    reshape of its (B, 2*2*4) output to (B, 2, 2, 4), as bn0 does in the
    generator."""
    rng = np.random.default_rng({"linear": 11, "deconv": 12, "conv": 13}[kind])
    if kind == "linear":
        layer = {"w": _normal(rng, (6, 16), 0.4), "b": _normal(rng, (16,))}
        x, out_axis, reps = _normal(rng, (5, 6)), 1, 4

        def run(p, x):
            return tnn.linear(p, x).reshape(-1, 2, 2, 4)
    elif kind == "deconv":
        layer = {"w": _normal(rng, (6, 4, 5, 5), 0.2),
                 "b": _normal(rng, (4,))}
        x, out_axis, reps, run = (_normal(rng, (3, 4, 4, 6)), 1, 1,
                                  tnn.deconv2d)
    else:
        layer = {"w": _normal(rng, (4, 6, 5, 5), 0.2),
                 "b": _normal(rng, (4,))}
        x, out_axis, reps, run = (_normal(rng, (3, 8, 8, 6)), 0, 1,
                                  tnn.conv2d)
    bn_p, bn_s = _random_bn(rng, 4)
    return ({k: _t(v) for k, v in layer.items()}, bn_p, bn_s, _t(x),
            out_axis, reps, run)


def _within(got, want, frac=1e-5, what=""):
    """|got - want| within `frac` of want's largest |value|."""
    err = float((got - want).abs().max())
    assert err <= frac * float(want.abs().max()), (what, err)


@pytest.mark.parametrize("kind", ["linear", "deconv", "conv"])
def test_bn_after_folds_inference_bn(kind):
    """Folded against unfolded pre-activation, float32: the output and
    the input's gradient; the state comes back as it was."""
    layer, bn_p, bn_s, x, out_axis, reps, run = _fold_case(kind)
    folded, norm = tnn.bn_after(layer, bn_p, bn_s, False, out_axis, reps)
    assert folded is not layer
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    got, state = norm(run(folded, xs[0]))
    want, _ = tnn.batch_norm(bn_p, bn_s, run(layer, xs[1]), False)
    assert state is bn_s
    _within(got.detach(), want.detach(), what="forward")
    ct = torch.randn(want.shape, generator=torch.Generator().manual_seed(0))
    (dx_got,) = torch.autograd.grad(got, xs[0], ct)
    (dx_want,) = torch.autograd.grad(want, xs[1], ct)
    _within(dx_got, dx_want, what="d input")


@pytest.mark.parametrize("kind", ["linear", "deconv", "conv"])
def test_bn_fold_passes_gradients_to_the_params(kind):
    """A trainable layer and BN: the gradients of w, b, scale and bias
    through the fold equal the unfolded path's, float32."""
    layer, bn_p, bn_s, x, out_axis, reps, run = _fold_case(kind)
    ct = None
    grads = []
    for fold in (True, False):
        lp = {k: v.clone().requires_grad_(True) for k, v in layer.items()}
        bp = {k: v.clone().requires_grad_(True) for k, v in bn_p.items()}
        if fold:
            p, norm = tnn.bn_after(lp, bp, bn_s, False, out_axis, reps)
            y, _ = norm(run(p, x))
        else:
            y, _ = tnn.batch_norm(bp, bn_s, run(lp, x), False)
        if ct is None:
            ct = torch.randn(y.shape,
                             generator=torch.Generator().manual_seed(1))
        leaves = [lp["w"], lp["b"], bp["scale"], bp["bias"]]
        grads.append(torch.autograd.grad(y, leaves, ct))
    for name, got, want in zip(("w", "b", "scale", "bias"), *grads):
        assert float(want.abs().max()) > 0, name
        _within(got, want, what=name)
