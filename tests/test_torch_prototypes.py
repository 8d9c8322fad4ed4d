"""The port's RNN prototype ladder (gifgan_tpu_torch/models/rnn_prototypes.py)
against the JAX package's (gifgan_tpu/models/rnn_prototypes.py): each apply
and loss on the same JAX batch from converted JAX params (float32, rtol
1e-5 of the largest |value|: accumulation order only), the data functions'
form, and each `fit` learning at tests/test_prototypes.py's thresholds,
from the port's own init, data streams and Adam."""

import functools

import jax
import numpy as np
import pytest
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.models import rnn_prototypes as J
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.models import rnn_prototypes as P

KEY = jax.random.PRNGKey(0)
CASES = {
    "echo": (J.echo_rnn_init, (), lambda k: J.echo_data(k, 8, 12, 2),
             "echo_rnn_apply", "echo_loss"),
    "vector_echo": (J.vector_echo_init, (6,),
                    lambda k: J.vector_echo_data(k, 8, 10, 6, 1),
                    "vector_echo_apply", "vector_echo_loss"),
    "conv_cls": (J.conv_cls_init, (),
                 lambda k: J.conv_cls_data(k, 8, 6), "conv_cls_apply",
                 "conv_cls_loss"),
}


def _close(got, want, rtol=1e-5, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_and_loss_equal_jax(name):
    init, args, data, apply, loss = CASES[name]
    jp = jax.jit(lambda k: init(k, *args))(KEY)
    # the JAX init's weights, scaled so the nets' outputs are not ~0
    jp = jax.tree_util.tree_map(lambda a: 5.0 * a, jp)
    tp = interop.from_jax_flat(jckpt._flatten_with_paths(jp), "cpu")
    x, y = jax.jit(data)(jax.random.PRNGKey(1))
    tx, ty = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    _close(getattr(P, apply)(tp, tx).numpy(),
           jax.jit(getattr(J, apply))(jp, x), err_msg=apply)
    _close(getattr(P, loss)(tp, tx, ty).item(),
           float(jax.jit(getattr(J, loss))(jp, x, y)), err_msg=loss)


def test_data_functions_have_the_jax_form():
    """Shapes, dtypes and the tasks' structure: echo's target is the input
    `delay` steps back (zeros before), vector echo's target the index,
    conv_cls's stripe on the label's channel at column 2t mod size."""
    gen = torch.Generator().manual_seed(0)
    x, y = P.echo_data(gen, 8, 12, 2)
    jx, jy = jax.eval_shape(lambda: J.echo_data(KEY, 8, 12, 2))
    assert x.shape == jx.shape and y.shape == jy.shape
    assert set(x.unique().tolist()) <= {0.0, 1.0}
    torch.testing.assert_close(y[:, 2:], x[:, :-2])
    assert float(y[:, :2].abs().sum()) == 0.0
    x, y = P.vector_echo_data(gen, 8, 10, 6, 1)
    assert x.shape == (8, 10, 6) and y.dtype == torch.int64
    torch.testing.assert_close(y[:, 1:], x[:, :-1].argmax(-1))
    assert int(y[:, 0].abs().sum()) == 0
    x, labels = P.conv_cls_data(gen, 64, 6)
    jx, jl = jax.eval_shape(lambda: J.conv_cls_data(KEY, 64, 6))
    assert x.shape == jx.shape and labels.shape == jl.shape
    assert float(x.min()) >= -1.0 and float(x.max()) <= 2.0
    cols = torch.arange(6) * 2 % 16
    stripe = x[torch.arange(64)[:, None], torch.arange(6)[None], :,
               cols[None], :].mean(2)                 # (64, 6, channels)
    assert (stripe.mean(1).argmax(-1) == labels).float().mean() > 0.95


def test_echo_rnn_learns():
    params = P.echo_rnn_init(torch.Generator().manual_seed(0), device="cpu")
    data = functools.partial(P.echo_data, batch=32, length=12, delay=2)
    params, first, last = P.fit(params, P.echo_loss, data, steps=150)
    assert last < first * 0.5, (first, last)
    x, y = P.echo_data(torch.Generator().manual_seed(99), 64, 12, 2)
    pred = P.echo_rnn_apply(params, x).argmax(-1)
    acc = (pred[:, 2:] == y[:, 2:]).float().mean().item()
    assert acc > 0.9, acc


def test_vector_echo_learns():
    params = P.vector_echo_init(torch.Generator().manual_seed(0), 6,
                                device="cpu")
    params, first, last = P.fit(
        params, P.vector_echo_loss,
        lambda g: P.vector_echo_data(g, 32, 10, 6, 1), steps=200)
    assert last < first * 0.5, (first, last)


def test_conv_cls_learns():
    params = P.conv_cls_init(torch.Generator().manual_seed(0), device="cpu")
    params, first, last = P.fit(params, P.conv_cls_loss,
                                lambda g: P.conv_cls_data(g, 16, 6),
                                steps=120, lr=3e-3)
    assert last < first * 0.7, (first, last)
    x, labels = P.conv_cls_data(torch.Generator().manual_seed(7), 32, 6)
    acc = (P.conv_cls_apply(params, x).argmax(-1) == labels).float().mean()
    assert acc.item() > 0.6, acc
