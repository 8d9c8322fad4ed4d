"""The port's PredNet (gifgan_tpu_torch/models/prednet.py) against the JAX
package's (gifgan_tpu/models/prednet.py), float32 on the CPU, from one
converted parameter tree, at the JAX tests' size (16x16x3, channels
(8, 16)): the predictions and the error of `forward`, `loss_fn` and its
gradient; and a few Adam steps of the port's own that lower the loss.

Tolerances, each with its reason: forward outputs and the loss rtol 1e-5
of the largest |value|, gradients rtol 1e-4 of each leaf's largest
|value| — float32 accumulation order through 6 time steps of convLSTMs,
compounded in the backward pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.models import prednet as jprednet
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.data.synthetic import synthetic_clips
from gifgan_tpu_torch.models import prednet as tprednet
from gifgan_tpu_torch.train.gan import (Adam, _differentiable, _grads,
                                        apply_updates)

_KW = dict(image_size=16, c_dim=3, channels=(8, 16))
JCFG, TCFG = jprednet.PredNetConfig(**_KW), tprednet.PredNetConfig(**_KW)


def _params(seed=0):
    """(JAX params, port params) of one random tree (std 0.1 weights,
    small biases)."""
    spec = jax.eval_shape(lambda: jprednet.init(jax.random.PRNGKey(0),
                                                JCFG))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(spec)[0]:
        k = "/".join(jckpt._path_str(p) for p in path)
        std = 0.1 if k.endswith("/w") else 0.02
        flat[k] = (std * rng.standard_normal(v.shape)).astype(v.dtype)
    jp = {}
    for k, v in flat.items():
        layer, leaf = k.split("/")
        jp.setdefault(layer, {})[leaf] = jnp.asarray(v)
    return jp, interop.from_jax_flat(flat, "cpu")


def _clips(n=4, t=6, seed=0):
    return synthetic_clips(n, length=t, size=16, seed=seed).astype(
        np.float32) / 255.0


def _close(got, want, rtol, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def test_forward_equals_jax():
    jp, tp = _params()
    clips = _clips()
    jpred, jerr = jprednet.forward(jp, jnp.asarray(clips), JCFG)
    tpred, terr = tprednet.forward(tp, torch.from_numpy(clips), TCFG)
    assert tpred.shape == (4, 6, 16, 16, 3)
    assert float(tpred.min()) >= 0.0 and float(tpred.max()) <= 1.0
    _close(tpred.numpy(), jpred, 1e-5, "predictions")
    _close(float(terr), float(jerr), 1e-5, "error")


def test_loss_and_gradient_equal_jax():
    """Seed 0. Some inputs put a value within float32 rounding of a relu
    kink, and then the two packages' gradients part discretely: at seed 1
    a layer-1 error sits at -3.7e-9 in the port and +4.7e-9 in a float64
    run of the port, whose gradients agree with the JAX package's within
    3.1e-7 — a rounding side, not a different function."""
    jp, tp = _params(0)
    clips = _clips(seed=0)
    jloss, jgrads = jax.value_and_grad(jprednet.loss_fn)(
        jp, jnp.asarray(clips), JCFG)
    keys, leaves, p = _differentiable(tp)
    loss = tprednet.loss_fn(p, torch.from_numpy(clips), TCFG)
    grads = interop.to_jax_flat(_grads(loss, keys, leaves))
    _close(loss.item(), float(jloss), 1e-5, "loss")
    jflat = jckpt._flatten_with_paths(jgrads)
    assert sorted(grads) == sorted(jflat)
    for k, v in jflat.items():
        assert np.abs(v).max() > 0, k
        _close(grads[k], v, 1e-4, k)


def test_init_shapes_equal_jax():
    tp = tprednet.init(torch.Generator().manual_seed(0), TCFG, device="cpu")
    got = interop.to_jax_flat(tp)
    want = {"/".join(jckpt._path_str(p) for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda: jprednet.init(jax.random.PRNGKey(0),
                                                     JCFG)))[0]}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert abs(float(tp["lstm0"]["w"].std()) - 0.05) < 0.01


def test_adam_steps_lower_the_loss():
    """The port's own init and Adam (train/gan.py, optax.adam's
    arithmetic at lr 2e-3, as tests/test_prednet.py): 30 steps on 8-clip
    batches of 16 clips cut the layer-0 error well below its start."""
    params = tprednet.init(torch.Generator().manual_seed(0), TCFG,
                           device="cpu")
    clips = torch.from_numpy(_clips(16, seed=2))
    opt = Adam(2e-3)
    state = opt.init(params)
    loss0 = float(tprednet.loss_fn(params, clips[:8], TCFG))
    rng = np.random.default_rng(0)
    for _ in range(30):
        keys, leaves, p = _differentiable(params)
        with torch.enable_grad():
            loss = tprednet.loss_fn(p, clips[rng.integers(0, 16, 8)], TCFG)
            grads = _grads(loss, keys, leaves)
        updates, state = opt.update(grads, state)
        params = apply_updates(params, updates)
    loss_end = float(tprednet.loss_fn(params, clips[:8], TCFG))
    assert loss_end < 0.5 * loss0, (loss0, loss_end)
