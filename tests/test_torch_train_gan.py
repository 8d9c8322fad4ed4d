"""The port's image-DCGAN training (gifgan_tpu_torch/train/gan.py) against
the JAX package's (gifgan_tpu/train/gan.py), from the same converted state,
float32 on the CPU, noise 0 (torch's generator cannot give threefry's
draws), on the golden test's IMG config (tests/test_trajectory_golden.py:
32x32x3, z 16, gf = df = 8).

The state is the JAX init of one key with non-zero Adam slots at count 3
and moved BN moments, so the resumed-optimizer arithmetic and the running
moments are exercised too. One JAX train program is compiled for the file
(the `jax_chunk` fixture). DCGAN_TRAJ is held in
test_torch_train_gan_golden.py, the bf16 step in test_torch_train_gan_bf16.py,
one JAX train program each.

Tolerances, each with its reason:
- gradients: rtol 1e-4 plus 1e-4 x the array's largest |value|: float32
  accumulation-order differences compound through the conv and BN layers.
  A bias that feeds a train-mode BN (`_BN_FED`) has an exactly zero
  gradient, for which both packages return rounding noise of the batch
  sum: both must lie within 1e-5 x the tree's largest gradient of 0;
- step metrics and BN state: rtol 1e-3, three steps of updates feed those
  differences back;
- parameters after updates: atol 3 x lr, Adam's step is ~lr whatever the
  gradient's size, so a near-zero gradient may move the two packages'
  weights apart by up to ~lr an update.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import DCGANConfig, TrainConfig
from gifgan_tpu.data.device import DeviceCorpus as JDeviceCorpus
from gifgan_tpu.data.synthetic import synthetic_stills
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu.ops import nn as jnn
from gifgan_tpu.train import gan as jgan
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.train import gan as tgan

_IMG = dict(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8)
K, B = 3, 8
# conv biases whose layer output goes into a train-mode BatchNorm: the
# per-channel batch mean removes them, so their exact gradient is zero
# (h0_lin's bias is per (position, channel), which the mean does not remove)
_BN_FED = {"h1_conv/b", "h2_conv/b", "h3_conv/b",
           "h1_deconv/b", "h2_deconv/b", "h3_deconv/b"}


def _cfgs(**img_kw):
    img = dict(_IMG, **img_kw)
    kw = dict(batch_size=B, gen_updates=2)
    return (DCGANConfig(**img), TrainConfig(**kw), tconfig.DCGANConfig(**img),
            tconfig.TrainConfig(**kw))


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg, jtcfg):
    """The JAX init of PRNGKey(7), one compiled program (op by op it takes
    seconds of small compiles)."""
    init = jax.jit(jgan.init_train_state, static_argnums=(1, 2))
    return _flatten_with_paths(init(jax.random.PRNGKey(7), jcfg,
                                    jtcfg)._asdict())


def _state_flat(jcfg, jtcfg, seed=0):
    """Flat JAX-layout state: the JAX init, Adam slots at count 3, moved BN
    moments."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in _jax_init(jcfg, jtcfg).items():
        if k.endswith("count"):
            x = np.full(v.shape, 3)
        elif "/mu/" in k:
            x = 1e-3 * rng.standard_normal(v.shape)
        elif "/nu/" in k:
            x = 1e-6 * (1 + rng.random(v.shape))
        elif k.startswith("state/") and k.endswith("mean"):
            x = 0.1 * rng.standard_normal(v.shape)
        elif k.startswith("state/") and k.endswith("var"):
            x = 1 + 0.2 * rng.random(v.shape)
        else:
            x = v
        out[k] = np.asarray(x, v.dtype)
    return out


def _jax_state(flat):
    tree = {}
    for k, v in flat.items():
        *ps, last = k.split("/")
        node = tree
        for p in ps:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    adam = lambda t: (optax.ScaleByAdamState(**t["0"]), optax.EmptyState())
    return jgan.TrainState(params=jdcgan.DCGANParams(**tree["params"]),
                           state=jdcgan.DCGANState(**tree["state"]),
                           opt_g=adam(tree["opt_g"]), opt_d=adam(tree["opt_d"]),
                           step=tree["step"])


def _port_state(flat):
    return tgan.TrainState.from_tree(interop.from_jax_flat(flat, "cpu"))


def _close(got, want, rtol, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    stills = synthetic_stills(24, size=32)
    ids = rng.integers(0, 24, (K, B)).astype(np.int32)
    z = rng.uniform(-1, 1, (K, B, 16)).astype(np.float32)
    return stills, ids, z


def _images(stills, ids):
    return stills[ids].astype(np.float32) / 127.5 - 1.0


def test_port_init_has_the_jax_tree():
    """init_train_state from a torch generator: the keys, shapes and dtypes
    of the JAX package's state, once in the JAX layout."""
    jc, jt, tc, tt = _cfgs()
    want = _jax_init(jc, jt)
    got = interop.to_jax_flat(tgan.init_train_state(
        torch.Generator().manual_seed(0), tc, tt, device="cpu"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k


@pytest.mark.parametrize("role", ["d", "g"])
def test_step_gradients_match_jax(role):
    """One D step's and one G step's loss and gradients, against jax.grad
    of the reference's loss functions (train/gan.py _d_step, _g_step)."""
    jc, jt, tc, tt = _cfgs()
    flat = _state_flat(jc, jt)
    jts, tts = _jax_state(flat), _port_state(flat)
    stills, ids, z = _inputs()
    images, z0 = _images(stills, ids[0]), z[0]

    def d_loss(dp):
        fake, _ = jdcgan.generator(jts.params.generator, jts.state.generator,
                                   jnp.asarray(z0), jc, train=True)
        lr_, _, ds1 = jdcgan.discriminator(dp, jts.state.discriminator,
                                           jnp.asarray(images), jc,
                                           train=True)
        lf, _, _ = jdcgan.discriminator(dp, ds1, fake, jc, train=True)
        return (jnn.sigmoid_ce(lr_, jnp.ones_like(lr_))
                + jnn.sigmoid_ce(lf, jnp.zeros_like(lf)))

    def g_loss(gp):
        fake, _ = jdcgan.generator(gp, jts.state.generator, jnp.asarray(z0),
                                   jc, train=True)
        lf, _, _ = jdcgan.discriminator(jts.params.discriminator,
                                        jts.state.discriminator, fake, jc,
                                        train=True)
        return jnn.sigmoid_ce(lf, jnp.ones_like(lf))

    if role == "d":
        want = jax.jit(jax.value_and_grad(d_loss))(jts.params.discriminator)
        grads, m, _ = tgan._d_grads(tts, torch.from_numpy(images),
                                    torch.from_numpy(z0), None, tc)
        loss, sub = m["d_loss"], "discriminator"
    else:
        want = jax.jit(jax.value_and_grad(g_loss))(jts.params.generator)
        grads, m, _ = tgan._g_grads(tts, torch.from_numpy(z0), None, tc)
        loss, sub = m["g_loss"], "generator"
    _close(loss, want[0], 1e-5, "loss")
    want_flat = _flatten_with_paths(want[1])
    got_flat = {k.split("/", 2)[2]: v for k, v in interop.to_jax_flat(
        {"params": {sub: grads}}).items()}
    assert sorted(got_flat) == sorted(want_flat)
    top = max(np.abs(v).max() for v in want_flat.values())
    for k, w in want_flat.items():
        if k in _BN_FED:
            assert max(np.abs(w).max(), np.abs(got_flat[k]).max()) \
                <= 1e-5 * top, k
        else:
            np.testing.assert_allclose(got_flat[k], w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)


@pytest.fixture(scope="module")
def jax_chunk():
    """JAX train_chunk_ids over DeviceCorpus(method="take") — held equal to
    "pallas" by the JAX tests — K steps; the file's one compiled step."""
    jc, jt, _, _ = _cfgs()
    flat = _state_flat(jc, jt)
    stills, ids, z = _inputs()
    corpus = JDeviceCorpus(stills, method="take")
    ts, metrics = jgan.train_chunk_ids(
        _jax_state(flat), jnp.asarray(ids), jnp.asarray(z),
        jax.random.PRNGKey(5), corpus.data, jc, jt,
        sample_fn=corpus.sample_fn)
    return (flat, {k: np.asarray(v) for k, v in metrics.items()},
            _flatten_with_paths(ts._asdict()))


def _check_final(tts, want_flat, lr, params_atol=3):
    got = interop.to_jax_flat(tts)
    assert sorted(got) == sorted(want_flat)
    for k, w in want_flat.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=params_atol * lr, err_msg=k)
        elif k.startswith("state/"):
            _close(got[k], w, 1e-3, k)
        elif k.endswith("count") or k == "step":
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_three_train_steps_match_jax(jax_chunk):
    """train_step x K: per-step metrics at rtol 1e-3, then parameters, BN
    state, Adam counts and the step."""
    flat, want, want_flat = jax_chunk
    _, _, tc, tt = _cfgs()
    stills, ids, z = _inputs()
    tts = _port_state(flat)
    got = []
    for i in range(K):
        tts, m = tgan.train_step(tts, torch.from_numpy(_images(stills, ids[i])),
                                 torch.from_numpy(z[i]), None, tc, tt)
        got.append(m)
    assert sorted(got[0]) == sorted(want)
    for k in want:
        _close(np.array([float(m[k]) for m in got]), want[k], 1e-3, k)
    _check_final(tts, want_flat, tt.learning_rate)


def test_train_chunk_ids_matches_jax(jax_chunk):
    """Each step's stills gathered by the port's corpus (kernel method, its
    plain version on the CPU), K steps, stacked metrics."""
    flat, want, want_flat = jax_chunk
    _, _, tc, tt = _cfgs()
    stills, ids, z = _inputs()
    corpus = DeviceCorpus(stills, method="kernel", device="cpu")
    tts, m = tgan.train_chunk_ids(_port_state(flat), torch.from_numpy(ids),
                                  torch.from_numpy(z), None, corpus.data,
                                  tc, tt, sample_fn=corpus.sample_fn)
    for k in want:
        assert m[k].shape == (K,), k
        _close(m[k], want[k], 1e-3, k)
    _check_final(tts, want_flat, tt.learning_rate)


def test_train_chunk_equals_stepwise():
    """train_chunk is train_step K times: with instance noise on, one
    generator drawn through the chunk gives the stepwise run's draws, so
    the losses and the weights are equal bit for bit."""
    _, _, tc, tt = _cfgs(noise_std=0.1)
    ts0 = tgan.init_train_state(torch.Generator().manual_seed(5), tc, tt,
                                device="cpu")
    stills, ids, z = _inputs()
    imgs = torch.from_numpy(np.stack([_images(stills, i) for i in ids]))
    zs = torch.from_numpy(z)
    ts_a, ms = tgan.train_chunk(ts0, imgs, zs,
                                torch.Generator().manual_seed(11), tc, tt)
    gen = torch.Generator().manual_seed(11)
    ts_b, losses = ts0, []
    for i in range(K):
        ts_b, m = tgan.train_step(ts_b, imgs[i], zs[i], gen, tc, tt)
        losses.append(m["d_loss"])
    assert torch.equal(ms["d_loss"], torch.stack(losses))
    a, b = interop.to_jax_flat(ts_a), interop.to_jax_flat(ts_b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(ts_a.step) == K


def test_sample_step_matches_jax():
    jc, jt, tc, tt = _cfgs(packed_c3=True)
    flat = _state_flat(jc, jt)
    z = np.random.default_rng(3).uniform(-1, 1, (B, 16)).astype(np.float32)
    want = np.asarray(jgan.sample_step(_jax_state(flat), jnp.asarray(z), jc))
    got = tgan.sample_step(_port_state(flat), torch.from_numpy(z), tc)
    _close(got, want, 1e-4, "samples")


def test_train_step_leaves_input_state_unchanged():
    jc, jt, tc, tt = _cfgs()
    flat = _state_flat(jc, jt)
    stills, ids, z = _inputs()
    tts = _port_state(flat)
    new, _ = tgan.train_step(tts, torch.from_numpy(_images(stills, ids[0])),
                             torch.from_numpy(z[0]),
                             torch.Generator().manual_seed(0), tc, tt)
    again = interop.to_jax_flat(tts)
    for k, v in flat.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    assert int(new.step) == int(tts.step) + 1
