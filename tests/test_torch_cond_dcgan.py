"""The port's conditional (MNIST) DCGAN (gifgan_tpu_torch/models/dcgan.py
generator_cond/discriminator_cond, train/gan.py cond_train_step) and MNIST
loader (data/mnist.py) against the JAX package's, float32 on the CPU, from
one converted state, at the JAX tests' width (28x28x1, y_dim 10, gf = df
= 8, gfc = dfc = 1024).

Tolerances, each with its reason:
- forward passes and BN moments: rtol 1e-5 of the largest |value| —
  float32 accumulation order of the convs and matmuls;
- step metrics: rtol 1e-5; weights after a step: atol 3 x lr — Adam moves
  a weight by ~lr whatever its gradient's size, so where a gradient is
  rounding noise (a bias before a train-mode BN) the packages' updates
  can differ by up to ~lr;
- the loader and the synthetic digits: equal, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core.config import DCGANConfig, TrainConfig
from gifgan_tpu.data import mnist as jmnist
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu.train import gan as jgan
from gifgan_tpu_torch.core import checkpoint as tckpt
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.data import mnist as tmnist
from gifgan_tpu_torch.models import dcgan as tdcgan
from gifgan_tpu_torch.train import gan as tgan

_CFG = dict(output_size=28, c_dim=1, z_dim=16, gf_dim=8, df_dim=8)
Y, B = 10, 16


def _cfgs(**kw):
    return (DCGANConfig(**_CFG, **kw), tconfig.DCGANConfig(**_CFG, **kw))


def _flat_state(seed=0):
    """A flat JAX-layout CondTrainState: random weights (std 0.05),
    biases, BN scales and moments, and warm Adam slots."""
    jcfg, _ = _cfgs()
    spec = jax.eval_shape(lambda: jgan.init_cond_train_state(
        jax.random.PRNGKey(0), jcfg, Y, TrainConfig())._asdict())
    rng = np.random.default_rng(seed)
    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(spec)[0]:
        k = "/".join(jckpt._path_str(p) for p in path)
        leaf = k.rsplit("/", 1)[-1]
        if k.endswith("count"):
            x = np.full(v.shape, 3)
        elif "/mu/" in k:
            x = 1e-3 * rng.standard_normal(v.shape)
        elif "/nu/" in k:
            x = 1e-6 * (1 + rng.random(v.shape))
        elif leaf == "w":
            x = 0.05 * rng.standard_normal(v.shape)
        elif leaf in ("b", "bias", "mean"):
            x = 0.1 * rng.standard_normal(v.shape)
        elif leaf in ("scale", "var"):
            x = 1 + 0.2 * rng.random(v.shape)
        else:
            x = np.zeros(v.shape)
        flat[k] = np.asarray(x, v.dtype)
    return flat


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        *ps, last = k.split("/")
        node = tree
        for p in ps:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return tree


def _jax_state(flat):
    t = _nest(flat)
    return jgan.CondTrainState(
        jdcgan.DCGANParams(**t["params"]), jdcgan.DCGANState(**t["state"]),
        (optax.ScaleByAdamState(**t["opt_g"]["0"]), optax.EmptyState()),
        (optax.ScaleByAdamState(**t["opt_d"]["0"]), optax.EmptyState()),
        t["step"])


def _port_state(flat):
    return tgan.CondTrainState.from_tree(interop.from_jax_flat(flat, "cpu"))


def _close(got, want, rtol=1e-5, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    images, y = tmnist.synthetic_digits(B, seed=seed)
    z = rng.uniform(-1, 1, (B, 16)).astype(np.float32)
    return images, y, z


def _write_idx(path):
    """MNIST-sized idx files (60k + 10k), random pixels and labels."""
    rng = np.random.default_rng(0)
    for name, n, head, shape in (
            ("train-images-idx3-ubyte", 60000, 16, (28, 28)),
            ("train-labels-idx1-ubyte", 60000, 8, ()),
            ("t10k-images-idx3-ubyte", 10000, 16, (28, 28)),
            ("t10k-labels-idx1-ubyte", 10000, 8, ())):
        hi = 256 if shape else 10
        data = rng.integers(0, hi, (n,) + shape, np.uint8)
        with open(os.path.join(path, name), "wb") as f:
            f.write(b"\x00" * head + data.tobytes())


def test_load_mnist_equals_jax(tmp_path):
    _write_idx(str(tmp_path))
    jx, jy = jmnist.load_mnist(str(tmp_path))
    tx, ty = tmnist.load_mnist(str(tmp_path))
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tx, jx)


@pytest.mark.parametrize("n,seed", [(20, 0), (64, 3)])
def test_synthetic_digits_equal_jax(n, seed):
    jx, jy = jmnist.synthetic_digits(n, seed=seed)
    tx, ty = tmnist.synthetic_digits(n, seed=seed)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("train", [True, False])
def test_generator_and_discriminator_equal_jax(train):
    jcfg, tcfg = _cfgs()
    flat = _flat_state()
    js, ps = _jax_state(flat), _port_state(flat)
    images, y, z = _batch()
    jimg, jgs = jdcgan.generator_cond(js.params.generator, js.state.generator,
                                      jnp.asarray(z), jnp.asarray(y), jcfg,
                                      train)
    timg, tgs = tdcgan.generator_cond(
        ps.params["generator"], ps.state["generator"], torch.from_numpy(z),
        torch.from_numpy(y), tcfg, train)
    assert timg.shape == (B, 28, 28, 1)
    assert float(timg.min()) >= 0.0 and float(timg.max()) <= 1.0
    _close(timg.numpy(), jimg, err_msg="generator")
    for k in jgs:
        for m in ("mean", "var"):
            _close(tgs[k][m].numpy(), jgs[k][m], err_msg=f"G {k} {m}")
    jl, jds = jdcgan.discriminator_cond(
        js.params.discriminator, js.state.discriminator, jnp.asarray(images),
        jnp.asarray(y), jcfg, train)
    tl, tds = tdcgan.discriminator_cond(
        ps.params["discriminator"], ps.state["discriminator"],
        torch.from_numpy(images), torch.from_numpy(y), tcfg, train)
    assert tl.shape == (B, 1) and tl.dtype == torch.float32
    _close(tl.numpy(), jl, err_msg="discriminator")
    for k in jds:
        for m in ("mean", "var"):
            _close(tds[k][m].numpy(), jds[k][m], err_msg=f"D {k} {m}")


def test_cond_train_step_equals_jax():
    """One step (1 D + 2 G updates) from one converted state with instance
    noise 0.1 (the JAX draws passed in) and a D learning rate of its own:
    the losses, every weight, the BN state, the Adam counts."""
    jcfg, tcfg = _cfgs(noise_std=0.1)
    kw = dict(batch_size=B, d_learning_rate=5e-4)
    jt, tt = TrainConfig(**kw), tconfig.TrainConfig(**kw)
    flat = _flat_state(2)
    images, y, z = _batch(3)
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, jt.disc_updates + 1)
    noise = [torch.from_numpy(np.array(0.1 * jax.random.normal(
        keys[u], images.shape, jnp.float32))) for u in range(jt.disc_updates)]
    jts, jm = jgan.cond_train_step(_jax_state(flat), jnp.asarray(images),
                                   jnp.asarray(y), jnp.asarray(z), rng,
                                   jcfg, jt)
    pts, pm = tgan.cond_train_step(
        _port_state(flat), torch.from_numpy(images), torch.from_numpy(y),
        torch.from_numpy(z), None, tcfg, tt, noise=noise)
    assert isinstance(pts, tgan.CondTrainState) and int(pts.step) == 1
    assert sorted(pm) == sorted(jm)
    for k in jm:
        _close(float(pm[k]), float(jm[k]), err_msg=k)
    back = interop.to_jax_flat(pts)
    jflat = jckpt._flatten_with_paths(jts._asdict())
    assert sorted(back) == sorted(jflat)
    lr = max(jt.learning_rate, jt.d_learning_rate)
    for k, v in jflat.items():
        v = np.asarray(v)
        if k.startswith("params"):
            np.testing.assert_allclose(back[k], v, rtol=0, atol=3 * lr,
                                       err_msg=k)
        elif k.startswith("state"):
            _close(back[k], v, err_msg=k)
        elif k.endswith("count") or k == "step":
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the D update took its own rate: D moved more than G would have
    moved = {n: max(float(np.abs(back[k] - flat[k]).max()) for k in back
                    if k.startswith(f"params/{n}/"))
             for n in ("generator", "discriminator")}
    assert moved["discriminator"] > 2 * jt.learning_rate, moved


def test_cond_sample_step_and_noise_draws():
    jcfg, tcfg = _cfgs(noise_std=0.1)
    flat = _flat_state(4)
    _, y, z = _batch(5)
    got = tgan.cond_sample_step(_port_state(flat), torch.from_numpy(z),
                                torch.from_numpy(y), tcfg)
    _close(got.numpy(), jgan.cond_sample_step(
        _jax_state(flat), jnp.asarray(z), jnp.asarray(y), jcfg),
        err_msg="cond_sample_step")
    images, y, z = (torch.from_numpy(a) for a in _batch(6))
    tt = tconfig.TrainConfig(batch_size=B)
    runs = [tgan.cond_train_step(_port_state(flat), images, y, z,
                                 torch.Generator().manual_seed(s), tcfg,
                                 tt)[1]["d_loss_real"] for s in (1, 1, 2)]
    assert float(runs[0]) == float(runs[1]) != float(runs[2])


def test_init_and_checkpoints_cross_both_ways(tmp_path):
    """The port's init has the JAX keys, shapes and dtypes; a JAX
    CondTrainState checkpoint restores into it bit for bit, and the port's
    saved state restores into the JAX one."""
    _, tcfg = _cfgs()
    fresh = tgan.init_cond_train_state(torch.Generator().manual_seed(0),
                                       tcfg, Y, tconfig.TrainConfig(),
                                       device="cpu")
    flat = _flat_state(8)
    got = interop.to_jax_flat(fresh)
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    jdir = str(tmp_path / "jax")
    jckpt.save(jdir, 4, _jax_state(flat)._asdict())
    restored = tckpt.restore(jdir, fresh)
    assert isinstance(restored, tgan.CondTrainState)
    for k, v in interop.to_jax_flat(restored).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    pdir = str(tmp_path / "port")
    tckpt.save(pdir, 4, interop.to_jax_flat(restored))
    back = jckpt.restore(pdir, _jax_state(_flat_state(9))._asdict())
    for k, v in jckpt._flatten_with_paths(back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
