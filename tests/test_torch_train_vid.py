"""The port's VID_DCGAN training (gifgan_tpu_torch/train/vid.py) against the
JAX package's (gifgan_tpu/train/vid.py), from the same converted state, on
the vid config of tests/test_trajectory_golden.py (packed_c3 on, as the
flagship), float32 on the CPU, noise 0 (torch's generator cannot give
threefry's draws).

Both sides start from one state with numpy-drawn weights (std 0.2; random
init gives ~1e-5 outputs and vanishing gradients) and non-zero Adam slots at
count 3, so the resumed-optimizer arithmetic is exercised too.

Tolerances, each with its reason:
- gradients: rtol 1e-4 plus 1e-4 x the array's largest |value| — a few
  conv, BN and conv3d layers of float32 accumulation-order differences
  (1e-5 per layer, test_torch_nn.py) compound through the backward pass.
  That scale has a floor of 1e-2 x the largest gradient of the tree: a bias
  feeding a train-mode BN has an exactly zero gradient in exact
  arithmetic, and both packages return rounding noise (~1e-7 of the
  largest gradient) for it;
- step metrics: rtol 1e-3 — three steps of updates feed those differences
  back into the weights;
- parameters after updates: atol 3 x lr — Adam's step is ~lr in size
  whatever the gradient's size, so where a gradient is near 0 the two
  packages' updates can differ by up to ~lr per update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import DCGANConfig, TrainConfig, VidGANConfig
from gifgan_tpu.data.device import DeviceCorpus as JDeviceCorpus
from gifgan_tpu.data.synthetic import synthetic_clips
from gifgan_tpu.models import vid_dcgan as jvid_dcgan
from gifgan_tpu.ops import nn as jnn
from gifgan_tpu.train import vid as jvid
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.train import vid as tvid

_IMG = dict(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8,
            packed_c3=True)
_VID = dict(z_input_size=20, z_output_size=16, vid_length=4, hidden_dim=32,
            d_filters=16, first_frame_loss_scalar=1.0)
K, B = 3, 8


def _cfgs(**train_kw):
    jc = VidGANConfig(image_gan=DCGANConfig(**_IMG), **_VID)
    tc = tconfig.VidGANConfig(image_gan=tconfig.DCGANConfig(**_IMG), **_VID)
    kw = dict(batch_size=B, gen_updates=2, **train_kw)
    return jc, TrainConfig(**kw), tc, tconfig.TrainConfig(**kw)


def _random_state_flat(jcfg, jtcfg, seed=0):
    """Flat JAX-layout state: random weights, BN moments and Adam slots."""
    ts = jvid.init_train_state(jax.random.PRNGKey(3), jcfg, jtcfg)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in _flatten_with_paths(ts._asdict()).items():
        leaf = k.rsplit("/", 1)[-1]
        if k.endswith("count"):
            x = np.full(v.shape, 3)
        elif "/mu/" in k:
            x = 1e-3 * rng.standard_normal(v.shape)
        elif "/nu/" in k:
            x = 1e-6 * (1 + rng.random(v.shape))
        elif leaf == "w":
            x = 0.2 * rng.standard_normal(v.shape)
        elif leaf in ("b", "bias", "mean"):
            x = 0.1 * rng.standard_normal(v.shape)
        elif leaf == "scale":
            x = 1 + 0.1 * rng.standard_normal(v.shape)
        elif leaf == "var":
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
    return jvid.VidTrainState(
        params=jvid_dcgan.VidGANParams(**tree["params"]),
        state=jvid_dcgan.VidGANState(**tree["state"]),
        opt_g=(__import__("optax").ScaleByAdamState(**tree["opt_g"]["0"]),
               __import__("optax").EmptyState()),
        opt_d=(__import__("optax").ScaleByAdamState(**tree["opt_d"]["0"]),
               __import__("optax").EmptyState()),
        step=tree["step"])


def _port_state(flat):
    return tvid.VidTrainState.from_tree(interop.from_jax_flat(flat, "cpu"))


def _close(got, want, rtol, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    clips = synthetic_clips(16, length=4, size=32)
    ids = rng.integers(0, 16, (K, B)).astype(np.int32)
    z = rng.uniform(-1, 1, (K, B, 20)).astype(np.float32)
    return clips, ids, z


def _jax_loss_fns(ts, frames, z, cfg):
    """The JAX package's D and G losses (train/vid.py _d_step/_g_step
    loss_fn) as functions of the trainable partition, noise 0."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)

    def d_loss(tr):
        params = ts.params._replace(vid_discriminator=tr["vid"])
        if "img" in tr:
            params = params._replace(img_discriminator=tr["img"])
        ra, _ = jvid._real_activations(params, ts.state, frames, cfg, keys[:2])
        fa, _, _, _ = jvid._fake_activations(params, ts.state, z, cfg,
                                             keys[2:])
        lr_, ds1 = jvid_dcgan.vid_discriminator(
            params.vid_discriminator, ts.state.vid_discriminator, ra, cfg,
            train=True)
        lf, _ = jvid_dcgan.vid_discriminator(params.vid_discriminator, ds1,
                                             fa, cfg, train=True)
        return (jnn.sigmoid_ce(lr_, jnp.ones_like(lr_))
                + jnn.sigmoid_ce(lf, jnp.zeros_like(lf)))

    def g_loss(tr):
        params = ts.params._replace(vid_generator=tr["vid"])
        if "img" in tr:
            params = params._replace(img_generator=tr["img"])
        fa, g_out, _, _ = jvid._fake_activations(params, ts.state, z, cfg,
                                                 keys[:2])
        lf, _ = jvid_dcgan.vid_discriminator(
            params.vid_discriminator, ts.state.vid_discriminator, fa, cfg,
            train=True)
        return (jnn.sigmoid_ce(lf, jnp.ones_like(lf))
                + cfg.first_frame_loss_scalar
                * jvid_dcgan.first_frame_loss(g_out, z, cfg))

    return d_loss, g_loss


@pytest.mark.parametrize("role", ["d", "g"])
@pytest.mark.parametrize("train_img", [False, True])
def test_step_gradients_match_jax(role, train_img):
    """One D step's and one G step's gradients over the trainable partition
    (with the image nets unfrozen too), against jax.grad. The state of seed
    1: seed 0's puts one input of an image-G ReLU at 1e-8 of its layer's
    largest value, where the order of the float32 sums decides its routing
    (the image nets' folded inference BN, ops/nn.py bn_after, sums in
    another order than the JAX package's BN)."""
    jc, jt, tc, tt = _cfgs(train_img_gen=train_img, train_img_disc=train_img)
    flat = _random_state_flat(jc, jt, seed=1)
    jts, tts = _jax_state(flat), _port_state(flat)
    clips, ids, z = _inputs()
    frames = (clips[ids[0]].reshape(-1, 32, 32, 3).astype(np.float32)
              / 127.5 - 1.0)
    d_loss, g_loss = _jax_loss_fns(jts, jnp.asarray(frames),
                                   jnp.asarray(z[0]), jc)
    if role == "d":
        trainable = jvid._d_trainable(jts.params, jt)
        want = jax.jit(jax.value_and_grad(d_loss))(trainable)
        grads, metrics, _ = tvid._d_grads(tts, torch.from_numpy(frames),
                                          torch.from_numpy(z[0]), None, tc,
                                          tt)
        loss = metrics["d_loss"]
    else:
        trainable = jvid._g_trainable(jts.params, jt)
        want = jax.jit(jax.value_and_grad(g_loss))(trainable)
        grads, metrics, _ = tvid._g_grads(tts, torch.from_numpy(z[0]), None,
                                          tc, tt)
        loss = metrics["g_loss"]
    _close(loss, want[0], 1e-5, "loss")
    want_flat = _flatten_with_paths(want[1])
    got_flat = interop.to_jax_flat(grads)
    assert sorted(got_flat) == sorted(want_flat)
    assert ("img" in grads) == train_img
    top = max(np.abs(v).max() for v in want_flat.values())
    for k, w in want_flat.items():
        np.testing.assert_allclose(
            got_flat[k], w, rtol=1e-4,
            atol=1e-4 * max(np.abs(w).max(), 1e-2 * top), err_msg=k)


@pytest.fixture(scope="module")
def jax_chunk():
    """JAX train_chunk_ids over DeviceCorpus(method="take") — held equal to
    "pallas" by the JAX tests — K steps; one compile for the module."""
    jc, jt, _, _ = _cfgs()
    flat = _random_state_flat(jc, jt)
    clips, ids, z = _inputs()
    corpus = JDeviceCorpus(clips, method="take")
    ts, metrics = jvid.train_chunk_ids(
        _jax_state(flat), jnp.asarray(ids), jnp.asarray(z),
        jax.random.PRNGKey(5), corpus.data, jc, jt,
        sample_fn=corpus.fold_sample_fn)
    return (flat, {k: np.asarray(v) for k, v in metrics.items()},
            _flatten_with_paths(ts._asdict()))


def _check_final(tts, want_flat, lr):
    got = interop.to_jax_flat(tts)
    assert sorted(got) == sorted(want_flat)
    for k, w in want_flat.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=3 * lr,
                                       err_msg=k)
        elif k.startswith("state/"):
            _close(got[k], w, 1e-3, k)
        elif k.endswith("count") or k == "step":
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_three_train_steps_match_jax(jax_chunk):
    """train_step x K on the gathered frames: per-step metrics at rtol 1e-3,
    then parameters, BN state, Adam counts and the step."""
    flat, want, want_flat = jax_chunk
    _, _, tc, tt = _cfgs()
    clips, ids, z = _inputs()
    tts = _port_state(flat)
    got = []
    for i in range(K):
        frames = (clips[ids[i]].reshape(-1, 32, 32, 3).astype(np.float32)
                  / 127.5 - 1.0)
        tts, m = tvid.train_step(tts, torch.from_numpy(frames),
                                 torch.from_numpy(z[i]), None, tc, tt)
        got.append(m)
    assert sorted(got[0]) == sorted(want)
    for k in want:
        _close(np.array([float(m[k]) for m in got]), want[k], 1e-3, k)
    _check_final(tts, want_flat, tt.learning_rate)


@pytest.mark.parametrize("fold", [True, False])
def test_train_chunk_ids_matches_jax(jax_chunk, fold):
    """The production step: frames gathered by the port's corpus (kernel
    method; its plain version on the CPU), K steps, stacked metrics."""
    flat, want, want_flat = jax_chunk
    _, _, tc, tt = _cfgs()
    clips, ids, z = _inputs()
    corpus = DeviceCorpus(clips, method="kernel", device="cpu")
    tts, m = tvid.train_chunk_ids(
        _port_state(flat), torch.from_numpy(ids), torch.from_numpy(z),
        torch.Generator(), corpus.data, tc, tt,
        sample_fn=corpus.fold_sample_fn if fold else corpus.sample_fn)
    for k in want:
        assert m[k].shape == (K,), k
        _close(m[k], want[k], 1e-3, k)
    _check_final(tts, want_flat, tt.learning_rate)


def test_vid_loss_trajectory_golden():
    """The JAX package's pinned VID_TRAJ (tests/test_trajectory_golden.py):
    the port, from the same JAX init (PRNGKey(3)) and the same z, frames
    and noise 0, reproduces the six steps' losses at that test's rtol and
    atol 2e-3."""
    from tests.test_trajectory_golden import IMG, VID_TRAJ

    cfg = VidGANConfig(z_input_size=20, z_output_size=16, vid_length=4,
                       hidden_dim=32, d_filters=16, image_gan=IMG,
                       first_frame_loss_scalar=1.0)
    tcfg = TrainConfig(batch_size=8, gen_updates=2)
    tc = tconfig.VidGANConfig(
        image_gan=tconfig.DCGANConfig(**{f: getattr(IMG, f) for f in (
            "output_size", "c_dim", "z_dim", "gf_dim", "df_dim")}),
        z_input_size=20, z_output_size=16, vid_length=4, hidden_dim=32,
        d_filters=16, first_frame_loss_scalar=1.0)
    tt = tconfig.TrainConfig(batch_size=8, gen_updates=2)
    ts = jvid.init_train_state(jax.random.PRNGKey(3), cfg, tcfg)
    tts = _port_state(_flatten_with_paths(ts._asdict()))
    clips = synthetic_clips(16, length=4, size=32).astype(np.float32) \
        / 127.5 - 1.0
    traj = []
    for i in range(len(VID_TRAJ)):
        frames = clips[(i * 8) % 16:(i * 8) % 16 + 8].reshape(-1, 32, 32, 3)
        z = np.array(jax.random.uniform(jax.random.PRNGKey(300 + i),
                                        (8, 20), minval=-1, maxval=1))
        tts, m = tvid.train_step(tts, torch.from_numpy(frames),
                                 torch.from_numpy(z), None, tc, tt)
        traj.append((float(m["d_loss"]), float(m["g_loss"]),
                     float(m["first_frame_loss"])))
    np.testing.assert_allclose(traj, VID_TRAJ, rtol=2e-3, atol=2e-3)


def test_knobs_scale_the_d_update_only():
    """d_lr_scale = 0 freezes the D parameters while its Adam slots still
    move; knobs at cfg's values (noise 0, scale 1) equal knobs=None."""
    _, _, tc, tt = _cfgs()
    jc, jt, _, _ = _cfgs()
    flat = _random_state_flat(jc, jt)
    clips, ids, z = _inputs()
    frames = torch.from_numpy(clips[ids[0]].reshape(-1, 32, 32, 3)
                              .astype(np.float32) / 127.5 - 1.0)
    zt = torch.from_numpy(z[0])
    gen = torch.Generator().manual_seed(0)
    base, m0 = tvid.train_step(_port_state(flat), frames, zt, gen, tc, tt)
    same, m1 = tvid.train_step(_port_state(flat), frames, zt, gen, tc, tt,
                               knobs=tvid.make_knobs(tc, device="cpu"))
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-6, atol=0)
    frozen, _ = tvid.train_step(_port_state(flat), frames, zt, gen, tc, tt,
                                knobs=tvid.make_knobs(tc, d_lr_scale=0.0,
                                                      device="cpu"))
    start = _port_state(flat)
    for name, p in frozen.params["vid_discriminator"].items():
        for leaf, v in p.items():
            assert torch.equal(v, start.params["vid_discriminator"][name][leaf])
    assert int(frozen.opt_d.count) == 4
    assert not torch.equal(frozen.opt_d.mu["vid"]["h1_conv"]["w"],
                           start.opt_d.mu["vid"]["h1_conv"]["w"])


def test_train_step_leaves_input_state_unchanged():
    _, _, tc, tt = _cfgs()
    jc, jt, _, _ = _cfgs()
    flat = _random_state_flat(jc, jt)
    clips, ids, z = _inputs()
    tts = _port_state(flat)
    frames = torch.from_numpy(clips[ids[0]].reshape(-1, 32, 32, 3)
                              .astype(np.float32) / 127.5 - 1.0)
    new, _ = tvid.train_step(tts, frames, torch.from_numpy(z[0]), None, tc,
                             tt)
    again = interop.to_jax_flat(tts)
    for k, v in flat.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    assert int(new.step) == int(tts.step) + 1
