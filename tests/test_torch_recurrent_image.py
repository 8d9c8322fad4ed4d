"""The port's recurrent_image GAN (gifgan_tpu_torch/models/recurrent_image.py,
train/recurrent.py) against the JAX package's, from the same converted
state, float32 on the CPU, at the JAX tests' size (32x32x1, T 4, base 8,
LSTM 16), for the plain model and each variant: the encoder that shares
D's convs, 3 LSTM layers with dropout (the JAX threefry masks passed in),
and residual prediction with the pixel term and the adversarial warm-up.
Also the weight layouts of every tree this family and PredNet, the
conditional DCGAN and the prototypes bring (core/interop.py), and
checkpoints across the packages.

Tolerances, each with its reason:
- forward passes and moments: rtol 1e-5 of the largest |value| — float32
  accumulation order of the convs and matmuls (both sides at "highest"
  precision);
- step metrics: rtol 1e-5, one D and two G updates of the same
  arithmetic;
- weights after a step: atol 3 x lr — Adam moves a weight by ~lr whatever
  its gradient's size, so where a gradient is rounding noise the two
  packages' updates can differ by up to ~lr per update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core.config import RecurrentImageConfig, TrainConfig
from gifgan_tpu.models import recurrent_image as jri
from gifgan_tpu.train import recurrent as jrt
from gifgan_tpu_torch.core import checkpoint as tckpt
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.models import recurrent_image as tri
from gifgan_tpu_torch.train import recurrent as trt

_BASE = dict(image_size=32, c_dim=1, seq_length=4, base_filters=8,
             lstm_units=16)
VARIANTS = {
    "plain": {},
    "share_disc_conv": dict(share_disc_conv=True),
    "deep_dropout": dict(num_lstm_layers=3, lstm_dropout=0.2),
    "residual_pixel_warmup": dict(residual_prediction=True,
                                  pixel_loss_scalar=10.0,
                                  adversarial_after_steps=5),
}
B = 2
LR = TrainConfig().learning_rate


def _cfgs(variant):
    kw = dict(_BASE, **VARIANTS[variant])
    return RecurrentImageConfig(**kw), tconfig.RecurrentImageConfig(**kw)


def _jax_state(flat):
    """A JAX RecurrentTrainState from a flat JAX-layout dict."""
    tree = {}
    for k, v in flat.items():
        *ps, last = k.split("/")
        node = tree
        for p in ps:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return jrt.RecurrentTrainState(
        params_g=tree["params_g"], params_d=tree["params_d"],
        opt_g=(optax.ScaleByAdamState(**tree["opt_g"]["0"]),
               optax.EmptyState()),
        opt_d=(optax.ScaleByAdamState(**tree["opt_d"]["0"]),
               optax.EmptyState()),
        step=tree["step"])


def _spec(fn, *args, **kw):
    """{JAX checkpoint key: ShapeDtypeStruct} of fn's result, traced by
    jax.eval_shape (nothing compiled: a jitted init takes seconds)."""
    return _keyed(jax.eval_shape(lambda: fn(*args, **kw)))


def _keyed(out):
    """{JAX checkpoint key: leaf} of a tree."""
    if hasattr(out, "_asdict"):
        out = out._asdict()
    return {"/".join(jckpt._path_str(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(out)[0]}


def _random_flat(spec, seed=0):
    """Values for a spec: weights N(0, 0.02^2) (the JAX init's std),
    biases N(0, 0.01^2), BN scale ~1 and var ~1, warm Adam slots at
    count 3, step 0."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in spec.items():
        leaf = k.rsplit("/", 1)[-1]
        if k.endswith("count"):
            x = np.full(v.shape, 3)
        elif "/mu/" in k:
            x = 1e-3 * rng.standard_normal(v.shape)
        elif "/nu/" in k:
            x = 1e-6 * (1 + rng.random(v.shape))
        elif leaf in ("w", "wx", "wh"):
            x = 0.02 * rng.standard_normal(v.shape)
        elif leaf in ("b", "bias", "mean"):
            x = 0.01 * rng.standard_normal(v.shape)
        elif leaf in ("scale", "var"):
            x = 1 + 0.1 * rng.random(v.shape)
        else:
            x = np.zeros(v.shape)
        flat[k] = np.asarray(x, v.dtype)
    return flat


def _flat_state(variant, seed=0):
    """A flat JAX-layout RecurrentTrainState of a variant: random weights
    at the init's scale and warm Adam slots."""
    jcfg, _ = _cfgs(variant)
    return _random_flat(_spec(jrt.init_train_state, jax.random.PRNGKey(0),
                              jcfg, TrainConfig(batch_size=B)), seed)


def _port_state(flat):
    return trt.RecurrentTrainState.from_tree(
        interop.from_jax_flat(flat, "cpu"))


def _clips(seed=1, b=B):
    t = _BASE["seq_length"] + 1
    return np.random.default_rng(seed).uniform(
        0, 1, (b, t, 32, 32, 1)).astype(np.float32)


def _close(got, want, rtol=1e-5, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _masks(jcfg, key, t, b):
    """The JAX package's dropout masks for one key (recurrent_image.py
    _run_lstm), as a port tensor."""
    keep = 1.0 - jcfg.lstm_dropout
    m = jax.random.bernoulli(key, keep, (jcfg.num_lstm_layers, t, b,
                                         jcfg.lstm_units))
    return torch.from_numpy(np.array(m.astype(jnp.float32) / keep))


@pytest.mark.parametrize("t", [1, 2])
def test_moments_norm_equals_jax(t):
    x = np.random.default_rng(0).normal(2.0, 3.0, (8, 4, 4, 6)).astype(
        np.float32)
    _close(tri.moments_norm(torch.from_numpy(x), t).numpy(),
           jri.moments_norm(jnp.asarray(x), t))


def test_lstm_step_equals_jax():
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(0, 0.3, (12 + 16, 64)).astype(np.float32),
         "b": rng.normal(0, 0.1, 64).astype(np.float32)}
    x, c, h = (rng.normal(size=(3, n)).astype(np.float32)
               for n in (12, 16, 16))
    (jc, jh), jout = jri.lstm_step({k: jnp.asarray(v) for k, v in p.items()},
                                   (jnp.asarray(c), jnp.asarray(h)),
                                   jnp.asarray(x))
    (tc, th), tout = tri.lstm_step({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   (torch.from_numpy(c), torch.from_numpy(h)),
                                   torch.from_numpy(x))
    assert tout is th
    _close(tc.numpy(), jc)
    _close(th.numpy(), jh)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generator_discriminator_rollout_equal_jax(variant):
    jcfg, tcfg = _cfgs(variant)
    flat = _flat_state(variant)
    jts, pts = _jax_state(flat), _port_state(flat)
    x = _clips()[:, :-1]
    key = jax.random.PRNGKey(4)
    masks = _masks(jcfg, key, 4, B) if jcfg.lstm_dropout else None
    jg = jax.jit(jri.generator, static_argnames=("cfg",))(
        jts.params_g, jnp.asarray(x), jcfg, d_params=jts.params_d,
        dropout_rng=key if jcfg.lstm_dropout else None)
    tg = tri.generator(pts.params_g, torch.from_numpy(x), tcfg,
                       d_params=pts.params_d, dropout=masks)
    _close(tg.numpy(), jg, err_msg="generator")
    jd = jax.jit(jri.discriminator, static_argnames=("cfg",))(
        jts.params_d, jnp.asarray(x), jcfg)
    _close(tri.discriminator(pts.params_d, torch.from_numpy(x),
                             tcfg).numpy(), jd, err_msg="discriminator")
    jr = jax.jit(jri.rollout, static_argnames=("cfg", "length"))(
        jts.params_g, jnp.asarray(x[:, 0]), 6, jcfg, d_params=jts.params_d)
    _close(tri.rollout(pts.params_g, torch.from_numpy(x[:, 0]), 6, tcfg,
                       d_params=pts.params_d).numpy(), jr,
           err_msg="rollout")


def test_dropout_draws_from_the_generator():
    """A torch generator draws fresh masks (two seeds differ); no dropout
    argument, or lstm_dropout 0, is deterministic."""
    _, tcfg = _cfgs("deep_dropout")
    pts = _port_state(_flat_state("deep_dropout"))
    x = torch.from_numpy(_clips()[:, :-1])
    gen = lambda s: torch.Generator().manual_seed(s)
    a = tri.generator(pts.params_g, x, tcfg, dropout=gen(1))
    b = tri.generator(pts.params_g, x, tcfg, dropout=gen(2))
    assert not torch.allclose(a, b)
    c = tri.generator(pts.params_g, x, tcfg)
    torch.testing.assert_close(c, tri.generator(pts.params_g, x, tcfg),
                               rtol=0, atol=0)
    m = tri.dropout_masks(gen(3), tcfg, 4, B)
    assert m.shape == (3, 4, B, 16)
    assert set(np.unique(m.numpy()).tolist()) <= {0.0, 1.0 / 0.8}


@pytest.mark.parametrize("variant,step", [(v, 0) for v in sorted(VARIANTS)]
                         + [("residual_pixel_warmup", 7)])
def test_train_step_equals_jax(variant, step):
    """One step (1 D + 2 G updates) from one converted state: the losses
    and every weight, Adam slot and the step. For the warm-up variant at
    step 0 the adversarial term is gated off; at step 7 it is on."""
    jcfg, tcfg = _cfgs(variant)
    flat = _flat_state(variant)
    flat["step"] = np.asarray(step, np.int32)
    jt, tt = TrainConfig(batch_size=B), tconfig.TrainConfig(batch_size=B)
    clips = _clips(2)
    rng = jax.random.PRNGKey(9)
    masks = None
    if jcfg.lstm_dropout:
        masks = [_masks(jcfg, k, 4, B) for k in jax.random.split(rng, 3)]
    jts, jm = jrt.train_step(_jax_state(flat), jnp.asarray(clips), rng,
                             jcfg, jt)
    pts, pm = trt.train_step(_port_state(flat), torch.from_numpy(clips),
                             None, tcfg, tt, dropout_masks=masks)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        _close(float(pm[k]), float(jm[k]), err_msg=k)
    if variant == "residual_pixel_warmup":
        adv_w = 1.0 if step >= 5 else 0.0
        np.testing.assert_allclose(
            float(pm["g_loss"]),
            adv_w * float(pm["g_loss_adv"]) + 10.0 * float(pm["pixel_mae"]),
            rtol=1e-6)
    jflat = jckpt._flatten_with_paths(jts._asdict())
    back = interop.to_jax_flat(pts)
    assert sorted(back) == sorted(jflat)
    for k, v in jflat.items():
        v = np.asarray(v)
        if k.startswith("params"):
            np.testing.assert_allclose(back[k], v, rtol=0, atol=3 * LR,
                                       err_msg=k)
        elif k.endswith("count") or k == "step":
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert int(pts.step) == step + 1


def test_predict_and_sample_rollout_equal_jax():
    jcfg, tcfg = _cfgs("plain")
    flat = _flat_state("plain")
    jts, pts = _jax_state(flat), _port_state(flat)
    clips = _clips(3)
    _close(trt.predict(pts, torch.from_numpy(clips), tcfg).numpy(),
           jrt.predict(jts, jnp.asarray(clips), jcfg), err_msg="predict")
    got = trt.sample_rollout(pts, torch.from_numpy(clips[:, 0]), 5, tcfg)
    _close(got.numpy(),
           jrt.sample_rollout(jts, jnp.asarray(clips[:, 0]), 5, jcfg),
           err_msg="sample_rollout")
    assert got.shape == (B, 5, 32, 32, 1) and not got.requires_grad


def test_init_train_state_shapes_equal_jax():
    """The port's own init has the JAX package's keys, shapes (through the
    layouts) and dtypes, for every variant."""
    for variant in VARIANTS:
        jcfg, tcfg = _cfgs(variant)
        want = _spec(jrt.init_train_state, jax.random.PRNGKey(0), jcfg,
                     TrainConfig())
        got = interop.to_jax_flat(trt.init_train_state(
            torch.Generator().manual_seed(0), tcfg,
            tconfig.TrainConfig(), device="cpu"))
        assert sorted(got) == sorted(want), variant
        for k, v in want.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k


# ---------------------------------------------------------------------------
# weight layouts of the new trees (core/interop.py)
# ---------------------------------------------------------------------------

def _new_trees():
    """Flat JAX-layout trees of every family this slice brought."""
    from gifgan_tpu.core.config import DCGANConfig
    from gifgan_tpu.models import prednet as jprednet
    from gifgan_tpu.models import rnn_prototypes as jproto
    from gifgan_tpu.train import gan as jgan

    key = jax.random.PRNGKey(0)
    trees = {v: _flat_state(v) for v in VARIANTS}
    trees["prednet"] = _spec(jprednet.init, key, jprednet.PredNetConfig(
        image_size=16, channels=(8, 16)))
    trees["cond_dcgan"] = _spec(
        jgan.init_cond_train_state, key, DCGANConfig(
            output_size=28, c_dim=1, z_dim=16, gf_dim=8, df_dim=8), 10,
        TrainConfig())
    trees["echo"] = _spec(jproto.echo_rnn_init, key)
    trees["vector_echo"] = _spec(jproto.vector_echo_init, key, 6)
    trees["conv_cls"] = _spec(jproto.conv_cls_init, key)
    return {name: _random_flat(spec) if name not in VARIANTS else spec
            for name, spec in trees.items()}


def test_every_4d_leaf_of_the_new_trees_is_permuted_and_no_other():
    """Every 4-D weight crosses as (3, 2, 0, 1) — HWIO -> OIHW for the
    convs (recurrent enc*/conv*, PredNet lstm*/ahat*/up*, conditional D,
    conv_cls) and [h, w, out, in] -> (in, out, h, w) for the transpose
    convs (recurrent dec*, conditional G) — and every other leaf (the 2-D
    LSTM and linear weights, biases, BN, Adam counts) unchanged; the round
    trip is bit-exact."""
    for name, flat in _new_trees().items():
        port = interop.from_jax_flat(flat, "cpu")
        seen4 = 0
        for k, v in flat.items():
            node = port
            for p in interop._OPT_JAX.sub(r"\1/", k).split("/"):
                node = node[p]
            got = node.numpy()
            v = np.asarray(v)
            if v.ndim == 4:
                seen4 += 1
                np.testing.assert_array_equal(got, v.transpose(3, 2, 0, 1),
                                              err_msg=f"{name} {k}")
            else:
                np.testing.assert_array_equal(got, v, err_msg=f"{name} {k}")
        assert seen4 > 0 or name in ("echo", "vector_echo"), name
        back = interop.to_jax_flat(port)
        assert sorted(back) == sorted(flat), name
        for k, v in flat.items():
            assert back[k].dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(back[k], v, err_msg=f"{name} {k}")


def _perm_before(key, ndim):
    """core/interop.py's rule before this family: a permutation by the
    layer's name ("deconv", "conv") and rank."""
    parts = key.split("/")
    if parts[-1] not in ("w", "wq") or len(parts) < 2:
        return None
    layer = parts[-2]
    if "deconv" in layer and ndim == 4:
        return (3, 2, 0, 1)
    if "conv" in layer and ndim == 4:
        return (3, 2, 0, 1)
    if "conv" in layer and ndim == 5:
        return (4, 3, 0, 1, 2)
    return None


def test_the_older_trees_convert_exactly_as_before():
    """The image GAN's and video GAN's train states and an int8 serving
    tree: every leaf gets the permutation the name rule gave it."""
    from gifgan_tpu.core.config import DCGANConfig, VidGANConfig
    from gifgan_tpu.ops import quant as jquant
    from gifgan_tpu.train import gan as jgan
    from gifgan_tpu.train import vid as jvid

    img = DCGANConfig(output_size=32, c_dim=3, z_dim=8, gf_dim=8, df_dim=8)
    vcfg = VidGANConfig(z_input_size=12, z_output_size=8, vid_length=2,
                        hidden_dim=16, d_filters=8, image_gan=img)
    key = jax.random.PRNGKey(0)
    ts = jax.eval_shape(lambda: jvid.init_train_state(key, vcfg,
                                                      TrainConfig()))
    trees = [_spec(jgan.init_train_state, key, img, TrainConfig()),
             _spec(jvid.init_train_state, key, vcfg, TrainConfig(
                 train_img_gen=True, train_img_disc=True)),
             _keyed(jax.eval_shape(jquant.quantize_vid_stack, ts.params,
                                   ts.state))]
    n = 0
    for spec in trees:
        for k, v in spec.items():
            assert interop._perm(k, len(v.shape)) == _perm_before(
                k, len(v.shape)), k
            n += 1
    assert n > 100


def test_checkpoints_cross_both_ways(tmp_path):
    """A JAX RecurrentTrainState saved by the JAX package restores into a
    fresh port state (each leaf the converted JAX array), and the port's
    state saved through AsyncCheckpointer restores into the JAX one, bit
    for bit, at the JAX keys."""
    jcfg, tcfg = _cfgs("share_disc_conv")
    flat = _flat_state("share_disc_conv", seed=5)
    flat["step"] = np.asarray(11, np.int32)
    jdir = str(tmp_path / "jax")
    jckpt.save(jdir, 11, _jax_state(flat)._asdict())
    fresh = trt.init_train_state(torch.Generator().manual_seed(1), tcfg,
                                 tconfig.TrainConfig(), device="cpu")
    got = tckpt.restore(jdir, fresh)
    assert isinstance(got, trt.RecurrentTrainState) and int(got.step) == 11
    for k, v in interop.to_jax_flat(got).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)

    pdir = str(tmp_path / "port")
    saver = tckpt.AsyncCheckpointer()
    saver.save(pdir, 11, got)
    saver.close()
    back = jckpt.restore(pdir, _jax_state(_flat_state("share_disc_conv",
                                                      seed=6))._asdict())
    for k, v in jckpt._flatten_with_paths(back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
