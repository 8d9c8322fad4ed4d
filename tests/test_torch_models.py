"""The port's models (gifgan_tpu_torch/models) against the JAX package's, on
the golden-sized configs of tests/test_golden.py and
tests/test_trajectory_golden.py, float32 on the CPU.

Random-init outputs are ~1e-5 (test_golden.py), where any comparison is
meaningless, so both packages get the same numpy-drawn weights at std 0.2
(BN scales 1 +- 0.1, running moments near (0, 1)).

Tolerance: rtol 1e-4 plus an atol of 1e-4 x the array's largest |value|.
Four conv layers and up to three batch norms in float32 compound the
per-layer accumulation-order differences (1e-5 each, test_torch_nn.py);
train-mode BN divides by batch standard deviations and amplifies them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import DCGANConfig, VidGANConfig
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu.models import vid_dcgan as jvid
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.config import DCGANConfig as TDCGANConfig
from gifgan_tpu_torch.core.config import VidGANConfig as TVidGANConfig
from gifgan_tpu_torch.models import dcgan as tdcgan
from gifgan_tpu_torch.models import vid_dcgan as tvid
from gifgan_tpu_torch.ops import nn as tnn

RTOL = 1e-4


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def randomize(flat, seed=0, std=0.2):
    """Same-shaped numpy leaves: weights N(0, std), biases N(0, 0.1), BN
    scale 1 + N(0, 0.1), running mean N(0, 0.1), running var 1 + U(0, 0.2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(flat.items()):
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "w":
            x = std * rng.standard_normal(v.shape)
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


def _unflatten_jax(flat):
    tree = {}
    for k, v in flat.items():
        *ps, last = k.split("/")
        node = tree
        for p in ps:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return tree


def _both(jtree, seed=0):
    """(JAX tree, port tree) of the same random numbers."""
    flat = randomize(_flatten_with_paths(jtree), seed)
    return _unflatten_jax(flat), interop.from_jax_flat(flat, device="cpu")


def _cfgs(packed, c_dim):
    kw = dict(output_size=32, c_dim=c_dim, z_dim=8, gf_dim=8, df_dim=8,
              packed_c3=packed)
    return DCGANConfig(**kw), TDCGANConfig(**kw)


CASES = [(packed, c_dim, train) for packed in (False, True)
         for c_dim in (1, 3) for train in (True, False)]


@pytest.mark.parametrize("packed,c_dim,train", CASES)
def test_dcgan_generator(packed, c_dim, train):
    jcfg, tcfg = _cfgs(packed, c_dim)
    p, s = jdcgan.init_generator(jax.random.PRNGKey(0), jcfg)
    (jp, tp), (js, ts) = _both(p, 1), _both(s, 2)
    z = np.random.default_rng(3).uniform(-1, 1, (6, 8)).astype(np.float32)
    y_j, ns_j = jdcgan.generator(jp, js, jnp.asarray(z), jcfg, train)
    y_t, ns_t = tdcgan.generator(tp, ts, torch.from_numpy(z), tcfg, train)
    assert y_t.shape == (6, 32, 32, c_dim) and y_t.dtype == torch.float32
    _close(y_t, y_j, "image")
    for k in ns_j:
        for m in ("mean", "var"):
            _close(ns_t[k][m], ns_j[k][m], f"{k}/{m}")


@pytest.mark.parametrize("packed,c_dim,train", CASES)
def test_dcgan_discriminator(packed, c_dim, train):
    jcfg, tcfg = _cfgs(packed, c_dim)
    p, s = jdcgan.init_discriminator(jax.random.PRNGKey(0), jcfg)
    (jp, tp), (js, ts) = _both(p, 4), _both(s, 5)
    x = np.random.default_rng(6).uniform(-1, 1, (6, 32, 32, c_dim)
                                         ).astype(np.float32)
    lj, h2j, ns_j = jdcgan.discriminator(jp, js, jnp.asarray(x), jcfg, train)
    lt, h2t, ns_t = tdcgan.discriminator(tp, ts, torch.from_numpy(x), tcfg,
                                         train)
    assert lt.shape == (6, 1) and h2t.shape == (6, 4, 4, 32)
    _close(lt, lj, "logits")
    _close(h2t, h2j, "h2 tap")
    for k in ns_j:
        for m in ("mean", "var"):
            _close(ns_t[k][m], ns_j[k][m], f"{k}/{m}")
    h2_tap, _ = tdcgan.discriminator_tap(tp, ts, torch.from_numpy(x), tcfg,
                                         train)
    assert torch.equal(h2_tap, h2t)


def _vcfgs(packed=False):
    img_kw = dict(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8,
                  packed_c3=packed)
    kw = dict(z_input_size=20, z_output_size=16, vid_length=4, hidden_dim=32,
              d_filters=16, first_frame_loss_scalar=1.0)
    return (VidGANConfig(image_gan=DCGANConfig(**img_kw), **kw),
            TVidGANConfig(image_gan=TDCGANConfig(**img_kw), **kw))


@pytest.mark.parametrize("train", [True, False])
def test_vid_generator(train):
    jcfg, tcfg = _vcfgs()
    p, s = jvid.init_vid_generator(jax.random.PRNGKey(0), jcfg)
    (jp, tp), (js, ts) = _both(p, 7), _both(s, 8)
    z = np.random.default_rng(9).uniform(-1, 1, (5, 20)).astype(np.float32)
    gj, ns_j = jvid.vid_generator(jp, js, jnp.asarray(z), jcfg, train)
    gt, ns_t = tvid.vid_generator(tp, ts, torch.from_numpy(z), tcfg, train)
    assert gt.shape == (20, 16)
    _close(gt, gj, "frame latents")
    for k in ns_j:
        for m in ("mean", "var"):
            _close(ns_t[k][m], ns_j[k][m], f"{k}/{m}")
    _close(tvid.first_frame_loss(gt, torch.from_numpy(z), tcfg),
           jvid.first_frame_loss(gj, jnp.asarray(z), jcfg), "ff loss")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("t", [4, 3])
def test_vid_discriminator(train, t):
    jcfg, tcfg = _vcfgs()
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "vid_length": t})
    tcfg = tcfg.__class__(**{**tcfg.__dict__, "vid_length": t})
    p, s = jvid.init_vid_discriminator(jax.random.PRNGKey(0), jcfg)
    (jp, tp), (js, ts) = _both(p, 10), _both(s, 11)
    acts = np.random.default_rng(12).standard_normal((2 * t, 4, 4, 32)
                                                     ).astype(np.float32)
    lj, ns_j = jvid.vid_discriminator(jp, js, jnp.asarray(acts), jcfg, train)
    lt, ns_t = tvid.vid_discriminator(tp, ts, torch.from_numpy(acts), tcfg,
                                      train)
    assert lt.shape == (2, 1)
    _close(lt, lj, "logits")
    for k in ns_j:
        for m in ("mean", "var"):
            _close(ns_t[k][m], ns_j[k][m], f"{k}/{m}")


@pytest.mark.parametrize("packed", [False, True])
def test_generate_videos(packed):
    """The nested stack: vid-G (train) feeding the image G (inference)."""
    jcfg, tcfg = _vcfgs(packed)
    p, s = jvid.init(jax.random.PRNGKey(0), jcfg)
    (jp, tp), (js, ts) = _both(p._asdict(), 13), _both(s._asdict(), 14)
    z = np.random.default_rng(15).uniform(-1, 1, (3, 20)).astype(np.float32)
    fj, gj, _, _ = jvid.generate_videos(jvid.VidGANParams(**jp),
                                        jvid.VidGANState(**js),
                                        jnp.asarray(z), jcfg, train=False)
    ft, gt, _, _ = tvid.generate_videos(tp, ts, torch.from_numpy(z), tcfg,
                                        train=False)
    _close(gt, gj, "frame latents")
    _close(ft, fj, "frames")


def test_port_init_shapes_match_jax():
    """The port's own init draws every leaf of the JAX tree, in the port's
    layout (interop maps the JAX shapes onto it)."""
    jcfg, tcfg = _vcfgs(True)
    p, s = jvid.init(jax.random.PRNGKey(0), jcfg)
    want = interop.from_jax_flat(
        _flatten_with_paths({"params": p._asdict(), "state": s._asdict()}),
        device="cpu")
    tp, ts = tvid.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    got = {"params": tp, "state": ts}
    from gifgan_tpu_torch.core.checkpoint import flatten
    fw, fg = flatten(want), flatten(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert fw[k].shape == fg[k].shape, k
        assert fg[k].dtype == torch.float32, k


def test_dcgan_init_and_sample():
    """init on the CPU from a seed is reproducible; sample() is the
    inference-mode generator (running moments, state untouched)."""
    _, tcfg = _cfgs(True, 3)
    p1, s1 = tdcgan.init(torch.Generator().manual_seed(4), tcfg, "cpu")
    p2, _ = tdcgan.init(torch.Generator().manual_seed(4), tcfg, "cpu")
    assert torch.equal(p1["generator"]["h1_deconv"]["w"],
                       p2["generator"]["h1_deconv"]["w"])
    w = p1["discriminator"]["h0_conv"]["w"]
    assert w.shape == (8, 3, 5, 5) and float(w.abs().max()) <= 0.04
    z = torch.rand(5, 8) * 2 - 1
    x = tdcgan.sample(p1, s1, z, tcfg)
    want, _ = tdcgan.generator(p1["generator"], s1["generator"], z, tcfg,
                               train=False)
    assert x.shape == (5, 32, 32, 3) and torch.equal(x, want)
    assert not x.requires_grad


# ---------------------------------------------------------------------------
# the image nets' inference batch norm, folded into the layer before it
# (ops/nn.py bn_after), against the unfolded composition
# ---------------------------------------------------------------------------

IMG_NETS = ("generator", "discriminator_tap", "discriminator")


def _unfolded_bn_after(layer, bn_params, bn_state, train, out_axis, reps=1):
    """nn.bn_after without the fold: the layer as it is, then
    nn.batch_norm."""
    return layer, functools.partial(tnn.batch_norm, bn_params, bn_state,
                                    train=train)


def _img_net(net, dtype="float32", seed=0, batch=16):
    """run(params, train, fold) -> (outputs..., new state) of one image
    net at test size, with its (params, BN state): weights at std 0.05
    (activations of order 1 through every layer), BN params and running
    moments far from the init's, all drawn from `seed`."""
    kw = dict(output_size=32, c_dim=3, z_dim=8, gf_dim=8, df_dim=8,
              packed_c3=True)
    jcfg, tcfg = DCGANConfig(**kw), TDCGANConfig(compute_dtype=dtype, **kw)
    init = (jdcgan.init_generator if net == "generator"
            else jdcgan.init_discriminator)
    jp, _ = init(jax.random.PRNGKey(0), jcfg)
    params = interop.from_jax_flat(
        randomize(_flatten_with_paths(jp), seed, std=0.05), device="cpu")
    rng = np.random.default_rng(seed + 1000)
    state = {}
    for k in [k for k in params if k.startswith("bn")]:
        c = params[k]["scale"].shape[0]
        params[k] = {"scale": 1 + 0.3 * rng.standard_normal(c),
                     "bias": 0.5 * rng.standard_normal(c)}
        state[k] = {"mean": 0.5 * rng.standard_normal(c),
                    "var": rng.uniform(0.3, 3.0, c)}
    params, state = ({k: {m: torch.as_tensor(v, dtype=torch.float32)
                          for m, v in d.items()} for k, d in t.items()}
                     for t in (params, state))
    shape = (batch, 8) if net == "generator" else (batch, 32, 32, 3)
    x = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    fn = getattr(tdcgan, net)

    def run(p, train, fold=True):
        with pytest.MonkeyPatch.context() as mp:
            if not fold:
                mp.setattr(tnn, "bn_after", _unfolded_bn_after)
            return fn(p, state, x, tcfg, train)

    return run, params, state


@pytest.mark.parametrize("net", IMG_NETS)
def test_inference_fold_float32(net):
    """train=False, float32: every output within 1e-5 of its largest
    |value| of the unfolded composition's; the BN state unchanged."""
    run, params, state = _img_net(net)
    *got, got_s = run(params, False)
    *want, _ = run(params, False, fold=False)
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0.1
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), err
    assert got_s.keys() <= state.keys() and got_s
    assert all(got_s[k] is state[k] for k in got_s)


@pytest.mark.parametrize("net", IMG_NETS)
def test_inference_fold_bfloat16(net):
    """train=False, bfloat16: no further from the float32 unfolded
    composition than the bfloat16 unfolded one, with a margin of 10 %.

    Further: the root of the summed squared differences over 24 nets.
    Either path rounds its weights to bfloat16 once (w * g against w),
    so each net draws one fixed rounding of them, and a readout of few
    numbers (the logits) parts the two paths by 0.6-1.7x either way from
    net to net; the pool averages that draw out."""
    sq = []
    for seed in range(24):
        run32, params, _ = _img_net(net, seed=seed)
        run16, _, _ = _img_net(net, "bfloat16", seed=seed)
        *ref, _ = run32(params, False, fold=False)
        *got, _ = run16(params, False)
        *unf, _ = run16(params, False, fold=False)
        sq.append([(float((g.float() - r).pow(2).sum()),
                    float((u.float() - r).pow(2).sum()))
                   for r, g, u in zip(ref, got, unf)])
    for i in range(len(sq[0])):
        fold = sum(s[i][0] for s in sq) ** 0.5
        unfold = sum(s[i][1] for s in sq) ** 0.5
        assert 0 < fold <= 1.1 * unfold, (i, fold, unfold)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", IMG_NETS)
def test_train_mode_does_not_fold(net, dtype):
    """train=True: outputs and new state bit for bit the unfolded
    code's."""
    run, params, _ = _img_net(net, dtype)
    *got, got_s = run(params, True)
    *want, want_s = run(params, True, fold=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        for m in ("mean", "var"):
            assert torch.equal(got_s[k][m], want_s[k][m]), (k, m)


@pytest.mark.parametrize("net", IMG_NETS)
def test_inference_fold_gradients_of_trainable_nets(net):
    """A trainable image net in inference mode (train_img_gen,
    train_img_disc): the gradients of every w, b, scale and bias through
    the fold match the unfolded path's, float32."""
    run, params, _ = _img_net(net)
    grads = []
    for fold in (True, False):
        p = {k: {m: v.clone().requires_grad_(True) for m, v in d.items()}
             for k, d in params.items()}
        *outs, _ = run(p, False, fold)
        loss = sum((o * torch.cos(torch.arange(o.numel()).reshape(o.shape)
                                  .float())).sum() for o in outs)
        keys = [(k, m) for k in sorted(p) for m in sorted(p[k])]
        gs = torch.autograd.grad(loss, [p[k][m] for k, m in keys],
                                 allow_unused=True)
        grads.append(dict(zip(keys, gs)))
    got, want = grads
    for key, w in want.items():
        if w is None:                  # the tap's unused h3 layers
            assert got[key] is None, key
            continue
        err = float((got[key] - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (key, err)
