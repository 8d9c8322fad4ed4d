"""The port's latent inversion (gifgan_tpu_torch/invert/) against the JAX
package's (gifgan_tpu/invert/), float32 on the CPU, from the same weights:
the JAX init of one key scaled by 3, converted through core/interop.py
from_jax_flat. A boosted generator, as tests/test_invert.py's: at random
init the generator is near-degenerate and dL/dz is at rounding level, where
Adam's eps placement turns noise into +-lr steps; each gradient test
asserts that the smallest |dL/dz| is far above that. Scaled by 6 (that
test's factor) the boosted nets saturate the tanh and the 12-step run is
chaotic: float32 rounding parts the two packages' runs by 1e-2 in the loss
within 12 steps at lr 0.1, while scaled by 3 they agree to 1e-6 and the
loss falls by 40 %.

z0 comes from the JAX draw: `invert` takes it as `z0`, and the wrappers'
own draw (`optimize.initial_z`, torch's generator) is replaced by the JAX
draw of the same seed.

Tolerances, each with its reason:
- a loss within 1e-5 relative and dL/dz within 1e-4 of its largest |value|:
  float32 accumulation order through the convs and BN;
- Adam runs (12 steps and more): loss histories within 1e-4 relative, z
  within 1e-4 abs: the same rounding fed back through the updates.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.core.checkpoint import _flatten_with_paths
from gifgan_tpu.core.config import (DCGANConfig as JDCGANConfig,
                                    InvertConfig as JInvertConfig,
                                    VidGANConfig as JVidGANConfig)
from gifgan_tpu.invert import optimize as jopt
from gifgan_tpu.invert import z_finder as jzf
from gifgan_tpu.models import dcgan as jdcgan
from gifgan_tpu.models import vid_dcgan as jvid_dcgan
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.invert import optimize as topt
from gifgan_tpu_torch.invert import z_finder as tzf
from gifgan_tpu_torch.models import dcgan as tdcgan

_IMG = dict(output_size=32, c_dim=1, z_dim=12, gf_dim=8, df_dim=8)
_VID = dict(z_input_size=16, z_output_size=12, vid_length=4, hidden_dim=32,
            d_filters=16)


def _cfgs(**img_kw):
    img = dict(_IMG, **img_kw)
    return JDCGANConfig(**img), tconfig.DCGANConfig(**img)


def _icfgs(**kw):
    return JInvertConfig(**kw), tconfig.InvertConfig(**kw)


def _port(tree):
    """A JAX pytree ({"params": ..., "state": ...}) -> the port's dicts."""
    return interop.from_jax_flat(_flatten_with_paths(tree), "cpu")


def _boost(t):
    return jax.tree_util.tree_map(lambda x: x * 3.0, t)


def _image_gan(c_dim=1):
    """(JAX params, state, port params, state) of the boosted image GAN."""
    jcfg, _ = _cfgs(c_dim=c_dim)
    params, state = jax.jit(jdcgan.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    params = jdcgan.DCGANParams(_boost(params.generator),
                                _boost(params.discriminator))
    t = _port({"params": params, "state": state})
    return params, state, t["params"], t["state"]


@pytest.fixture(scope="module")
def gan1():
    return _image_gan(1)


@pytest.fixture(scope="module")
def gan3():
    return _image_gan(3)


def _jax_z(shape, seed=0):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                       minval=-1.0, maxval=1.0))


@pytest.fixture
def jax_z0(monkeypatch):
    """The port's wrappers draw z0 as the JAX package does from the same
    seed."""
    monkeypatch.setattr(topt, "initial_z", lambda shape, seed, device:
                        torch.as_tensor(_jax_z(shape, seed), device=device))


def _targets(jp, js, jcfg, n, seed):
    return np.asarray(jdcgan.sample(jp, js, jnp.asarray(_jax_z((n, 12),
                                                               seed)), jcfg))


def _close(got, want, rtol, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


def test_normalized_weights_and_capture_steps_equal_the_jax_package():
    for kw in (dict(), dict(pixel_l1=1.0, activation_l1=0.3, pixel_l2=0.7),
               dict(pixel_l1=0.0, activation_l1=0.0, generator_loss=2.0)):
        j, t = _icfgs(**kw)
        assert topt.normalized_weights(t) == jopt.normalized_weights(j)
    with pytest.raises(ValueError, match="positive"):
        topt.normalized_weights(tconfig.InvertConfig(pixel_l1=0.0,
                                                     activation_l1=0.0))
    for total, sections in [(20, [(0, 1), (10, 5)]), (200, [(0, 1), (50, 10)]),
                            (12, [(3, 4)]), (7, None), (30, [(0, 7), (9, 2),
                                                            (20, 6)])]:
        assert (topt._capture_steps(total, sections)
                == jopt._capture_steps(total, sections))


_PROBLEMS = {
    "image_inference": dict(pixel_l1=1.0, pixel_l2=0.5, activation_l1=0.3,
                            activation_l2=0.2),
    "image_train_gloss": dict(pixel_l1=1.0, activation_l2=0.3,
                              generator_loss=0.1,
                              use_train_mode_activations=True),
    "image_pixel_only": dict(pixel_l1=1.0, activation_l1=0.0),
}


@pytest.mark.parametrize("name", sorted(_PROBLEMS))
def test_image_loss_and_z_gradient_equal_jax(gan3, name):
    jp, js, tp, ts = gan3
    jcfg, tcfg = _cfgs(c_dim=3)
    jicfg, ticfg = _icfgs(**_PROBLEMS[name])
    targets = _targets(jp, js, jcfg, 4, 1)
    z = _jax_z((4, 12), 2)
    jprob = jopt.image_problem(jp, js, jnp.asarray(targets), jcfg, jicfg)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda zz: jprob.loss_fn(zz)[0]))(
        jnp.asarray(z))
    jgrad = np.asarray(jgrad)
    # the boosted generator keeps every dL/dz far above rounding noise
    assert np.abs(jgrad).min() > 1e-6, np.abs(jgrad).min()

    tprob = topt.image_problem(tp, ts, targets, tcfg, ticfg, device="cpu")
    zt = torch.from_numpy(z).requires_grad_(True)
    tloss, imgs = tprob.loss_fn(zt)
    (tgrad,) = torch.autograd.grad(tloss, zt)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    _close(tgrad.numpy(), jgrad, 1e-4)
    assert imgs.shape == (4, 32, 32, 3)


def _vid_gan():
    jimg, timg = _cfgs()
    jcfg = JVidGANConfig(image_gan=jimg, **_VID)
    tcfg = tconfig.VidGANConfig(image_gan=timg, **_VID)
    params, state = jax.jit(jvid_dcgan.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    # the video MLP too (by 10: at 0.02-std init its four layers shrink
    # dL/dz to ~1e-7)
    params = params._replace(
        vid_generator=jax.tree_util.tree_map(lambda x: x * 10.0,
                                             params.vid_generator),
        img_generator=_boost(params.img_generator),
        img_discriminator=_boost(params.img_discriminator))
    t = _port({"params": params, "state": state})
    return jcfg, tcfg, params, state, t["params"], t["state"]


@pytest.fixture(scope="module")
def vid_gan():
    return _vid_gan()


def test_nested_first_frame_loss_and_gradient_equal_jax(vid_gan):
    jcfg, tcfg, jp, js, tp, ts = vid_gan
    jicfg, ticfg = _icfgs(pixel_l1=1.0, activation_l1=0.3,
                          generator_loss=0.1)
    targets = np.random.default_rng(3).uniform(
        -1, 1, (2, 32, 32, 1)).astype(np.float32)
    z = _jax_z((2, 16), 4)
    jprob = jopt.nested_first_frame_problem(jp, js, jnp.asarray(targets),
                                            jcfg, jicfg)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda zz: jprob.loss_fn(zz)[0]))(
        jnp.asarray(z))
    jgrad = np.asarray(jgrad)
    assert np.abs(jgrad).min() > 1e-6, np.abs(jgrad).min()

    tprob = topt.nested_first_frame_problem(tp, ts, targets, tcfg, ticfg,
                                            device="cpu")
    assert tprob.z_shape == jprob.z_shape == (2, 16)
    zt = torch.from_numpy(z).requires_grad_(True)
    tloss, frames = tprob.loss_fn(zt)
    (tgrad,) = torch.autograd.grad(tloss, zt)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    _close(tgrad.numpy(), jgrad, 1e-4)
    assert frames.shape == (8, 32, 32, 1)


def test_invert_images_with_a_decay_boundary_equals_jax(gan1, jax_z0):
    """12 Adam steps, the rate halved at steps 4 and 8, frames captured
    every 4 steps (chunks of 4): loss histories, z and the captured frames
    against the JAX package's from its z0."""
    jp, js, tp, ts = gan1
    jcfg, tcfg = _cfgs()
    kw = dict(steps=12, learning_rate=0.1, lr_decay_every=4,
              lr_decay_factor=0.5, pixel_l1=1.0, activation_l1=0.3,
              batch_size=4)
    jicfg, ticfg = _icfgs(**kw)
    targets = _targets(jp, js, jcfg, 4, 1)
    sections = [(0, 4)]
    jz, jlosses, jframes = jopt.invert_images(
        jp, js, jnp.asarray(targets), jcfg, jicfg, key=jax.random.PRNGKey(5),
        progress_sections=sections)
    tz, tlosses, tframes = topt.invert_images(
        tp, ts, targets, tcfg, ticfg, seed=5, progress_sections=sections,
        device="cpu")
    assert tlosses.shape == jlosses.shape == (12,)
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-4)
    assert jlosses[-1] < 0.9 * jlosses[0]
    # captures at 0, 4, 8 and the end
    assert len(tframes) == len(jframes) == 4
    for t_f, j_f in zip(tframes, jframes):
        np.testing.assert_allclose(t_f, np.asarray(j_f), rtol=0, atol=1e-4)

    # the schedule: step k runs at lr * 0.5 ** (k // 4), step 0 at the full
    # rate; the constant rate when no decay is asked for
    assert [topt._learning_rate(ticfg, k) for k in (0, 3, 4, 8, 11)] == [
        np.float32(0.1), np.float32(0.1), np.float32(0.05), np.float32(0.025),
        np.float32(0.025)]
    assert topt._learning_rate(dataclasses.replace(
        ticfg, lr_decay_factor=1.0), 9) == 0.1


def test_invert_video_joint_and_iterative_equal_jax(gan1, jax_z0):
    jp, js, tp, ts = gan1
    jcfg, tcfg = _cfgs()
    jicfg, ticfg = _icfgs(steps=6, learning_rate=0.1, pixel_l1=1.0,
                          activation_l1=0.3, batch_size=6)
    frames = _targets(jp, js, jcfg, 6, 2)          # 2 videos x T = 3

    jz, jl, _ = jopt.invert_video_joint(jp, js, jnp.asarray(frames), jcfg,
                                        jicfg)
    tz, tl, _ = topt.invert_video_joint(tp, ts, frames, tcfg, ticfg,
                                        device="cpu")
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-4)

    videos = frames.reshape(2, 3, 32, 32, 1)
    jtraj = jopt.invert_video_iterative(
        jp, js, jnp.asarray(videos), jcfg, jicfg, num_initial_steps=5,
        num_steps_per_frame=3)
    ttraj = topt.invert_video_iterative(
        tp, ts, videos, tcfg, ticfg, num_initial_steps=5,
        num_steps_per_frame=3, device="cpu")
    assert isinstance(ttraj, np.ndarray) and ttraj.shape == (3, 2, 12)
    np.testing.assert_allclose(ttraj, np.asarray(jtraj), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="V, T"):
        topt.invert_video_iterative(tp, ts, frames, tcfg, ticfg,
                                    device="cpu")


def test_invert_nested_first_frame_runs_and_equals_jax(vid_gan, jax_z0):
    jcfg, tcfg, jp, js, tp, ts = vid_gan
    jicfg, ticfg = _icfgs(steps=5, learning_rate=0.1, pixel_l1=1.0,
                          batch_size=2)
    targets = np.random.default_rng(3).uniform(
        -1, 1, (2, 32, 32, 1)).astype(np.float32)
    jz, jl, _ = jopt.invert_nested_first_frame(jp, js, jnp.asarray(targets),
                                               jcfg, jicfg)
    tz, tl, _ = topt.invert_nested_first_frame(tp, ts, targets, tcfg, ticfg,
                                               device="cpu")
    assert tz.shape == (2, 16)                    # the VIDEO latent
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-4)


def test_initial_z_is_a_seeded_uniform_draw():
    a = topt.initial_z((64, 12), 3, "cpu")
    assert a.shape == (64, 12) and a.dtype == torch.float32
    assert float(a.min()) >= -1.0 and float(a.max()) < 1.0
    torch.testing.assert_close(a, topt.initial_z((64, 12), 3, "cpu"),
                               rtol=0, atol=0)
    assert not torch.equal(a, topt.initial_z((64, 12), 4, "cpu"))


def test_apply_latent_path_and_z_helpers_equal_jax(gan1):
    jp, js, tp, ts = gan1
    jcfg, tcfg = _cfgs()
    z = _jax_z((2, 12), 7)
    path = np.stack([np.zeros(12), np.full(12, 0.1), np.full(12, 0.2)]) + 0.3
    want = np.asarray(jopt.apply_latent_path(jp, js, jnp.asarray(z), path,
                                             jcfg))
    got = topt.apply_latent_path(tp, ts, torch.from_numpy(z), path, tcfg,
                                 device="cpu")
    assert got.shape == (3, 2, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # frame 0 is the recovered z itself: deltas from path[0]
    torch.testing.assert_close(
        got[0], tdcgan.sample(tp, ts, torch.from_numpy(z), tcfg),
        rtol=0, atol=0)

    zs = np.arange(24, dtype=np.float32).reshape(6, 4)   # 2 videos x T=3
    for f in (0, 1, 2):
        np.testing.assert_array_equal(
            topt.broadcast_z_forward(torch.from_numpy(zs), f, 3).numpy(),
            np.asarray(jopt.broadcast_z_forward(jnp.asarray(zs), f, 3)))
    rng = np.random.default_rng(0)
    for shape in ((4,), (3, 4)):
        za, zb = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        got = topt.tween_z(torch.from_numpy(za), torch.from_numpy(zb), 5)
        want = np.asarray(jopt.tween_z(jnp.asarray(za), jnp.asarray(zb), 5))
        assert got.shape == want.shape == (5,) + shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[0].numpy(), za)


def test_extract_z_trajectories_equals_jax_and_resumes(gan1, jax_z0,
                                                       tmp_path):
    """3 clips of 3 frames (batch 2: the second batch padded), one clip of
    another shape met while a batch is pending (skipped), one that cannot
    be decoded (skipped): trajectories against the JAX package's, then the
    resume and `stop_after` (the comparison GIFs: tests/test_torch_cli.py,
    3 channels). Targets of seeds 13-15: with seeds 10-12, c1's path meets
    an image-G ReLU input at 1e-7 of its layer's largest value, where the
    order of the float32 sums decides its routing (the folded inference
    BN, ops/nn.py bn_after, sums in another order than the JAX package's
    BN), and Adam's steps carry the routing into the trajectory."""
    jp, js, tp, ts = gan1
    jcfg, tcfg = _cfgs()
    jicfg, ticfg = _icfgs(steps=6, learning_rate=0.1, pixel_l1=1.0,
                          activation_l1=0.3, batch_size=6)
    clips = {f"c{i}.gif": _targets(jp, js, jcfg, 3, 13 + i)
             for i in range(3)}
    clips["c0b.gif"] = clips["c0.gif"][:2]         # another shape
    clips["c0c.gif"] = None                          # undecodable
    paths = sorted(clips)                            # c0, c0b, c0c, c1, c2
    load = lambda p: clips[os.path.basename(p)]
    kw = dict(batch_size=2, num_initial_steps=5, num_steps_per_frame=3)

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jw = jzf.extract_z_trajectories(jp, js, jcfg, jicfg, paths, load, jout,
                                    **kw)
    tw = tzf.extract_z_trajectories(tp, ts, tcfg, ticfg, paths, load, tout,
                                    device="cpu", **kw)
    assert [os.path.basename(p) for p in tw] == [
        os.path.basename(p) for p in jw] == ["c0.npy", "c1.npy", "c2.npy"]
    for name in ("c0", "c1", "c2"):
        got = np.load(os.path.join(tout, name + ".npy"))
        assert got.shape == (3, 12)
        np.testing.assert_allclose(
            got, np.load(os.path.join(jout, name + ".npy")), rtol=0,
            atol=1e-4, err_msg=name)

    # resume: nothing new from the clips written (a later call meets c0b
    # first in its batch, and so takes it, as the reference does)
    good = [p for p in paths if p in ("c0.gif", "c1.gif", "c2.gif")]
    assert tzf.extract_z_trajectories(tp, ts, tcfg, ticfg, good, load, tout,
                                      device="cpu", **kw) == []
    # stop_after counts clips processed: c1 only (c0's .npy exists); a
    # batch of one, padded with its own copy
    os.remove(os.path.join(tout, "c1.npy"))
    os.remove(os.path.join(tout, "c2.npy"))
    got = tzf.extract_z_trajectories(tp, ts, tcfg, ticfg, good, load, tout,
                                     device="cpu", stop_after=1, **kw)
    assert [os.path.basename(p) for p in got] == ["c1.npy"]
    assert not os.path.exists(os.path.join(tout, "c2.npy"))


@pytest.mark.parametrize("name", [
    "image_problem", "nested_first_frame_problem", "invert_images",
    "invert_video_joint", "invert_video_iterative",
    "invert_nested_first_frame", "apply_latent_path",
    "extract_z_trajectories"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.DCGANConfig(**_IMG)
    vcfg = tconfig.VidGANConfig(image_gan=cfg, **_VID)
    icfg = tconfig.InvertConfig(steps=1)
    params, state = tdcgan.init(torch.Generator().manual_seed(0), cfg, "cpu")
    imgs = np.zeros((2, 32, 32, 1), np.float32)
    calls = {
        "image_problem": lambda: topt.image_problem(params, state, imgs,
                                                    cfg, icfg),
        "nested_first_frame_problem": lambda: topt.nested_first_frame_problem(
            {}, {}, imgs, vcfg, icfg),
        "invert_images": lambda: topt.invert_images(params, state, imgs, cfg,
                                                    icfg),
        "invert_video_joint": lambda: topt.invert_video_joint(
            params, state, imgs, cfg, icfg),
        "invert_video_iterative": lambda: topt.invert_video_iterative(
            params, state, imgs[None], cfg, icfg),
        "invert_nested_first_frame": lambda: topt.invert_nested_first_frame(
            {}, {}, imgs, vcfg, icfg),
        "apply_latent_path": lambda: topt.apply_latent_path(
            params, state, np.zeros((1, 12)), np.zeros((2, 12)), cfg),
        "extract_z_trajectories": lambda: tzf.extract_z_trajectories(
            params, state, cfg, icfg, [], lambda p: None, "/none"),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[name]()
