"""The port's checkpoint surgery (gifgan_tpu_torch/core/checkpoint.py
restore, graft, AsyncCheckpointer; train/vid.py load_image_gan) against the
JAX package's, through the shared on-disk format: the JAX layout, which
every port write goes through interop.to_jax_flat to reach and every port
read comes back from through interop.from_jax_flat."""

import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core import config as jconfig
from gifgan_tpu.train import gan as jgan
from gifgan_tpu.train import vid as jvid
from gifgan_tpu_torch.core import checkpoint as tckpt
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.data.synthetic import synthetic_stills
from gifgan_tpu_torch.train import gan as tgan
from gifgan_tpu_torch.train import loops
from gifgan_tpu_torch.train import vid as tvid

_IMG = dict(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8)
_VID = dict(z_input_size=20, z_output_size=16, vid_length=4, hidden_dim=32,
            d_filters=16)


def _jit_init(module, key, cfg, tcfg):
    init = jax.jit(module.init_train_state, static_argnums=(1, 2))
    return init(jax.random.PRNGKey(key), cfg, tcfg)


def _image_ckpt(tmp_path):
    """A JAX image-GAN checkpoint with BN moments moved off their init."""
    ts = _jit_init(jgan, 1, jconfig.DCGANConfig(**_IMG), jconfig.TrainConfig())
    flat = jckpt._flatten_with_paths(ts._asdict())
    rng = np.random.default_rng(0)
    for k in flat:
        if k.startswith("state/"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    d = str(tmp_path / "img" / "checkpoints")
    jckpt.save(d, 5, flat)
    return d, flat


def _port_img_state(seed=0):
    return tgan.init_train_state(torch.Generator().manual_seed(seed),
                                 tconfig.DCGANConfig(**_IMG),
                                 tconfig.TrainConfig(), device="cpu")


def test_load_image_gan_equals_the_jax_graft(tmp_path):
    """A JAX image checkpoint grafted into the same video state by both
    packages: every leaf equal, bit for bit, in the JAX layout; the image
    nets' params and BN state come from the checkpoint, the rest is kept."""
    d, img = _image_ckpt(tmp_path)
    cfg = jconfig.VidGANConfig(image_gan=jconfig.DCGANConfig(**_IMG), **_VID)
    ts = _jit_init(jvid, 3, cfg, jconfig.TrainConfig())
    before = jckpt._flatten_with_paths(ts._asdict())
    want = jckpt._flatten_with_paths(jvid.load_image_gan(ts, d)._asdict())
    port = tvid.VidTrainState.from_tree(interop.from_jax_flat(before, "cpu"))
    grafted = tvid.load_image_gan(port, d)
    assert isinstance(grafted, tvid.VidTrainState)
    assert isinstance(grafted.opt_g, tgan.AdamState)
    got = interop.to_jax_flat(grafted)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    np.testing.assert_array_equal(got["state/img_discriminator/bn2/var"],
                                  img["state/discriminator/bn2/var"])
    np.testing.assert_array_equal(got["params/img_generator/h1_deconv/w"],
                                  img["params/generator/h1_deconv/w"])
    np.testing.assert_array_equal(got["params/vid_generator/lin0/w"],
                                  before["params/vid_generator/lin0/w"])


def test_graft_with_no_matching_key_raises(tmp_path):
    d, _ = _image_ckpt(tmp_path)
    cfg = tconfig.VidGANConfig(image_gan=tconfig.DCGANConfig(**_IMG), **_VID)
    ts = tvid.init_train_state(torch.Generator().manual_seed(0), cfg,
                               tconfig.TrainConfig(), device="cpu")
    with pytest.raises(KeyError, match="0 of"):
        tckpt.graft(d, ts, "params/img_generator",
                    ckpt_prefix="params/gen/")
    with pytest.raises(KeyError, match="0 of"):
        tckpt.restore(d, ts, prefix="elsewhere/")


def test_restore_round_trip(tmp_path):
    """A port state written and restored into a fresh one of another seed:
    equal leaves, the NamedTuple types kept; exclude keeps the target's
    leaves under a path; a plain restore consumes every key quietly."""
    src, dst = _port_img_state(1), _port_img_state(2)
    d = str(tmp_path / "ck")
    saver = tckpt.AsyncCheckpointer()
    saver.save(d, 4, src)
    saver.close()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tckpt.restore(d, dst)
    assert isinstance(got, tgan.TrainState)
    assert isinstance(got.opt_d, tgan.AdamState)
    a, b = interop.to_jax_flat(got), interop.to_jax_flat(src)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    kept = tckpt.restore(d, dst, exclude=("params/generator",))
    assert torch.equal(kept.params["generator"]["h0_lin"]["w"],
                       dst.params["generator"]["h0_lin"]["w"])
    assert torch.equal(kept.params["discriminator"]["h0_conv"]["w"],
                       src.params["discriminator"]["h0_conv"]["w"])


def test_async_checkpointer_snapshots_before_the_write(tmp_path,
                                                       monkeypatch):
    """The write waits on the worker while the caller changes its tensors in
    place: the step on disk holds the values at the time of `save`."""
    go = threading.Event()
    real_save = tckpt.save

    def slow_save(*args, **kw):
        assert go.wait(30)
        return real_save(*args, **kw)

    monkeypatch.setattr(tckpt, "save", slow_save)
    ts = _port_img_state(0)
    want = interop.to_jax_flat(ts)
    saver = tckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "ck"), 1, ts)
    for leaf in tckpt.flatten(ts).values():
        leaf.add_(1)
    go.set()
    saver.close()
    got = tckpt.load_flat(str(tmp_path / "ck"))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_async_checkpointer_reraises_write_errors(tmp_path, monkeypatch):
    def failing_save(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save", failing_save)
    saver = tckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "ck"), 1, _port_img_state(0))
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.save(str(tmp_path / "ck"), 2, _port_img_state(0))
    with pytest.raises(OSError, match="disk full"):
        saver.close()


def test_port_train_dcgan_checkpoint_restores_in_jax(tmp_path):
    """A checkpoint written by the port's train_dcgan loads into the JAX
    package's gan.init_train_state with checkpoint.restore: every key
    consumed (no layout warning), every leaf equal to the port's final
    state."""
    tcfg = tconfig.TrainConfig(batch_size=8, epochs=1, sample_every=0,
                               checkpoint_every=0,
                               run_dir=str(tmp_path / "run"))
    ts = loops.train_dcgan(None, tconfig.DCGANConfig(**_IMG), tcfg,
                           steps_limit=2, stills_u8=synthetic_stills(16, 32),
                           device="cpu")
    target = _jit_init(jgan, 9, jconfig.DCGANConfig(**_IMG),
                       jconfig.TrainConfig(batch_size=8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored = jckpt.restore(str(tmp_path / "run" / "checkpoints"),
                                 target._asdict())
    got = jckpt._flatten_with_paths(restored)
    want = interop.to_jax_flat(ts)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(restored["step"]) == 2
