"""Weights, configs and run directories across the two packages
(gifgan_tpu_torch/core/{interop,checkpoint,config}.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core import config as jconfig
from gifgan_tpu.train import vid as jvid
from gifgan_tpu_torch.core import checkpoint as tckpt
from gifgan_tpu_torch.core import config as tconfig
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.train import vid as tvid

_IMG = dict(output_size=32, c_dim=3, z_dim=8, gf_dim=8, df_dim=8)
_VID = dict(z_input_size=12, z_output_size=8, vid_length=2, hidden_dim=16,
            d_filters=8)


def _jcfg(packed=False):
    return jconfig.VidGANConfig(
        image_gan=jconfig.DCGANConfig(packed_c3=packed, **_IMG), **_VID)


@pytest.mark.parametrize("train_img", [False, True])
def test_jax_train_state_round_trip_bit_exact(train_img):
    """JAX vid.init_train_state (params, BN state, Adam slots, step) ->
    port -> JAX: same keys, dtypes and bits."""
    tcfg = jconfig.TrainConfig(train_img_gen=train_img,
                               train_img_disc=train_img)
    ts = jvid.init_train_state(jax.random.PRNGKey(0), _jcfg(), tcfg)
    flat = jckpt._flatten_with_paths(ts._asdict())
    port = tvid.VidTrainState.from_tree(interop.from_jax_flat(flat, "cpu"))
    assert port.opt_g.count.shape == () and port.step.dtype == torch.int32
    assert ("img" in port.opt_g.mu) == train_img
    back = interop.to_jax_flat(port)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_jax_dcgan_train_state_round_trip_bit_exact():
    """JAX gan.init_train_state (params/generator/..., opt_g/0/...) -> port
    gan.TrainState -> JAX: same keys, dtypes and bits."""
    from gifgan_tpu.train import gan as jgan
    from gifgan_tpu_torch.train import gan as tgan

    ts = jax.jit(jgan.init_train_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jconfig.DCGANConfig(**_IMG),
        jconfig.TrainConfig())
    flat = jckpt._flatten_with_paths(ts._asdict())
    port = tgan.TrainState.from_tree(interop.from_jax_flat(flat, "cpu"))
    assert port.params["generator"]["h1_deconv"]["w"].shape == (64, 32, 5, 5)
    back = interop.to_jax_flat(port)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_layouts_of_converted_weights():
    ts = jvid.init_train_state(jax.random.PRNGKey(0), _jcfg(),
                               jconfig.TrainConfig())
    flat = jckpt._flatten_with_paths(ts._asdict())
    port = interop.from_jax_flat(flat, "cpu")["params"]
    w = flat["params/img_discriminator/h1_conv/w"]       # HWIO
    np.testing.assert_array_equal(
        port["img_discriminator"]["h1_conv"]["w"].numpy(),
        w.transpose(3, 2, 0, 1))
    w = flat["params/img_generator/h2_deconv/w"]         # [h, w, out, in]
    assert port["img_generator"]["h2_deconv"]["w"].shape == (
        w.shape[3], w.shape[2], 5, 5)
    w = flat["params/vid_discriminator/h2_conv/w"]       # DHWIO
    np.testing.assert_array_equal(
        port["vid_discriminator"]["h2_conv"]["w"].numpy(),
        w.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(                      # linear kept (in, out)
        port["vid_generator"]["lin0"]["w"].numpy(),
        flat["params/vid_generator/lin0/w"])


def _configs():
    img = dict(_IMG, packed_c3=True, compute_dtype="bfloat16")
    return [
        ("dcgan", lambda m: m.DCGANConfig(**img)),
        ("vid", lambda m: m.VidGANConfig(image_gan=m.DCGANConfig(**img),
                                         image_noise_std=0.5, **_VID)),
        ("recurrent", lambda m: m.RecurrentImageConfig(seq_length=4)),
        ("train", lambda m: m.TrainConfig(d_learning_rate=1e-4,
                                          run_dir="runs/x")),
        ("invert", lambda m: m.InvertConfig(steps=3)),
        ("track", lambda m: m.TrackConfig(detector_backend="native")),
        ("run", lambda m: {"model": m.VidGANConfig(), "train":
                           m.TrainConfig()}),
    ]


@pytest.mark.parametrize("name,make", _configs(), ids=[c[0] for c in
                                                        _configs()])
def test_save_config_same_json(tmp_path, name, make):
    """Same JSON text from both packages; each loads the other's file."""
    jp, tp = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jconfig.save_config(make(jconfig), jp)
    tconfig.save_config(make(tconfig), tp)
    with open(jp) as a, open(tp) as b:
        assert a.read() == b.read()
    back = tconfig.load_config(jp)
    want = make(tconfig)
    if isinstance(want, dict):
        assert back == want
    else:
        assert type(back) is type(want)
        assert dataclasses.asdict(back) == dataclasses.asdict(want)


def test_same_fields_as_jax_configs():
    for name in ("DCGANConfig", "VidGANConfig", "RecurrentImageConfig",
                 "TrainConfig", "InvertConfig", "TrackConfig"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jconfig, name))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tconfig, name))]
        assert jf == tf, name


def _randomized_jax_state(cfg, tcfg, seed=0):
    """A JAX train state with std-0.2 weights: random init gives ~1e-5
    samples, too small to tell a layout fault from noise."""
    ts = jvid.init_train_state(jax.random.PRNGKey(1), cfg, tcfg)
    rng = np.random.default_rng(seed)

    def f(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['w']") and "params" not in name:
            return x
        if name.endswith("['w']"):
            return jnp.asarray(0.2 * rng.standard_normal(x.shape), x.dtype)
        return x

    return ts._replace(params=jax.tree_util.tree_map_with_path(
        f, ts.params))


@pytest.mark.parametrize("packed", [False, True])
def test_jax_run_dir_serves_from_port(tmp_path, packed):
    """A run dir written by gifgan_tpu (checkpoint.save + save_config, as
    its training loop does) loads through load_vid_train_state, and the
    port's sample_videos matches JAX's (rtol 1e-4 plus 1e-4 x max|value|:
    eight layers of float32 accumulation-order differences)."""
    cfg, tcfg = _jcfg(packed), jconfig.TrainConfig(batch_size=4)
    ts = _randomized_jax_state(cfg, tcfg)
    run = tmp_path / "run"
    jconfig.save_config({"model": cfg, "train": tcfg},
                        str(run / "params.json"))
    jckpt.save(str(run / "checkpoints"), 7, ts._asdict())
    jckpt.save(str(run / "checkpoints"), 3, ts._asdict())

    tcfg_model, port = tvid.load_vid_train_state(str(run / "checkpoints"),
                                                 device="cpu")
    assert dataclasses.asdict(tcfg_model) == dataclasses.asdict(cfg)
    z = np.random.default_rng(2).uniform(-1, 1, (3, 12)).astype(np.float32)
    want = np.asarray(jvid.sample_videos(ts, jnp.asarray(z), cfg))
    got = tvid.sample_videos(port, torch.from_numpy(z), tcfg_model).numpy()
    assert got.shape == (3, 2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_load_vid_train_state_refuses_partial_checkpoints(tmp_path):
    cfg, tcfg = _jcfg(), jconfig.TrainConfig()
    ts = jvid.init_train_state(jax.random.PRNGKey(1), cfg, tcfg)
    flat = jckpt._flatten_with_paths(ts._asdict())
    del flat["params/img_generator/h4_deconv/w"]
    jconfig.save_config({"model": cfg, "train": tcfg},
                        str(tmp_path / "params.json"))
    jckpt.save(str(tmp_path / "ck"), 1, flat)
    with pytest.raises(KeyError):
        tvid.load_vid_train_state(str(tmp_path / "ck"), device="cpu")
    with pytest.raises(FileNotFoundError):
        tvid.load_vid_train_state(str(tmp_path / "nowhere" / "ck"),
                                  device="cpu")


def test_port_checkpoint_readable_by_jax(tmp_path):
    """The port's save of to_jax_flat(state) restores into a JAX state;
    steps list and keep-N work as in the JAX package."""
    cfg, tcfg = _jcfg(), jconfig.TrainConfig()
    port = tvid.init_train_state(torch.Generator().manual_seed(0),
                                 tconfig.VidGANConfig(
                                     image_gan=tconfig.DCGANConfig(**_IMG),
                                     **_VID),
                                 tconfig.TrainConfig(), device="cpu")
    d = str(tmp_path / "ck")
    for step in (1, 2, 3):
        tckpt.save(d, step, interop.to_jax_flat(port), max_to_keep=2)
    assert tckpt.all_steps(d) == jckpt.all_steps(d) == [2, 3]
    assert tckpt.latest_step(d) == 3
    target = jvid.init_train_state(jax.random.PRNGKey(5), cfg, tcfg)
    restored = jckpt.restore(d, target._asdict())
    want = interop.to_jax_flat(port)
    got = jckpt._flatten_with_paths(restored)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    flat = tckpt.load_flat(d)
    assert sorted(flat) == sorted(want)
    assert os.path.exists(os.path.join(d, "step_0000000003", "tree.json"))
