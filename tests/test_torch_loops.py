"""The port's training loops (gifgan_tpu_torch/train/loops.py) and collapse
controller (train/controller.py): counterparts of tests/test_train_loops.py
and tests/test_controller.py, on the CPU (device="cpu"), with no imageio or
cv2: the grids are the port's PNG and GIF writers."""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from gifgan_tpu.data import native_gif as jnative_gif
from gifgan_tpu.train import controller as jcontroller
from gifgan_tpu.train import loops as jloops
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.config import (DCGANConfig, TrainConfig,
                                          VidGANConfig)
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.data.synthetic import synthetic_clips, synthetic_stills
from gifgan_tpu_torch.train import loops
from gifgan_tpu_torch.train.controller import (CollapseController,
                                               ControllerConfig)

IMG = DCGANConfig(output_size=32, c_dim=3, z_dim=16, gf_dim=8, df_dim=8)
VID = VidGANConfig(z_input_size=20, z_output_size=16, vid_length=4,
                   hidden_dim=32, d_filters=16, image_gan=IMG,
                   first_frame_loss_scalar=1.0)


def _tcfg(run_dir, **kw):
    base = dict(batch_size=16, epochs=1, sample_every=0, checkpoint_every=0)
    base.update(kw)
    return TrainConfig(run_dir=str(run_dir), **base)


def stills_iter():
    data = synthetic_stills(32, size=32).astype(np.float32) / 127.5 - 1.0

    def it():
        for i in range(2):
            yield data[i * 16:(i + 1) * 16]
    return it


def _records(run_dir):
    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _png_shape(path):
    """(height, width, channels) of a PNG, read with zlib and struct, and
    its pixel rows decompress to that size."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    assert depth == 8
    c = {0: 1, 2: 3, 6: 4}[color]
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    assert len(zlib.decompress(data[41:41 + n])) == h * (1 + w * c)
    return h, w, c


def _params_equal(a, b):
    fa, fb = interop.to_jax_flat(a.params), interop.to_jax_flat(b.params)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_train_dcgan_loop_artifacts_and_resume(tmp_path):
    tcfg = _tcfg(tmp_path / "run", epochs=2, sample_every=2,
                 checkpoint_every=2)
    ts = loops.train_dcgan(stills_iter(), IMG, tcfg, steps_limit=3,
                           device="cpu")
    assert int(ts.step) == 3
    run = tmp_path / "run"
    assert (run / "params.json").exists()
    assert [r["step"] for r in _records(run)] == [1, 2, 3]
    grids = [f for f in os.listdir(run) if f.startswith("train_")
             and f.endswith(".png")]
    assert grids == ["train_00_000002.png"]
    assert _png_shape(str(run / grids[0])) == (8 * 32, 8 * 32, 3)
    assert ckpt.all_steps(str(run / "checkpoints")) == [2, 3]

    ts2 = loops.train_dcgan(stills_iter(), IMG, tcfg, steps_limit=5,
                            device="cpu")
    assert int(ts2.step) == 5
    assert [r["step"] for r in _records(run)] == [1, 2, 3, 4, 5]


def test_train_vid_loop_with_image_gan_graft(tmp_path):
    loops.train_dcgan(stills_iter(), IMG, _tcfg(tmp_path / "img_run"),
                      steps_limit=1, device="cpu")
    img_ckpt = str(tmp_path / "img_run" / "checkpoints")
    tcfg = _tcfg(tmp_path / "vid_run", batch_size=8, epochs=2,
                 sample_every=2, checkpoint_every=2)
    folded = (synthetic_clips(8, length=4, size=32).astype(np.float32)
              .reshape(-1, 32, 32, 3) / 127.5 - 1.0)
    ts = loops.train_vid_dcgan(lambda: iter([folded]), VID, tcfg,
                               image_gan_ckpt=img_ckpt, steps_limit=2,
                               device="cpu")
    assert int(ts.step) == 2
    run = tmp_path / "vid_run"
    names = sorted(os.listdir(run))
    assert "sample_01_000002.gif" in names
    assert "cross_sample_01_000002.gif" in names
    frames = jnative_gif.decode_gif(str(run / "sample_01_000002.gif"))
    assert frames.shape == (4, 32, 8 * 32, 3)      # 8 videos in one row
    flat = ckpt.load_flat(img_ckpt)
    got = interop.to_jax_flat(ts)
    for sub, pref in (("params/img_generator/", "params/generator/"),
                      ("state/img_discriminator/", "state/discriminator/")):
        keys = [k for k in got if k.startswith(sub)]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(got[k],
                                          flat[pref + k[len(sub):]], k)


def test_train_vid_loop_chunked(tmp_path):
    folded = (synthetic_clips(8, length=4, size=32).astype(np.float32)
              .reshape(2, 16, 32, 32, 3) / 127.5 - 1.0)
    ts = loops.train_vid_dcgan(lambda: iter(folded), VID,
                               _tcfg(tmp_path / "vc", batch_size=4, epochs=4),
                               chunk=2, steps_limit=4, device="cpu")
    assert int(ts.step) == 4
    assert [r["step"] for r in _records(tmp_path / "vc")] == [2, 4]


@pytest.mark.parametrize("loop", ["vid", "dcgan"])
def test_chunked_loop_flushes_the_epoch_tail(tmp_path, loop):
    """Three batches an epoch at chunk 2: a chunk of 2, then the tail of 1
    trained and logged, not dropped; a checkpoint cadence crossed by the
    tail fires."""
    tcfg = _tcfg(tmp_path / loop, batch_size=4, checkpoint_every=3)
    if loop == "vid":
        folded = (synthetic_clips(12, length=4, size=32).astype(np.float32)
                  .reshape(3, 16, 32, 32, 3) / 127.5 - 1.0)
        ts = loops.train_vid_dcgan(lambda seed: iter(folded), VID, tcfg,
                                   chunk=2, device="cpu")
    else:
        data = (synthetic_stills(12, size=32).astype(np.float32)
                .reshape(3, 4, 32, 32, 3) / 127.5 - 1.0)
        ts = loops.train_dcgan(lambda seed: iter(data), IMG, tcfg, chunk=2,
                               device="cpu")
    assert int(ts.step) == 3
    assert [r["step"] for r in _records(tmp_path / loop)] == [2, 3]
    assert ckpt.all_steps(str(tmp_path / loop / "checkpoints")) == [3]


def test_chunked_cadence_fires_after_tail_shift():
    assert loops._crossed(499, 500, 500)
    assert loops._crossed(495, 505, 500)
    assert not loops._crossed(500, 505, 500)
    assert loops._crossed(130, 150, 150)
    assert not loops._crossed(150, 170, 500)
    assert not loops._crossed(0, 10, 0)


def test_cross_sample_z_equals_the_jax_function():
    a = loops.cross_sample_z(2, 8, 20, 16, np.random.default_rng(3))
    b = jloops.cross_sample_z(2, 8, 20, 16, np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[0, :16], a[7, :16])   # a row, one face
    np.testing.assert_array_equal(a[0, 16:], a[8, 16:])   # a column


def test_resume_does_not_replay_rng_stream(tmp_path):
    """A resumed run's stream is the seed's with the step folded in: not
    the seed's own stream (a replay of what the first segment drew), the
    same for the same step; its step 2 differs from an uninterrupted
    run's step 2."""
    kw = dict(epochs=4, seed=7)
    loops.train_dcgan(stills_iter(), IMG,
                      _tcfg(tmp_path / "rr", checkpoint_every=1, **kw),
                      steps_limit=1, device="cpu")
    loops.train_dcgan(stills_iter(), IMG,
                      _tcfg(tmp_path / "rr", checkpoint_every=1, **kw),
                      steps_limit=2, device="cpu")
    loops.train_dcgan(stills_iter(), IMG, _tcfg(tmp_path / "rr2", **kw),
                      steps_limit=2, device="cpu")
    resumed = [r for r in _records(tmp_path / "rr") if r["step"] == 2][0]
    fresh = [r for r in _records(tmp_path / "rr2") if r["step"] == 2][0]
    assert resumed["g_loss"] != fresh["g_loss"]
    a = loops._resume_rngs(7, 1, "cpu").next_seed()
    assert a != loops._resume_rngs(7, 0, "cpu").next_seed()
    assert a == loops._resume_rngs(7, 1, "cpu").next_seed()


@pytest.mark.parametrize("chunk", [1, 2])
def test_train_dcgan_stills_u8_matches_host_iterator(tmp_path, chunk):
    """The device-corpus path visits the ids, order and chunk grouping of a
    host iterator replaying the same per-epoch permutation over bit-equal
    pixels: final params equal bit for bit."""
    data_u8 = synthetic_stills(32, size=32)
    corpus = DeviceCorpus(data_u8, device="cpu")

    def host_iter(epoch_seed):
        perm = np.random.default_rng(epoch_seed).permutation(len(data_u8))
        for i in range(len(data_u8) // 16):
            yield corpus.sample(perm[i * 16:(i + 1) * 16])

    ts_dev = loops.train_dcgan(None, IMG, _tcfg(tmp_path / "dev"),
                               chunk=chunk, stills_u8=data_u8, device="cpu")
    ts_host = loops.train_dcgan(host_iter, IMG, _tcfg(tmp_path / "host"),
                                chunk=chunk, device="cpu")
    assert int(ts_dev.step) == 2
    _params_equal(ts_dev, ts_host)


@pytest.mark.parametrize("chunk", [1, 2])
def test_train_vid_dcgan_clips_u8_matches_host_iterator(tmp_path, chunk):
    cfg = VidGANConfig(z_input_size=20, z_output_size=16, vid_length=4,
                       hidden_dim=32, d_filters=16, image_gan=IMG)
    data_u8 = synthetic_clips(16, length=4, size=32)
    corpus = DeviceCorpus(data_u8, device="cpu")

    def host_iter(epoch_seed):
        perm = np.random.default_rng(epoch_seed).permutation(len(data_u8))
        for i in range(len(data_u8) // 8):
            g = corpus.sample(perm[i * 8:(i + 1) * 8])
            yield g.reshape(-1, *g.shape[2:])

    ts_dev = loops.train_vid_dcgan(None, cfg, _tcfg(tmp_path / "dev",
                                                    batch_size=8),
                                   chunk=chunk, clips_u8=data_u8,
                                   device="cpu")
    ts_host = loops.train_vid_dcgan(host_iter, cfg,
                                    _tcfg(tmp_path / "host", batch_size=8),
                                    chunk=chunk, device="cpu")
    assert int(ts_dev.step) == 2
    _params_equal(ts_dev, ts_host)


def test_device_corpus_rejects_bad_shapes_and_small_corpora(tmp_path):
    tcfg = _tcfg(tmp_path / "r", batch_size=8)
    with pytest.raises(ValueError, match="vid_length"):
        loops.train_vid_dcgan(None, VID, tcfg, device="cpu",
                              clips_u8=synthetic_clips(8, length=6, size=32))
    with pytest.raises(ValueError, match="batch_size"):
        loops.train_vid_dcgan(None, VID, tcfg, device="cpu",
                              clips_u8=synthetic_clips(4, length=4, size=32))
    with pytest.raises(ValueError, match="batch_size"):
        loops.train_dcgan(None, IMG, _tcfg(tmp_path / "s"), device="cpu",
                          stills_u8=synthetic_stills(8, size=32))
    with pytest.raises(ValueError, match="stills_u8"):
        loops.train_dcgan(None, IMG, _tcfg(tmp_path / "s"), device="cpu",
                          stills_u8=synthetic_stills(16, size=16))


def test_video_grid_pads_the_remainder(tmp_path):
    videos = torch.rand(12, 3, 16, 16, 3) * 2 - 1
    path = str(tmp_path / "grid.gif")
    loops._write_video_grid(videos, 8, path)
    frames = jnative_gif.decode_gif(path)
    assert frames.shape == (3, 2 * 16, 8 * 16, 3)   # ceil(12 / 8) rows
    assert frames[:, 16:, 4 * 16:].max() == 0       # the 4 padded tiles


# --- the collapse controller against the JAX package's ---------------------

CC = dict(patience=3, recover_patience=4, cooldown=2, noise_step=0.2,
          noise_max=0.5, d_lr_factor=0.5, d_lr_min=0.25)


def _trace(seed):
    """A d_loss sequence that saturates, recovers and sits mid-band."""
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(0.0, 0.05, 30), rng.uniform(0.4, 1.0, 60),
             rng.uniform(0.05, 0.4, 10), rng.uniform(0.0, 0.1, 20),
             rng.uniform(0.3, 0.9, 40)]
    return np.concatenate(parts).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_decisions_equal_the_jax_controller(seed):
    """Every chunk's event and knob values, over a fixed d_loss sequence,
    equal the JAX package's controller's."""
    base = (0.1, 0.1)
    port = CollapseController(*base, ControllerConfig(**CC))
    ref = jcontroller.CollapseController(*base,
                                         jcontroller.ControllerConfig(**CC))
    actions = []
    for d in _trace(seed):
        a, b = port.observe(d), ref.observe(d)
        assert a == b
        assert port.knob_values() == ref.knob_values()
        if a:
            actions.append(a["action"])
    assert {"raise_noise", "lower_d_lr", "restore_d_lr"} <= set(actions)


def test_controller_defaults_equal_the_jax_controller():
    import dataclasses

    assert (dataclasses.asdict(ControllerConfig())
            == dataclasses.asdict(jcontroller.ControllerConfig()))


def test_restore_controller_skips_stale_tail_events(tmp_path):
    path = tmp_path / "train_metrics.jsonl"
    events = [
        {"kind": "auto_intervention", "step": 100, "image_noise_std": 0.2,
         "activation_noise_std": 0.2, "d_lr_scale": 1.0},
        {"kind": "auto_intervention", "step": 300, "image_noise_std": 0.4,
         "activation_noise_std": 0.4, "d_lr_scale": 0.5},
    ]
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
        f.write('{"kind": "auto_interv')        # a torn last line
    for max_step, want in ((200, (0.2, 1.0)), (300, (0.4, 0.5)),
                           (None, (0.4, 0.5))):
        c = CollapseController(0.1, 0.1, ControllerConfig(**CC))
        loops._restore_controller(c, str(path), max_step=max_step)
        assert (c.image_noise, c.d_lr_scale) == want
