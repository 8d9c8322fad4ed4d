"""The port's recurrent_image training loop and command
(gifgan_tpu_torch/train/loops.py train_recurrent, cli.py train-recurrent)
on the CPU at a tiny width: files, refusal to overwrite, resume, the
device-corpus form, and run directories crossing between the packages
(the JAX loop resumes a port run; the port resumes a JAX checkpoint)."""

import json
import os

import numpy as np
import pytest
import torch

from gifgan_tpu.core import checkpoint as jckpt
from gifgan_tpu.core import config as jconfig
from gifgan_tpu.train import loops as jloops
from gifgan_tpu_torch import cli
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.config import (RecurrentImageConfig, TrainConfig,
                                          load_config)
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.data.native_gif import decode_gif
from gifgan_tpu_torch.data.synthetic import synthetic_clips
from gifgan_tpu_torch.train import loops
from gifgan_tpu_torch.train import recurrent as trt

_CFG = dict(image_size=32, c_dim=3, seq_length=4, base_filters=8,
            lstm_units=16)
CFG = RecurrentImageConfig(**_CFG)
SMALL = ["--output-size", "32", "--gf-dim", "8", "--vid-length", "4",
         "--lstm-units", "16", "--batch-size", "4", "--dataset-size", "8",
         "--sample-every", "0", "--checkpoint-every", "0", "--device", "cpu"]


def _tcfg(run_dir, **kw):
    base = dict(batch_size=4, epochs=1, sample_every=0, checkpoint_every=0)
    base.update(kw)
    return TrainConfig(run_dir=str(run_dir), **base)


def _clips_u8(n=8):
    return synthetic_clips(n, length=5, size=32)


def _host_iter(epoch_seed):
    data = _clips_u8().astype(np.float32) / 255.0
    perm = np.random.default_rng(epoch_seed).permutation(len(data))
    for i in range(len(data) // 4):
        yield data[perm[i * 4:(i + 1) * 4]]


def _records(run_dir):
    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _params_equal(a, b):
    fa, fb = (interop.to_jax_flat({"g": s.params_g, "d": s.params_d})
              for s in (a, b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_loop_files_refusal_and_resume(tmp_path):
    run = tmp_path / "run"
    tcfg = _tcfg(run, epochs=3, sample_every=2, checkpoint_every=2)
    ts = loops.train_recurrent(_host_iter, CFG, tcfg, steps_limit=3,
                               device="cpu")
    assert int(ts.step) == 3
    assert [r["step"] for r in _records(run)] == [1, 2, 3]
    for r in _records(run):
        assert all(np.isfinite(r[k]) for k in ("d_loss", "g_loss",
                                               "pixel_mae"))
    assert ckpt.all_steps(str(run / "checkpoints")) == [2, 3]
    assert load_config(str(run / "params.json"))["model"] == CFG
    # the step's 4 teacher-forced predictions, 4 frames, one row of 4
    grid = decode_gif(str(run / "pred_000002.gif"))
    assert grid.shape == (4, 32, 4 * 32, 3)

    with pytest.raises(RuntimeError, match="resume=True"):
        loops.train_recurrent(_host_iter, CFG, tcfg, resume=False,
                              device="cpu")
    ts2 = loops.train_recurrent(_host_iter, CFG, tcfg, steps_limit=5,
                                device="cpu")
    assert int(ts2.step) == 5
    assert [r["step"] for r in _records(run)] == [1, 2, 3, 4, 5]
    restored = ckpt.restore(str(run / "checkpoints"), trt.init_train_state(
        torch.Generator(), CFG, tcfg, device="cpu"))
    assert int(restored.step) == 5
    _params_equal(restored, ts2)

    ts3 = loops.train_recurrent(_host_iter, CFG, tcfg, resume=False,
                                allow_overwrite=True, steps_limit=1,
                                device="cpu")
    assert int(ts3.step) == 1


def test_device_corpus_matches_host_iterator(tmp_path):
    """clips_u8 on the device (DeviceCorpus take, [0, 1]) visits the ids
    of a host iterator replaying each epoch's permutation over the same
    pixels: final params equal bit for bit, across an epoch boundary."""
    ts_dev = loops.train_recurrent(None, CFG, _tcfg(tmp_path / "dev",
                                                    epochs=2),
                                   clips_u8=_clips_u8(), device="cpu")
    ts_host = loops.train_recurrent(_host_iter, CFG,
                                    _tcfg(tmp_path / "host", epochs=2),
                                    device="cpu")
    assert int(ts_dev.step) == 4
    _params_equal(ts_dev, ts_host)
    corpus = DeviceCorpus(_clips_u8(), method="take", out_range="unit",
                          device="cpu")
    np.testing.assert_array_equal(corpus.sample([1, 3]).numpy(),
                                  _clips_u8()[[1, 3]] / np.float32(255.0))


def test_device_corpus_rejects_bad_shapes_and_small_corpora(tmp_path):
    tcfg = _tcfg(tmp_path / "r")
    with pytest.raises(ValueError, match="seq_length"):
        loops.train_recurrent(None, CFG, tcfg, device="cpu",
                              clips_u8=synthetic_clips(8, length=4, size=32))
    with pytest.raises(ValueError, match="batch_size"):
        loops.train_recurrent(None, CFG, tcfg, device="cpu",
                              clips_u8=_clips_u8(2))


def test_cli_train_recurrent_both_data_paths(tmp_path):
    """Through cli.main as tests/test_cli.py drives the JAX command: the
    host path and --device-corpus give the same weights within an epoch
    (the same permutation of the same pixels); the JAX command's quirks
    are kept: --compute-dtype is ignored, and the host path reshuffles
    with the same seed every epoch."""
    runs = {}
    for name, extra in (("host", []), ("dc", ["--device-corpus"])):
        run = str(tmp_path / name)
        assert cli.main(["train-recurrent", "--run-dir", run,
                         "--compute-dtype", "bfloat16", "--steps-limit",
                         "2", "--pixel-loss-scalar", "1.0"]
                        + SMALL + extra) == 0
        assert ckpt.latest_step(os.path.join(run, "checkpoints")) == 2
        model = load_config(os.path.join(run, "params.json"))["model"]
        assert model.compute_dtype == "float32"
        assert model.base_filters == 8 and model.pixel_loss_scalar == 1.0
        runs[name] = ckpt.restore(
            os.path.join(run, "checkpoints"),
            trt.init_train_state(torch.Generator(), model, TrainConfig(),
                                 device="cpu"))
    _params_equal(runs["host"], runs["dc"])

    seen = []
    real = loops.train_recurrent

    def spy(clips_iter, *a, **kw):
        seen.extend(float(np.asarray(b).sum()) for seed in (0, 99)
                    for b in loops._epoch_iter(clips_iter, seed))
        return real(clips_iter, *a, **kw)

    loops.train_recurrent = spy
    try:
        cli.main(["train-recurrent", "--run-dir", str(tmp_path / "q"),
                  "--steps-limit", "1"] + SMALL)
    finally:
        loops.train_recurrent = real
    assert len(seen) == 4 and seen[:2] == seen[2:]   # seed 99 = seed 0


def test_runs_cross_between_the_packages(tmp_path, capsys):
    """A port run directory resumes in the JAX loop (its checkpoint read
    at the JAX keys, one more step), and a JAX checkpoint resumes in the
    port's loop."""
    run = tmp_path / "port"
    loops.train_recurrent(_host_iter, CFG, _tcfg(run), steps_limit=2,
                          device="cpu")
    jcfg = jconfig.RecurrentImageConfig(**_CFG)
    jt = jconfig.TrainConfig(run_dir=str(run), batch_size=4, epochs=1,
                             sample_every=0, checkpoint_every=0)
    jts = jloops.train_recurrent(_host_iter, jcfg, jt, steps_limit=3)
    assert int(jts.step) == 3
    assert "resumed from step 2" in capsys.readouterr().out
    assert jckpt.latest_step(str(run / "checkpoints")) == 3

    jdir = tmp_path / "jax"
    flat = jckpt._flatten_with_paths(jts._asdict())
    jckpt.save(str(jdir / "checkpoints"), 3, jts._asdict())
    ts = loops.train_recurrent(_host_iter, CFG, _tcfg(jdir), steps_limit=4,
                               device="cpu")
    assert "resumed from step 3" in capsys.readouterr().out
    assert int(ts.step) == 4
    restored = ckpt.restore(str(jdir / "checkpoints"), ts, step=3)
    for k, v in interop.to_jax_flat(restored).items():
        np.testing.assert_array_equal(v, np.asarray(flat[k]), err_msg=k)
