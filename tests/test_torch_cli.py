"""The port's training and serving commands (gifgan_tpu_torch/cli.py
train-dcgan, train-vid, sample-wall), driven in-process with --device cpu
on tiny flags: the reference's workflow (README "Cookbook"), image GAN ->
video GAN on top of it -> GIF wall, writes what it should."""

import json
import os

import numpy as np

from gifgan_tpu_torch import cli
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.data import native_gif
from gifgan_tpu_torch.data.synthetic import synthetic_clips

IMG_FLAGS = ["--output-size", "32", "--z-dim", "16", "--gf-dim", "8",
             "--df-dim", "8", "--packed-c3", "--device", "cpu"]
VID_FLAGS = IMG_FLAGS + ["--vid-z-dim", "20", "--vid-length", "4",
                         "--batch-size", "8"]


def _records(run_dir):
    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_dcgan_then_train_vid_then_sample_wall(tmp_path):
    img, vid, wall = (str(tmp_path / n) for n in ("img", "vid", "wall"))
    assert cli.main(["train-dcgan", "--run-dir", img, "--dataset-size", "40",
                     "--batch-size", "8", "--device-corpus", "--chunk", "2",
                     "--steps-limit", "6", "--sample-every", "4",
                     "--checkpoint-every", "4"] + IMG_FLAGS) == 0
    # 5 batches an epoch: chunks end at 2, 4, the tail at 5, then 7 >= 6
    assert [r["step"] for r in _records(img)] == [2, 4, 5, 7]
    assert ckpt.all_steps(os.path.join(img, "checkpoints")) == [4, 7]
    assert os.path.exists(os.path.join(img, "train_00_000004.png"))
    assert os.path.exists(os.path.join(img, "params.json"))

    assert cli.main(["train-vid", "--run-dir", vid, "--dataset-size", "16",
                     "--device-corpus", "--chunk", "2", "--steps-limit", "4",
                     "--sample-every", "2", "--checkpoint-every", "2",
                     "--first-frame-loss-scalar", "1.0",
                     "--image-gan-checkpoint",
                     os.path.join(img, "checkpoints")] + VID_FLAGS) == 0
    recs = _records(vid)
    assert [r["step"] for r in recs] == [2, 4]
    assert all(np.isfinite(r["d_loss"]) and np.isfinite(r["g_loss"])
               for r in recs)
    names = os.listdir(vid)
    for n in ("sample_00_000002.gif", "cross_sample_01_000004.gif"):
        assert n in names
    want = ckpt.load_flat(os.path.join(img, "checkpoints"))
    got = ckpt.load_flat(os.path.join(vid, "checkpoints"))
    for k, v in want.items():
        if k.startswith(("params/", "state/")):
            net, rest = k.split("/", 2)[1:]
            np.testing.assert_array_equal(
                got[f"{k.split('/')[0]}/img_{net}/{rest}"], v, err_msg=k)

    assert cli.main(["sample-wall", "--checkpoint",
                     os.path.join(vid, "checkpoints"), "--out-dir", wall,
                     "--num-batches", "2", "--batch-size", "3",
                     "--device", "cpu"]) == 0
    gifs = sorted(os.listdir(wall))
    assert gifs == sorted(f"{i}.gif" for i in range(6))
    assert native_gif.decode_gif(os.path.join(wall, "5.gif")).shape == (
        4, 32, 32, 3)


def test_train_dcgan_host_iterator_and_train_vid_stream(tmp_path):
    """The paths without a device corpus: train-dcgan over shuffled host
    batches, train-vid --stream over a directory of GIFs (decode workers,
    then the resize of kernels/resize.py, its plain version here)."""
    img = str(tmp_path / "img")
    cli.main(["train-dcgan", "--run-dir", img, "--dataset-size", "16",
              "--batch-size", "8", "--steps-limit", "2", "--sample-every",
              "0", "--checkpoint-every", "0"] + IMG_FLAGS)
    assert ckpt.latest_step(os.path.join(img, "checkpoints")) == 2
    clips = tmp_path / "clips"
    clips.mkdir()
    for i, clip in enumerate(synthetic_clips(8, length=4, size=48)):
        native_gif.encode_gif(str(clips / f"{i}.gif"), clip)
    vid = str(tmp_path / "vid")
    cli.main(["train-vid", "--run-dir", vid, "--dataset", str(clips),
              "--stream", "--data-workers", "2", "--steps-limit", "2",
              "--sample-every", "0", "--checkpoint-every", "0",
              "--image-gan-checkpoint", os.path.join(img, "checkpoints")]
             + VID_FLAGS)
    assert [r["step"] for r in _records(vid)] == [1, 2]


def test_train_vid_auto_intervene_and_resume(tmp_path):
    """--auto-intervene: every chunk record carries the live knob values,
    and a resume restores the last intervention's levels from the metrics
    log."""
    run = str(tmp_path / "ai")
    argv = ["train-vid", "--run-dir", run, "--epochs", "1",
            "--sample-every", "0", "--checkpoint-every", "2",
            "--device-corpus", "--chunk", "2", "--image-noise", "0.1",
            "--activation-noise", "0.1", "--dataset-size", "16",
            "--auto-intervene"] + VID_FLAGS
    cli.main(argv + ["--steps-limit", "2"])
    chunks = [r for r in _records(run) if "kind" not in r]
    assert chunks and all(r["image_noise_std"] == 0.1
                          and r["d_lr_scale"] == 1.0 for r in chunks)
    with open(os.path.join(run, "train_metrics.jsonl"), "a") as f:
        f.write(json.dumps({
            "kind": "auto_intervention", "action": "raise_noise", "step": 2,
            "d_loss": 0.01, "image_noise_std": 0.3,
            "activation_noise_std": 0.3, "d_lr_scale": 0.5}) + "\n")
    cli.main(argv + ["--steps-limit", "4", "--epochs", "2"])
    assert ckpt.latest_step(os.path.join(run, "checkpoints")) == 4
    resumed = [r for r in _records(run) if "kind" not in r and r["step"] > 2]
    assert resumed and all(r["image_noise_std"] == 0.3
                           and r["d_lr_scale"] == 0.5 for r in resumed)


def test_stills_from_a_directory_equal_the_jax_cli(tmp_path):
    """`_stills_u8` on a directory of images of several sizes and channel
    counts (read with imageio, resized by ops/image.py resize_bilinear)
    against the JAX CLI's (jax.image.resize): within one grey level, the
    rounding of float32 values that differ in their last bits."""
    import argparse

    from gifgan_tpu import cli as jcli
    from gifgan_tpu.core.config import DCGANConfig as JDCGANConfig
    from gifgan_tpu_torch.core.config import DCGANConfig
    from gifgan_tpu_torch.ops.image import write_png

    rng = np.random.default_rng(0)
    for i, (h, w, c) in enumerate([(32, 32, 3), (48, 40, 3), (20, 28, 1),
                                   (64, 64, 4)]):
        write_png(str(tmp_path / f"{i}.png"),
                  rng.integers(0, 256, (h, w, c), dtype=np.uint8))
    args = argparse.Namespace(dataset=str(tmp_path), dataset_size=0)
    got = cli._stills_u8(args, DCGANConfig(output_size=32))
    want = jcli._stills_u8(args, JDCGANConfig(output_size=32))
    assert got.shape == want.shape == (4, 32, 32, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(got[0], want[0])     # no resize: exact
