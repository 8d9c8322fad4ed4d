"""The port's training, serving and latent commands (gifgan_tpu_torch/cli.py
train-dcgan, train-vid, sample-wall, quantize-export, invert, z-extract,
make-paths, derive-paths, visualize), driven in-process with --device cpu
on tiny flags: the reference's workflow (README "Cookbook"), image GAN ->
video GAN on top of it -> GIF wall, its int8 deployment (quantize-export ->
sample-wall --quantized), and its latent tooling (train-dcgan -> invert /
z-extract -> derive-paths -> invert --input-paths), write what they
should."""

import json
import os

import numpy as np
import pytest
import torch

from gifgan_tpu_torch import cli
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.data import native_gif
from gifgan_tpu_torch.data.synthetic import synthetic_clips

IMG_FLAGS = ["--output-size", "32", "--z-dim", "16", "--gf-dim", "8",
             "--df-dim", "8", "--packed-c3", "--device", "cpu"]
VID_FLAGS = IMG_FLAGS + ["--vid-z-dim", "20", "--vid-length", "4",
                         "--batch-size", "8"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    in each keeps the many small ops of calibration and finishing from
    oversubscribing the cores (with 8 threads a worker, a finishing run
    took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def vid_run(tmp_path_factory):
    """A tiny train-vid run's checkpoints dir (2 steps)."""
    run = str(tmp_path_factory.mktemp("q") / "vid")
    assert cli.main(["train-vid", "--run-dir", run, "--dataset-size", "16",
                     "--device-corpus", "--steps-limit", "2",
                     "--sample-every", "0", "--checkpoint-every", "2"]
                    + VID_FLAGS) == 0
    return os.path.join(run, "checkpoints")


def test_quantize_export_then_sample_wall_quantized(vid_run, tmp_path):
    """train-vid -> quantize-export with every recovery rung (mse
    calibration, bias correction, 2 finishing steps, float last layer) ->
    sample-wall --quantized: the artifact is the int8 tree with its static
    scales and a float32 h4, smaller than the float generator weights, and
    the wall writes its GIFs."""
    from gifgan_tpu_torch.ops import quant

    art, wall = str(tmp_path / "art"), str(tmp_path / "wall")
    assert cli.main(["quantize-export", "--checkpoint", vid_run,
                     "--out-dir", art, "--calib-batches", "2",
                     "--calib-mode", "mse", "--bias-correct",
                     "--finish-steps", "2", "--float-last",
                     "--device", "cpu"]) == 0
    q, cfg = quant.load_artifact(art, device="cpu")
    assert cfg.vid_length == 4 and cfg.image_gan.output_size == 32
    assert not quant._is_q(q["img"]["h4_deconv"])
    for g, n in quant._VID_LAYER_ORDER[:-1]:
        assert q[g][n]["wq"].dtype == torch.int8 and "as" in q[g][n], (g, n)
    flat = ckpt.load_flat(vid_run)
    float_bytes = sum(v.nbytes for k, v in flat.items()
                      if k.startswith("params/") and "generator" in k)
    art_bytes = sum(v.nbytes for v in ckpt.load_flat(art).values())
    assert art_bytes < 0.5 * float_bytes, (art_bytes, float_bytes)

    assert cli.main(["sample-wall", "--checkpoint", art, "--quantized",
                     "--out-dir", wall, "--num-batches", "2",
                     "--batch-size", "3", "--device", "cpu"]) == 0
    assert sorted(os.listdir(wall)) == sorted(f"{i}.gif" for i in range(6))
    assert native_gif.decode_gif(os.path.join(wall, "5.gif")).shape == (
        4, 32, 32, 3)


def test_sample_wall_int8_from_a_float_run(vid_run, tmp_path):
    """sample-wall --int8 --int8-calib 1 quantizes the run's generator
    stack on load and serves it."""
    wall = str(tmp_path / "wall")
    assert cli.main(["sample-wall", "--checkpoint", vid_run, "--int8",
                     "--int8-calib", "1", "--out-dir", wall,
                     "--num-batches", "1", "--batch-size", "3",
                     "--device", "cpu"]) == 0
    assert sorted(os.listdir(wall)) == ["0.gif", "1.gif", "2.gif"]


@pytest.mark.parametrize("flag", [["--int8"], ["--int8-calib", "1"],
                                  ["--int8-float-last"]])
def test_quantized_refuses_the_int8_flags_as_jax_does(flag):
    from gifgan_tpu import cli as jcli

    argv = ["sample-wall", "--checkpoint", "/none", "--out-dir", "/none",
            "--quantized"] + flag
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    assert "--quantized loads a pre-quantized artifact" in str(got.value)
    assert str(got.value) == str(want.value)


def test_jax_artifact_serves_through_the_port(tmp_path):
    """An artifact from the JAX package's quantize_sampler + save_artifact
    (std-0.2 weights, static scales, float last layer) serves through the
    port's sample-wall --quantized: its GIFs are written, and its sampler
    equals the JAX package's on the same z within 1e-4 (one int8 tree; the
    float32 h4 sums in another order)."""
    import jax.numpy as jnp

    from gifgan_tpu.core.config import (DCGANConfig as JDCGANConfig,
                                        VidGANConfig as JVidGANConfig)
    from gifgan_tpu.models import vid_dcgan as jvid_dcgan
    from gifgan_tpu.ops import quant as jquant
    from gifgan_tpu.train import vid as jvid
    from gifgan_tpu_torch.core import interop
    from gifgan_tpu_torch.core.config import (DCGANConfig, TrainConfig,
                                              VidGANConfig)
    from gifgan_tpu_torch.core.tree import unflatten
    from gifgan_tpu_torch.train import vid as tvid

    img = dict(output_size=32, c_dim=3, z_dim=8, gf_dim=8, df_dim=8)
    kw = dict(z_input_size=12, z_output_size=8, vid_length=2, hidden_dim=16,
              d_filters=8)
    jcfg = JVidGANConfig(image_gan=JDCGANConfig(**img), **kw)
    # the JAX nets from numpy (std-0.2 weights), as a JAX state holds them
    rng = np.random.default_rng(0)
    flat = interop.to_jax_flat(tvid.init_train_state(
        torch.Generator().manual_seed(0),
        VidGANConfig(image_gan=DCGANConfig(**img), **kw), TrainConfig(),
        device="cpu"))
    tree = unflatten({k: jnp.asarray(0.2 * rng.standard_normal(v.shape),
                                     v.dtype) if k.endswith("/w") else
                      jnp.asarray(v) for k, v in flat.items()})
    ts = jvid.VidTrainState(jvid_dcgan.VidGANParams(**tree["params"]),
                            jvid_dcgan.VidGANState(**tree["state"]),
                            None, None, None)
    q, _ = jvid.quantize_sampler(ts, jcfg, calib_batches=1,
                                 calib_batch_size=4, float_last=True)
    art, wall = str(tmp_path / "art"), str(tmp_path / "wall")
    jquant.save_artifact(art, q, jcfg)

    assert cli.main(["sample-wall", "--checkpoint", art, "--quantized",
                     "--out-dir", wall, "--num-batches", "1",
                     "--batch-size", "4", "--device", "cpu"]) == 0
    assert sorted(os.listdir(wall)) == [f"{i}.gif" for i in range(4)]
    args = cli.build_parser().parse_args(
        ["sample-wall", "--checkpoint", art, "--quantized", "--out-dir",
         wall, "--device", "cpu"])
    cfg, sample_fn = cli._vid_sample_fn(args)
    z = rng.uniform(-1, 1, (4, 12)).astype(np.float32)
    want = np.asarray(jvid.sample_videos_q(q, jnp.asarray(z), jcfg))
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(sample_fn(z).numpy(), want, rtol=0,
                               atol=1e-4)


@pytest.fixture(scope="module")
def img_run(tmp_path_factory):
    """A tiny train-dcgan run's checkpoints dir (2 steps, 3 channels)."""
    run = str(tmp_path_factory.mktemp("i") / "img")
    assert cli.main(["train-dcgan", "--run-dir", run, "--dataset-size", "16",
                     "--batch-size", "8", "--steps-limit", "2",
                     "--sample-every", "0", "--checkpoint-every", "2"]
                    + IMG_FLAGS) == 0
    return os.path.join(run, "checkpoints")


def test_invert_z_extract_derive_paths_then_invert_with_paths(img_run,
                                                              tmp_path):
    """The latent workflow: make-paths; invert two PNGs (one resized) with
    a path file; z-extract over GIF clips (one batch padded, comparisons
    on); derive-paths from the trajectories; invert again animating a
    derived .txt path and an extracted .npy trajectory; visualize."""
    from gifgan_tpu_torch.data.video import write_gif
    from gifgan_tpu_torch.ops.image import write_png

    rng = np.random.default_rng(0)
    imgs = [str(tmp_path / "a.png"), str(tmp_path / "b.png")]
    write_png(imgs[0], rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    write_png(imgs[1], rng.integers(0, 256, (40, 36, 4), dtype=np.uint8))
    clips = tmp_path / "clips"
    clips.mkdir()
    for i in range(3):
        write_gif(str(clips / f"c{i}.gif"),
                  rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
    (clips / "notes.txt").write_text("not a clip")
    d = lambda n: str(tmp_path / n)

    assert cli.main(["make-paths", "--out-dir", d("paths"), "--z-dim", "16",
                     "--frames", "4"]) == 0
    assert len(os.listdir(d("paths"))) == 8
    assert cli.main(["invert", "--checkpoint", img_run, "--input-images",
                     *imgs, "--input-paths", d("paths/smile.txt"),
                     "--sample-dir", d("inv"), "--num-steps", "6",
                     "--batch-size", "5", "--pixel-l1-weight", "1",
                     "--lr-decay-frequency", "2",
                     "--progress-vid-sections", "0,2", "--device",
                     "cpu"]) == 0
    # (targets * (5 // 2))[:5], as the reference builds the batch: a, b,
    # a, b
    z = np.load(d("inv/z.npy"))
    assert z.shape == (4, 16) and np.isfinite(z).all()
    assert sorted(os.listdir(d("inv"))) == ["final.png", "path_00.gif",
                                            "z.npy"]
    assert native_gif.decode_gif(d("inv/path_00.gif")).shape == (4, 32, 32,
                                                                 3)

    assert cli.main(["z-extract", "--checkpoint", img_run,
                     "--input-directory", str(clips), "--output-z-folder",
                     d("zs"), "--vid-length", "4", "--batch-size", "2",
                     "--num-initial-steps", "3", "--num-steps-per-frame",
                     "2", "--write-comparisons", "--device", "cpu"]) == 0
    assert sorted(os.listdir(d("zs"))) == [
        f"c{i}{s}" for i in range(3) for s in (".npy", "_comparison.gif")]
    assert np.load(d("zs/c2.npy")).shape == (4, 16)
    # target | reconstruction, side by side
    assert native_gif.decode_gif(d("zs/c0_comparison.gif")).shape == (
        4, 32, 64, 3)

    assert cli.main(["derive-paths", "--traj-dir", d("zs"), "--out-dir",
                     d("dpaths"), "--top-k", "2"]) == 0
    derived = sorted(os.listdir(d("dpaths")))
    assert len(derived) == 2 and all(n.startswith("data_c")
                                     for n in derived)
    assert cli.main(["invert", "--checkpoint", img_run, "--input-images",
                     imgs[0], "--input-paths",
                     d("dpaths/" + derived[0]), d("zs/c1.npy"),
                     "--sample-dir", d("inv2"), "--num-steps", "2",
                     "--batch-size", "2", "--device", "cpu"]) == 0
    # no progress sections: no frames, so no final.png (as the reference)
    assert sorted(os.listdir(d("inv2"))) == ["path_00.gif", "path_01.gif",
                                             "z.npy"]

    for option, n in ((0, 1), (1, 3), (4, 4)):
        out = d(f"vis{option}")
        assert cli.main(["visualize", "--checkpoint", img_run, "--out-dir",
                         out, "--option", str(option), "--num-dims", "3",
                         "--batch-size", "8", "--device", "cpu"]) == 0
        assert len(os.listdir(out)) == n, os.listdir(out)


def test_read_image_is_rgb_and_resizes_as_the_jax_cli(tmp_path):
    """`invert` reads its images with cv2 (BGR): the port turns them to RGB
    and drops alpha, as the JAX CLI's imageio read gives them; a resize
    matches its jax.image.resize "linear" within float32 rounding."""
    import imageio.v2 as imageio
    import jax
    import jax.numpy as jnp

    from gifgan_tpu_torch.core.config import DCGANConfig
    from gifgan_tpu_torch.ops.image import write_png

    im = np.zeros((32, 32, 4), np.uint8)
    im[..., 0], im[..., 1], im[..., 2], im[..., 3] = 250, 120, 5, 77
    im[:4, :4, 0] = 10
    write_png(str(tmp_path / "rgba.png"), im)
    got = cli._read_image(str(tmp_path / "rgba.png"),
                          DCGANConfig(output_size=32))
    want = imageio.imread(str(tmp_path / "rgba.png"))[..., :3].astype(
        np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(got, want)
    assert got[10, 10, 0] > got[10, 10, 2]              # red, not blue
    gray = cli._read_image(str(tmp_path / "rgba.png"),
                           DCGANConfig(output_size=32, c_dim=1))
    np.testing.assert_array_equal(gray, want[..., :1])

    big = np.random.default_rng(1).integers(0, 256, (50, 44, 3),
                                            dtype=np.uint8)
    write_png(str(tmp_path / "big.png"), big)
    got = cli._read_image(str(tmp_path / "big.png"),
                          DCGANConfig(output_size=32))
    want = np.clip(np.asarray(jax.image.resize(
        jnp.asarray(big, jnp.float32), (32, 32, 3), method="linear")),
        0, 255) / 127.5 - 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_a_run_the_jax_package_wrote_inverts_through_the_port(tmp_path):
    """A checkpoint and params.json written by the JAX package (its
    init_train_state, no training) load through `_load_dcgan_from_run`
    bit-equal, and `invert` and `visualize` run on them."""
    import jax

    from gifgan_tpu.core import checkpoint as jckpt
    from gifgan_tpu.core.config import (DCGANConfig as JDCGANConfig,
                                        TrainConfig as JTrainConfig,
                                        save_config as jsave_config)
    from gifgan_tpu.train import gan as jgan
    from gifgan_tpu_torch.core import interop
    from gifgan_tpu_torch.ops.image import write_png

    cfg = JDCGANConfig(output_size=32, c_dim=3, z_dim=12, gf_dim=8,
                       df_dim=8)
    tcfg = JTrainConfig(batch_size=4)
    ts = jax.jit(jgan.init_train_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(3), cfg, tcfg)
    run = tmp_path / "jrun"
    jckpt.save(str(run / "checkpoints"), 0, ts._asdict())
    jsave_config({"model": cfg, "train": tcfg}, str(run / "params.json"))

    pcfg, params, state = cli._load_dcgan_from_run(
        str(run / "checkpoints"), "cpu")
    assert (pcfg.z_dim, pcfg.gf_dim, pcfg.output_size) == (12, 8, 32)
    got = interop.to_jax_flat({"params": params, "state": state})
    want = jckpt._flatten_with_paths({"params": ts.params,
                                      "state": ts.state})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    write_png(str(tmp_path / "a.png"), np.full((32, 32, 3), 128, np.uint8))
    assert cli.main(["invert", "--checkpoint", str(run / "checkpoints"),
                     "--input-images", str(tmp_path / "a.png"),
                     "--sample-dir", str(tmp_path / "inv"), "--num-steps",
                     "3", "--batch-size", "2", "--progress-vid-sections",
                     "0,1", "--device", "cpu"]) == 0
    assert np.load(tmp_path / "inv" / "z.npy").shape == (2, 12)
    assert os.path.exists(tmp_path / "inv" / "final.png")
    assert cli.main(["visualize", "--checkpoint", str(run / "checkpoints"),
                     "--out-dir", str(tmp_path / "vis"), "--option", "0",
                     "--batch-size", "4", "--device", "cpu"]) == 0
    assert os.listdir(tmp_path / "vis") == ["test_random.png"]
