"""The port's training, serving and latent commands (gifgan_tpu_torch/cli.py
train-dcgan, train-vid, sample-wall, quantize-export, invert, z-extract,
make-paths, derive-paths, visualize), driven in-process with --device cpu
on tiny flags: the reference's workflow (README "Cookbook"), image GAN ->
video GAN on top of it -> GIF wall, its int8 deployment (quantize-export ->
sample-wall --quantized), and its latent tooling (train-dcgan -> invert /
z-extract -> derive-paths -> invert --input-paths), write what they
should. The data, evaluation, serving and checkpoint commands are held
against the JAX CLI's on the same inputs, their parsers flag by flag."""

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
    counts (read with cv2, resized by ops/image.py resize_bilinear)
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


# ---------------------------------------------------------------------------
# The data-collection and evaluation commands (combine-stats, scrape,
# bulk-resize, video-to-gif, sample-frames, eval-fad, eval-track-rate,
# face-detect, survey-pairs) against the JAX commands on the same inputs,
# and the stills reader without imageio.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cascade_xml(tmp_path_factory):
    from gifgan_tpu_torch.track import synthetic_cascade as SC

    return SC.write_cascade(
        str(tmp_path_factory.mktemp("cascade") / "small.xml"), seed=0,
        stages=SC.SMALL_STAGES, n_pos=300, n_neg=1500)


def _jax_main(argv):
    from gifgan_tpu import cli as jcli

    jcli.main(argv)


def _both(capsys, argv, port_extra=("--device", "cpu")):
    """Run one command in both packages: (port stdout, JAX stdout)."""
    assert cli.main(argv + list(port_extra)) == 0
    got = capsys.readouterr().out
    _jax_main(argv)
    return got, capsys.readouterr().out


def test_stills_u8_reads_without_imageio(tmp_path, monkeypatch):
    """`_stills_u8` reads a directory with cv2, imageio unimportable in the
    process: RGB, RGBA and grayscale PNGs give the JAX CLI's bytes."""
    import argparse
    import sys

    from gifgan_tpu import cli as jcli
    from gifgan_tpu.core.config import DCGANConfig as JDCGANConfig
    from gifgan_tpu_torch.core.config import DCGANConfig
    from gifgan_tpu_torch.ops.image import write_png

    rng = np.random.default_rng(3)
    for name, c in (("rgb", 3), ("rgba", 4), ("gray", 1)):
        write_png(str(tmp_path / f"{name}.png"),
                  rng.integers(0, 256, (32, 32, c), dtype=np.uint8))
    args = argparse.Namespace(dataset=str(tmp_path), dataset_size=0)
    for c_dim in (3, 1):
        with monkeypatch.context() as m:
            for mod in ("imageio", "imageio.v2", "imageio.v3"):
                m.setitem(sys.modules, mod, None)
            got = cli._stills_u8(args, DCGANConfig(output_size=32,
                                                   c_dim=c_dim))
        want = jcli._stills_u8(args, JDCGANConfig(output_size=32,
                                                  c_dim=c_dim))
        assert got.shape == want.shape == (3, 32, 32, c_dim)
        np.testing.assert_array_equal(got, want)     # gray, rgb, rgba


def _stats_file(path, seed):
    from gifgan_tpu_torch.track.stats import TrackStats

    rng = np.random.default_rng(seed)
    s = TrackStats()
    s.total_files = 5
    s.cnt_files_processed = int(rng.integers(1, 5))
    s.cnt_total_detections = int(rng.integers(10, 99))
    s.observe_track(12, [40, 41], [38, 39])
    s.observe_final(1, [12])
    s.write(str(path))
    return str(path / "stats.json")


def test_data_commands_equal_the_jax_cli(tmp_path, capsys):
    """combine-stats, scrape --dry-run, bulk-resize, video-to-gif and
    sample-frames (a GIF and an mp4: PNGs within one grey level, the GIF's
    resized by K2's plain version, cv2 in JAX)."""
    import cv2

    from gifgan_tpu_torch.data.video import encode_mp4, read_gif, write_gif

    files = [_stats_file(tmp_path / f"s{i}", i) for i in range(2)]
    got, want = _both(capsys, ["combine-stats"] + files + [
        "--out-dir", str(tmp_path / "c")], ())
    assert got == want and "files" in got.lower()
    _jax_main(["combine-stats"] + files + ["--out-dir",
                                           str(tmp_path / "cj")])
    capsys.readouterr()
    with open(tmp_path / "c" / "stats.json") as f:
        combined = json.load(f)
    with open(tmp_path / "cj" / "stats.json") as f:
        assert json.load(f) == combined
    assert combined["total_files"] == 10
    assert combined["counters"]["cnt_final_tracks"] == 2

    kw = tmp_path / "kw.txt"
    kw.write_text("old\n# keywords not tried yet\nface\nsmile\n")
    (tmp_path / "scr" / "face").mkdir(parents=True)
    (tmp_path / "scr" / "face" / "abc.mp4").write_bytes(b"")
    argv = ["scrape", "--keywords", str(kw), "--out-dir",
            str(tmp_path / "scr"), "--num-threads", "3",
            "--items-per-thread", "250", "--dry-run"]
    got, want = _both(capsys, argv, ())
    assert json.loads(got) == json.loads(want)
    assert json.loads(got)["already_downloaded_ids"] == 1
    assert json.loads(got)["planned_requests_per_keyword"] == 9

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(4)
    clip = rng.integers(0, 256, (9, 40, 48, 3), dtype=np.uint8)
    clip = np.stack([cv2.GaussianBlur(f, (5, 5), 0) for f in clip])
    encode_mp4(str(src / "a.mp4"), clip)
    encode_mp4(str(src / "b.mp4"), clip[:3])
    write_gif(str(src / "c.gif"), clip[:7])
    got, want = _both(capsys, ["bulk-resize", "--input-directory", str(src),
                               "--output-directory", str(tmp_path / "br"),
                               "--width", "24", "--length", "6"], ())
    assert json.loads(got) == json.loads(want) == {
        "written": 1, "skipped_short": 1, "errors": 0}

    for side in ("t", "j"):
        argv = ["video-to-gif", "--input-directory", str(src),
                "--output-directory", str(tmp_path / f"g{side}"), "--fps",
                "5"]
        if side == "t":
            assert cli.main(argv) == 0
        else:
            _jax_main(argv)
    capsys.readouterr()
    assert sorted(os.listdir(tmp_path / "gt")) == \
        sorted(os.listdir(tmp_path / "gj")) == ["a.gif", "b.gif"]
    for n in ("a.gif", "b.gif"):
        np.testing.assert_array_equal(read_gif(str(tmp_path / "gt" / n)),
                                      read_gif(str(tmp_path / "gj" / n)))

    argv = ["sample-frames", "--input-directory", str(src),
            "--frames-per-video", "4", "--size", "16", "--seed", "3"]
    assert cli.main(argv + ["--output-directory", str(tmp_path / "ft"),
                            "--device", "cpu"]) == 0
    _jax_main(argv + ["--output-directory", str(tmp_path / "fj")])
    assert capsys.readouterr().out.splitlines() == ["wrote 11 frames"] * 2
    names = sorted(os.listdir(tmp_path / "ft"))
    assert names == sorted(os.listdir(tmp_path / "fj"))
    assert len(names) == 11
    for n in names:
        a = cv2.imread(str(tmp_path / "ft" / n), cv2.IMREAD_COLOR)
        b = cv2.imread(str(tmp_path / "fj" / n), cv2.IMREAD_COLOR)
        assert a.shape == b.shape == (16, 16, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_eval_fad_and_survey_pairs_equal_the_jax_cli(img_run, tmp_path,
                                                     capsys):
    """eval-fad on the same train-dcgan run and image directories (48
    images a set, more than the 32 feature dimensions; some resized):
    within 1e-3 relative or 1e-6 absolute. survey-pairs on an exported
    sample directory: the same output and files."""
    from gifgan_tpu_torch.eval.survey import export_survey_samples
    from gifgan_tpu_torch.ops.image import write_png

    rng = np.random.default_rng(6)
    for d, shift in (("real", 0), ("fake", 60)):
        (tmp_path / d).mkdir()
        for i in range(48):
            side = 40 if i % 5 == 0 else 32
            im = np.clip(rng.normal(128 + shift, 50, (side, side, 3)), 0,
                         255).astype(np.uint8)
            write_png(str(tmp_path / d / f"{i:03d}.png"), im)
    argv = ["eval-fad", "--checkpoint", img_run, "--real-dir",
            str(tmp_path / "real"), "--fake-dir", str(tmp_path / "fake"),
            "--batch-size", "24"]
    got, want = (json.loads(o) for o in _both(capsys, argv))
    assert got["n_real"] == want["n_real"] == 48
    assert got["n_fake"] == want["n_fake"] == 48
    assert want["fad"] > 0
    assert abs(got["fad"] - want["fad"]) <= max(1e-3 * want["fad"], 1e-6)
    same = argv[:6] + [str(tmp_path / "real")] + argv[7:]
    assert cli.main(same + ["--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["fad"] < 1e-6

    vids = {v: rng.integers(0, 256, (4, 3, 16, 16, 3), dtype=np.uint8)
            for v in ("rnn", "stride")}
    for side in ("t", "j"):
        export_survey_samples({v: (lambda n, v=v: vids[v][:n])
                               for v in vids}, str(tmp_path / side),
                              samples_per_variant=4)
    out = {}
    for side in ("t", "j"):
        argv = ["survey-pairs", "--sample-dir", str(tmp_path / side),
                "--variant-a", "rnn", "--variant-b", "stride", "--n", "3",
                "--seed", "2", "--url-prefix", "https://host/"]
        if side == "t":
            assert cli.main(argv) == 0
        else:
            _jax_main(argv)
        out[side] = capsys.readouterr().out.replace(str(tmp_path / side), "")
    assert out["t"] == out["j"] and out["t"].startswith("3 pairs")
    for name in ("pairs.json", "pairs.csv"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()


def _glyph_frame(tmp_path):
    """A 160x200 frame with two glyphs of two sizes over black, and a query
    image of the smaller one."""
    from gifgan_tpu_torch.ops.image import write_png
    from gifgan_tpu_torch.track import synthetic_cascade as SC

    frame = np.zeros((160, 200, 3), np.uint8)
    for x, y, side in ((10, 20, 64), (110, 60, 48)):
        g = np.rint(SC.glyph_image(side)).astype(np.uint8)
        frame[y:y + side, x:x + side] = g[..., None]
    write_png(str(tmp_path / "frame.png"), frame)
    write_png(str(tmp_path / "query.png"), frame[60:108, 110:158])
    return str(tmp_path / "frame.png"), str(tmp_path / "query.png")


def test_face_detect_equals_the_jax_cli(cascade_xml, tmp_path, capsys,
                                        monkeypatch):
    """face-detect --best --biggest --query: with one detector in both
    packages (the numpy cascade, put in place of each default_detector),
    the same boxes and picks, scores and similarities within 1e-4 (the
    crops' antialiased resize in float32). With its own default (the
    device detector, its plain version here) the port finds both glyphs."""
    from gifgan_tpu.track import detect as jdetect
    from gifgan_tpu.track import haar as jhaar
    from gifgan_tpu_torch.track import detect as tdetect
    from gifgan_tpu_torch.track import haar as thaar

    image, query = _glyph_frame(tmp_path)
    argv = ["face-detect", "--image", image, "--cascade", cascade_xml,
            "--min-size", "30", "--best", "--biggest", "--query", query]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    own = json.loads(capsys.readouterr().out)
    assert len(own["faces"]) == 2

    made = []
    for mod, haar in ((tdetect, thaar), (jdetect, jhaar)):
        def python_detector(cascade_path=None, min_neighbors=3, min_size=20,
                            haar=haar, **kw):
            made.append((min_neighbors, min_size))
            return haar.HaarDetector(cascade_path,
                                     min_neighbors=min_neighbors,
                                     min_size=min_size)
        monkeypatch.setattr(mod, "default_detector", python_detector)
    got, want = (json.loads(o) for o in _both(capsys, argv))
    assert made == [(3, 30)] * 2
    assert len(want["faces"]) == 2
    for k in ("faces", "best", "biggest", "most_similar"):
        assert got[k] == want[k], k
    for k in ("scores", "similarities"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
    assert got["biggest"][0] == 10
    for box in own["faces"]:
        assert min(np.abs(np.array(want["faces"]) - box).max(axis=1)) <= 8


def test_eval_track_rate_equals_the_jax_cli(cascade_xml, tmp_path, capsys):
    """eval-track-rate over a directory of glyph GIFs and one of noise GIFs
    (64x64, upscaled 2x): the port's device detector and device flow (their
    plain versions here) against the JAX command's host detector and flow;
    the same report."""
    from gifgan_tpu_torch.data.video import write_gif
    from gifgan_tpu_torch.track import synthetic_cascade as SC

    rng = np.random.default_rng(8)
    glyph = np.rint(SC.glyph_image(44)).astype(np.uint8)
    for d in ("glyphs", "noise"):
        (tmp_path / d).mkdir()
        for i in range(2):
            if d == "noise":
                clip = rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
            else:
                clip = np.zeros((10, 64, 64, 3), np.uint8)
                for t in range(10):
                    x, y = 4 + i + t, 6 + t // 2
                    clip[t, y:y + 44, x:x + 44] = glyph[..., None]
            write_gif(str(tmp_path / d / f"{i}.gif"), clip)
    argv = ["eval-track-rate", "--sample-dirs", str(tmp_path / "glyphs"),
            str(tmp_path / "noise") + "/", "--cascade", cascade_xml,
            "--limit", "5"]
    got, want = _both(capsys, argv)
    assert got == want
    assert "glyphs: 2/2 (100.0%)" in got and "noise: 0/2 (0.0%)" in got


# ---------------------------------------------------------------------------
# The serving and checkpoint commands (export-web, explorer, webcam-serve,
# survey-serve, ckpt-downgrade, ckpt-inspect): their parsers against the
# JAX CLI's, flag by flag, and their output against the JAX commands'.
# ---------------------------------------------------------------------------

SERVE_COMMANDS = {"export-web": True, "explorer": True, "webcam-serve": True,
                  "survey-serve": False, "ckpt-downgrade": False,
                  "ckpt-inspect": False, "bench": True}
TF_REF = os.path.join(os.path.dirname(__file__), "fixtures", "tf_ref_dcgan",
                      "ref.ckpt")


class _Parsed(Exception):
    pass


def _jax_subparsers(monkeypatch):
    """The JAX CLI builds its parser inside main(): catch it at parse."""
    import argparse

    def catch(self, *a, **kw):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as e:
            _jax_main(["ckpt-inspect", "x"])
    return _choices(e.value.args[0])


def _choices(parser):
    import argparse

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _flags(p):
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.default,
                     a.type, a.choices, a.required, a.nargs, a.const)
            for a in p._actions if a.dest != "help"}


@pytest.mark.parametrize("command", sorted(SERVE_COMMANDS))
def test_serve_and_ckpt_parsers_equal_the_jax_cli(command, monkeypatch):
    """Each flag's names, action, default, type, choices, required and
    nargs equal the JAX command's; the commands that touch the card add
    --device (default None: the card)."""
    want = _flags(_jax_subparsers(monkeypatch)[command])
    got = _flags(_choices(cli.build_parser())[command])
    if SERVE_COMMANDS[command]:
        assert got.pop("device") == (("--device",), "_StoreAction", None,
                                     None, None, False, None, None)
    assert got == want


@pytest.mark.parametrize("command", ["train-dcgan", "train-vid",
                                     "train-recurrent", "sample-wall"])
def test_train_and_sample_wall_parsers_equal_the_jax_cli(command,
                                                         monkeypatch):
    """The training commands and sample-wall take exactly the JAX command's
    flags, the mesh flags (--data-parallel, --fsdp, --fsdp-min-size, and
    train-vid's --tensor-parallel and --seq-parallel) with their defaults
    included, plus --device."""
    want = _flags(_jax_subparsers(monkeypatch)[command])
    got = _flags(_choices(cli.build_parser())[command])
    assert got.pop("device") == (("--device",), "_StoreAction", None,
                                 None, None, False, None, None)
    if command == "train-vid":
        assert {"tensor_parallel", "seq_parallel"} <= set(got)
    assert got == want


def test_train_vid_refuses_fsdp_with_tensor_parallel(tmp_path, monkeypatch):
    """--fsdp --tensor-parallel 2 is refused with the JAX loop's message:
    the JAX CLI on the conftest's 8 virtual devices (a 4 x 2 mesh), the
    port's on a mesh of 2 ranks of which this process is the first (the
    refusal comes before any collective), and the port writes nothing."""
    from gifgan_tpu_torch.core.mesh import make_mesh

    argv = ["train-vid", "--fsdp", "--tensor-parallel", "2",
            "--output-size", "32", "--z-dim", "16", "--gf-dim", "8",
            "--df-dim", "8", "--vid-z-dim", "20", "--vid-length", "4",
            "--dataset-size", "8", "--batch-size", "4"]
    with pytest.raises(ValueError) as want:
        _jax_main(argv + ["--run-dir", str(tmp_path / "jax")])
    monkeypatch.setattr(cli, "_mesh_arg", lambda args: make_mesh(
        [0, 1], data_parallel=1, model_parallel=args.tensor_parallel))
    with pytest.raises(ValueError) as got:
        cli.main(argv + ["--run-dir", str(tmp_path / "port"), "--device",
                         "cpu"])
    assert str(got.value) == str(want.value) == (
        "--fsdp and --tensor-parallel shard the train state along "
        "different mesh axes; pick one")
    assert not (tmp_path / "port").exists()


def test_the_port_has_26_of_the_27_commands(monkeypatch):
    """Named when `bench` was the one missing; the port now has all 27,
    and one of its own, `train-prednet`."""
    want = set(_jax_subparsers(monkeypatch))
    got = set(_choices(cli.build_parser()))
    assert len(want) == 27 and got == want | {"train-prednet"}


@pytest.mark.parametrize("case", ["inspect_run", "inspect_tf", "downgrade"])
def test_ckpt_commands_equal_the_jax_cli(case, img_run, tmp_path, capsys):
    from gifgan_tpu_torch.core.ckpt_tools import read_tf_checkpoint

    out = str(tmp_path / "v1.ckpt")
    argv = {"inspect_run": ["ckpt-inspect", img_run],
            "inspect_tf": ["ckpt-inspect", TF_REF],
            "downgrade": ["ckpt-downgrade", "--input-prefix", TF_REF,
                          "--output", out]}[case]
    got, want = _both(capsys, argv, ())
    assert got == want
    if case == "inspect_run":
        assert "params/generator/h1_deconv/w  (5, 5, 32, 64)  float32" in got
        assert got.splitlines()[-1].startswith("total parameters: ")
    elif case == "inspect_tf":
        assert len(got.splitlines()) == 48
        assert "g_h1/w  float32  (5, 5, 32, 64)" in got
    else:
        assert got == f"wrote V1 TensorSlice checkpoint: {out}\n"
        assert len(read_tf_checkpoint(out)) == 48


def test_export_web_through_the_cli(img_run, tmp_path, capsys):
    """export-web on a train-dcgan run through cli.main: the demo's four
    files; weights.json is the JAX package's generator_to_json of the
    run's stored arrays, byte for byte; the golden image is the run's
    generator on the golden z (generator_forward_reference within one grey
    level)."""
    from gifgan_tpu.core.config import DCGANConfig as JDCGANConfig
    from gifgan_tpu.serve.web_export import generator_to_json
    from gifgan_tpu_torch.core.tree import unflatten
    from gifgan_tpu_torch.serve.web_export import generator_forward_reference

    out = str(tmp_path / "t")
    assert cli.main(["export-web", "--checkpoint", img_run, "--out-dir", out,
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(
        f"browser demo exported to {out}; serve it and open draw.html")
    assert sorted(os.listdir(out)) == ["draw.html", "generator.js",
                                       "golden.json", "weights.json"]
    tree = unflatten(ckpt.load_flat(img_run))
    with open(os.path.join(out, "weights.json")) as f:
        text = f.read()
    assert text == generator_to_json(
        tree["params"]["generator"], tree["state"]["generator"],
        JDCGANConfig(output_size=32, z_dim=16, gf_dim=8, df_dim=8))
    with open(os.path.join(out, "golden.json")) as f:
        golden = json.load(f)
    ref = generator_forward_reference(json.loads(text), golden["z"])
    u8 = np.clip(np.round(255.0 * (ref + 1.0) / 2.0), 0, 255).astype(int)
    assert golden["shape"] == [32, 32, 3]
    assert np.abs(u8.ravel() - np.asarray(golden["image_u8"])).max() <= 1


@pytest.mark.parametrize("command", ["explorer", "webcam-serve"])
def test_services_refuse_to_start_without_cuda(command, img_run, tmp_path,
                                               monkeypatch, capsys):
    """Without CUDA the command raises before it listens; with --device cpu
    it builds its service (explorer: the int8 sampler with one calibration
    batch, warmed; webcam: a 2-step backend, warmed) and hands it to
    serve(), replaced here by a stub that drives one request."""
    from gifgan_tpu_torch.serve import explorer, webcam

    argv = [command, "--checkpoint", img_run, "--port", "0"]
    argv += (["--media-dir", str(tmp_path / "m"), "--int8", "--int8-calib",
              "1", "--batch-size", "4", "--warmup"]
             if command == "explorer" else
             ["--out-dir", str(tmp_path / "w"), "--num-steps", "2",
              "--batch-size", "2", "--warmup"])
    served = []

    def stub(service, **kw):
        if command == "explorer":
            served.append(service.random_faces())
        else:
            served.append(service.animate(
                np.zeros((32, 32, 3), np.uint8)))
        served.append(kw)

    module = explorer if command == "explorer" else webcam
    monkeypatch.setattr(module, "serve", stub)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert served == []
    assert cli.main(argv + ["--device", "cpu"]) == 0
    result, kw = served
    assert kw["port"] == 0 and kw["host"] == "127.0.0.1"
    if command == "explorer":
        assert result["response"] == "success"
        assert len(os.listdir(tmp_path / "m")) == 36
        assert kw["static_dir"].endswith(os.path.join("serve", "static"))
    else:
        assert np.isfinite(result["final_loss"])
        assert os.listdir(tmp_path / "w") == ["req_0"]
    assert "warm" in capsys.readouterr().out
