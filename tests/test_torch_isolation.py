"""gifgan_tpu_torch stands alone: no module of it (nor chip_smoke.py)
imports jax or gifgan_tpu, and its entry points refuse to fall back to the
CPU when CUDA is absent."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import gifgan_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(gifgan_tpu_torch.__path__,
                                              "gifgan_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gifgan_tpu"))
print(len(mods), bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 83, out.stdout
    assert bad == "[]", bad


def _entry_points():
    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.core.config import (TrackConfig, TrainConfig,
                                              VidGANConfig)
    from gifgan_tpu_torch.core.interop import from_jax_flat
    from gifgan_tpu_torch.data import loader, video
    from gifgan_tpu_torch.data.device import DeviceCorpus
    from gifgan_tpu_torch.eval import activation_distances
    from gifgan_tpu_torch.kernels import flow
    from gifgan_tpu_torch.ops import quant
    from gifgan_tpu_torch import cli
    from gifgan_tpu_torch.track import detect, haar_device, pipeline
    from gifgan_tpu_torch.track.boxes import Detection
    from gifgan_tpu_torch.core.config import DCGANConfig
    from gifgan_tpu_torch.core.config import RecurrentImageConfig
    from gifgan_tpu_torch.core.rng import PRNGSequence
    from gifgan_tpu_torch.models import prednet, rnn_prototypes
    from gifgan_tpu_torch.train import gan, loops, recurrent, vid
    from gifgan_tpu_torch.train import prednet as prednet_train
    from gifgan_tpu_torch.eval import fad, track_rate
    from gifgan_tpu_torch.track import flow_gather, haar

    from gifgan_tpu_torch.core import ckpt_tools
    from gifgan_tpu_torch.models import dcgan
    from gifgan_tpu_torch.serve import explorer, web_export, webcam
    from gifgan_tpu_torch import bench

    frames = np.zeros((4, 48, 48, 3), np.uint8)
    track = [Detection(8, 8, 40, 40, i) for i in range(4)]
    gp, gs = dcgan.init(torch.Generator(), DCGANConfig(output_size=16,
                                                       gf_dim=1, df_dim=1),
                        device="cpu")

    return {
        "resolve_device": lambda: resolve_device(),
        "init_train_state": lambda: vid.init_train_state(
            torch.Generator(), VidGANConfig(), TrainConfig()),
        "make_knobs": lambda: vid.make_knobs(VidGANConfig()),
        "DeviceCorpus": lambda: DeviceCorpus(np.zeros((2, 8), np.uint8)),
        "from_jax_flat": lambda: from_jax_flat({"a/b": np.zeros(2)}),
        "load_vid_train_state": lambda: vid.load_vid_train_state("/none"),
        "clip_batches_from_files": lambda: next(
            loader.clip_batches_from_files(["/none.gif"], 1, 2, 8)),
        "resize_u8": lambda: video.resize_u8(frames, 8),
        "flow_pairs": lambda: flow.flow_pairs(frames[:1, ..., 0],
                                              frames[:1, ..., 0]),
        "process_video": lambda: pipeline.process_video(
            frames, lambda f, i: [], TrackConfig(flow_backend="mxu")),
        "process_video_default_config": lambda: pipeline.process_video(
            frames, lambda f, i: [], TrackConfig()),
        "crop_and_resize_tracks": lambda: pipeline.crop_and_resize_tracks(
            frames, [track], 8),
        "run_directory": lambda: pipeline.run_directory(
            "/none", "/none", TrackConfig(), detector=lambda f, i: []),
        "run_directory_cascade": lambda: pipeline.run_directory(
            "/none", "/none", TrackConfig(), cascade_path="/none.xml"),
        "process_video_cascade": lambda: pipeline.process_video(
            frames, None, TrackConfig(), cascade_path="/none.xml"),
        # no cascade file either: still the card, never OpenCV on the host
        "run_directory_no_cascade": lambda: pipeline.run_directory(
            "/none", "/none", TrackConfig()),
        "process_video_no_cascade": lambda: pipeline.process_video(
            frames, None, TrackConfig()),
        "cli_track_no_cascade": lambda: cli.main(
            ["track", "--input-directory", "/none", "--output-directory",
             "/none"]),
        "DeviceHaarDetector": lambda: haar_device.DeviceHaarDetector(
            "/none.xml"),
        "default_detector_auto": lambda: detect.default_detector(
            "/none.xml"),
        "default_detector_device": lambda: detect.default_detector(
            "/none.xml", backend="device"),
        "cli_track": lambda: cli.main(
            ["track", "--input-directory", "/none", "--output-directory",
             "/none", "--cascade", "/none.xml"]),
        "gan_init_train_state": lambda: gan.init_train_state(
            torch.Generator(), DCGANConfig(), TrainConfig()),
        "PRNGSequence": lambda: PRNGSequence(0),
        "train_dcgan": lambda: loops.train_dcgan(
            None, DCGANConfig(), TrainConfig(run_dir="/none")),
        "train_vid_dcgan": lambda: loops.train_vid_dcgan(
            None, VidGANConfig(), TrainConfig(run_dir="/none")),
        "cli_train_dcgan": lambda: cli.main(
            ["train-dcgan", "--run-dir", "/none"]),
        "cli_train_vid": lambda: cli.main(
            ["train-vid", "--run-dir", "/none", "--device-corpus"]),
        "cli_sample_wall": lambda: cli.main(
            ["sample-wall", "--checkpoint", "/none", "--out-dir", "/none"]),
        "load_artifact": lambda: quant.load_artifact("/none"),
        "cli_sample_wall_quantized": lambda: cli.main(
            ["sample-wall", "--checkpoint", "/none", "--out-dir", "/none",
             "--quantized"]),
        "cli_sample_wall_int8": lambda: cli.main(
            ["sample-wall", "--checkpoint", "/none", "--out-dir", "/none",
             "--int8", "--int8-calib", "2"]),
        "cli_quantize_export": lambda: cli.main(
            ["quantize-export", "--checkpoint", "/none", "--out-dir",
             "/none", "--calib-batches", "2", "--bias-correct"]),
        "cli_invert": lambda: cli.main(
            ["invert", "--checkpoint", "/none", "--input-images", "/none",
             "--sample-dir", "/none"]),
        "cli_z_extract": lambda: cli.main(
            ["z-extract", "--checkpoint", "/none", "--input-directory",
             "/none", "--output-z-folder", "/none"]),
        "cli_visualize": lambda: cli.main(
            ["visualize", "--checkpoint", "/none", "--out-dir", "/none"]),
        "activation_distances": lambda: activation_distances(
            {}, {}, DCGANConfig(), [frames.astype(np.float32)]),
        "train_recurrent": lambda: loops.train_recurrent(
            None, RecurrentImageConfig(), TrainConfig(run_dir="/none")),
        "cli_train_recurrent": lambda: cli.main(
            ["train-recurrent", "--run-dir", "/none", "--dataset-size", "1"]),
        "recurrent_init_train_state": lambda: recurrent.init_train_state(
            torch.Generator(), RecurrentImageConfig(), TrainConfig()),
        "init_cond_train_state": lambda: gan.init_cond_train_state(
            torch.Generator(), DCGANConfig(output_size=28, c_dim=1), 10,
            TrainConfig()),
        "prednet_init": lambda: prednet.init(torch.Generator(),
                                             prednet.PredNetConfig()),
        "prednet_init_train_state": lambda: prednet_train.init_train_state(
            torch.Generator(), prednet.PredNetConfig(), TrainConfig()),
        "train_prednet": lambda: loops.train_prednet(
            None, prednet.PredNetConfig(), TrainConfig(run_dir="/none")),
        "cli_train_prednet": lambda: cli.main(
            ["train-prednet", "--run-dir", "/none", "--dataset-size", "1"]),
        "echo_rnn_init": lambda: rnn_prototypes.echo_rnn_init(
            torch.Generator()),
        "vector_echo_init": lambda: rnn_prototypes.vector_echo_init(
            torch.Generator(), 6),
        "conv_cls_init": lambda: rnn_prototypes.conv_cls_init(
            torch.Generator()),
        "sample_frames_from_video_gif": lambda:
            video.sample_frames_from_video("/none.gif", 2, 8,
                                           np.random.default_rng(0)),
        "fad": lambda: fad.fad({}, {}, frames, frames, DCGANConfig()),
        "face_track_rate": lambda: track_rate.face_track_rate(
            [frames], lambda f, i: []),
        "gather_flow_backend": lambda: flow_gather.gather_flow_backend(
            frames[0, ..., 0], frames[0, ..., 0]),
        "process_video_gather_flow": lambda: pipeline.process_video(
            frames, lambda f, i: [], TrackConfig(flow_backend="jax")),
        "GatherHaarDetector": lambda: haar.GatherHaarDetector("/none.xml"),
        "BatchedGatherHaarDetector": lambda: haar.BatchedGatherHaarDetector(
            "/none.xml"),
        "cli_sample_frames": lambda: cli.main(
            ["sample-frames", "--input-directory", "/none",
             "--output-directory", "/none"]),
        "cli_eval_fad": lambda: cli.main(
            ["eval-fad", "--checkpoint", "/none", "--real-dir", "/none",
             "--fake-dir", "/none"]),
        "cli_eval_track_rate": lambda: cli.main(
            ["eval-track-rate", "--sample-dirs", "/none", "--cascade",
             "/none.xml"]),
        "cli_face_detect": lambda: cli.main(
            ["face-detect", "--image", "/none.png", "--cascade",
             "/none.xml"]),
        # the services refuse before they listen
        "explorer.serve": lambda: explorer.serve(explorer.ExplorerCore(
            explorer.dcgan_sampler(gp, gs, DCGANConfig()), 100, "/none"),
            port=0, background=True),
        "webcam.serve": lambda: webcam.serve(webcam.WebcamBackend(
            gp, gs, DCGANConfig(), "/none"), port=0, background=True),
        "cli_explorer": lambda: cli.main(
            ["explorer", "--checkpoint", "/none"]),
        "cli_webcam_serve": lambda: cli.main(
            ["webcam-serve", "--checkpoint", "/none"]),
        "cli_export_web": lambda: cli.main(
            ["export-web", "--checkpoint", "/none", "--out-dir", "/none"]),
        "generator_from_json": lambda: web_export.generator_from_json(
            json.dumps({"format": web_export.FORMAT, "layers": [],
                        "z_dim": 1, "output_size": 16, "c_dim": 3,
                        "gf_dim": 1})),
        "run_bench": lambda: bench.run_bench(),
        "cli_bench": lambda: cli.main(["bench"]),
        "import_reference_dcgan": lambda: ckpt_tools.import_reference_dcgan(
            os.path.join(REPO, "tests", "fixtures", "tf_ref_dcgan",
                         "ref.ckpt"), DCGANConfig()),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_default_device_is_cuda_and_raises_without_it(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_kernel_wrappers_take_tensors_only():
    """resize_normalize, lk_refine and haar_stages have no device argument:
    the tensor they are given decides (CPU -> plain version, CUDA ->
    kernel). A numpy array, which lies on no device, is refused, not run on
    the CPU."""
    from gifgan_tpu_torch.kernels.flow_refine import lk_refine
    from gifgan_tpu_torch.kernels.haar_stages import WindowGrid, haar_stages
    from gifgan_tpu_torch.kernels.resize import resize_normalize

    with pytest.raises(ValueError, match="torch.Tensor"):
        haar_stages(np.zeros((1, 64, 64), np.float32),
                    np.zeros((1, 64, 64), np.float32),
                    WindowGrid(np.ones((4, 4), np.int8),
                               np.zeros((16, 2), np.int32)), None, 1)

    with pytest.raises(ValueError, match="torch.Tensor"):
        resize_normalize(np.zeros((1, 8, 8, 3), np.uint8), 4, 4)
    z = np.zeros((1, 2, 3, 3), np.float32)
    with pytest.raises(ValueError, match="torch.Tensor"):
        lk_refine(np.zeros((1, 8, 8), np.float32), z, z, z,
                  np.zeros((1, 2, 4), np.float32),
                  np.zeros((1, 2, 2), np.float32),
                  np.zeros((1, 2, 2), np.float32), win=3)
