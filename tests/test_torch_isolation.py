"""gifgan_tpu_torch stands alone: no module of it (nor chip_smoke.py)
imports jax or gifgan_tpu, and its entry points refuse to fall back to the
CPU when CUDA is absent."""

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
    assert int(n) >= 40, out.stdout
    assert bad == "[]", bad


def _entry_points():
    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.core.config import (TrackConfig, TrainConfig,
                                              VidGANConfig)
    from gifgan_tpu_torch.core.interop import from_jax_flat
    from gifgan_tpu_torch.data import loader, video
    from gifgan_tpu_torch.data.device import DeviceCorpus
    from gifgan_tpu_torch.kernels import flow
    from gifgan_tpu_torch import cli
    from gifgan_tpu_torch.track import detect, haar_device, pipeline
    from gifgan_tpu_torch.track.boxes import Detection
    from gifgan_tpu_torch.train import vid

    frames = np.zeros((4, 48, 48, 3), np.uint8)
    track = [Detection(8, 8, 40, 40, i) for i in range(4)]

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
    from gifgan_tpu_torch.kernels.haar_stages import haar_stages
    from gifgan_tpu_torch.kernels.resize import resize_normalize

    with pytest.raises(ValueError, match="torch.Tensor"):
        haar_stages(np.zeros((1, 64, 64), np.float32),
                    np.zeros((1, 64, 64), np.float32),
                    np.ones((4, 4), np.int8), None, 1)

    with pytest.raises(ValueError, match="torch.Tensor"):
        resize_normalize(np.zeros((1, 8, 8, 3), np.uint8), 4, 4)
    z = np.zeros((1, 2, 3, 3), np.float32)
    with pytest.raises(ValueError, match="torch.Tensor"):
        lk_refine(np.zeros((1, 8, 8), np.float32), z, z, z,
                  np.zeros((1, 2, 4), np.float32),
                  np.zeros((1, 2, 2), np.float32),
                  np.zeros((1, 2, 2), np.float32), win=3)
