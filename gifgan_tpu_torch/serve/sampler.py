"""Batch GIF sampler and z-trajectory renderer (gifgan_tpu/serve/sampler.py).

- `gif_wall`: the `sample-wall` request loop: each request samples a batch
  of videos and writes one numbered GIF per video, atomically. On a mesh
  (`vid_sample_fn(mesh=)`, parallel/dp.py make_sharded_sampler) every rank
  samples its rows of each request and rank 0 writes.
- `render_z_trajectory`: a saved per-frame z trajectory (.npy) rendered
  through the image sampler at an upscale factor, as a GIF where the
  reference writes an mp4."""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import numpy as np
import torch

from gifgan_tpu_torch.core.config import VidGANConfig
from gifgan_tpu_torch.data.video import write_gif
from gifgan_tpu_torch.ops.image import denorm_u8
from gifgan_tpu_torch.parallel.dp import make_sharded_sampler
from gifgan_tpu_torch.train.vid import (VidTrainState, sample_videos,
                                        sample_videos_q)


def _numpy_z(fn, tree, cfg: VidGANConfig, device, mesh
             ) -> Callable[[np.ndarray], torch.Tensor]:
    if mesh is not None:
        fn = make_sharded_sampler(fn, mesh, static_args={"cfg": cfg})
    else:
        fn = functools.partial(fn, cfg=cfg)

    def sample_fn(z: np.ndarray) -> torch.Tensor:
        return fn(tree, torch.as_tensor(np.asarray(z, np.float32),
                                        device=device))

    return sample_fn


def vid_sample_fn(ts: VidTrainState, cfg: VidGANConfig, mesh=None,
                  ) -> Callable[[np.ndarray], torch.Tensor]:
    """z (B, z_in) numpy -> videos (B, T, s, s, c) in [-1, 1] on the
    state's device (the float sampler of the JAX CLI's sample-wall).
    mesh: each rank samples its rows of z; every rank gets the batch."""
    return _numpy_z(sample_videos, ts, cfg, ts.step.device, mesh)


def vid_sample_fn_q(q, cfg: VidGANConfig, mesh=None,
                    ) -> Callable[[np.ndarray], torch.Tensor]:
    """vid_sample_fn over an int8 serving tree (train/vid.py
    quantize_sampler, or ops/quant.py load_artifact), on its device."""
    return _numpy_z(sample_videos_q, q, cfg, q["img"]["h0_lin"]["b"].device,
                    mesh)


def gif_wall(sample_fn: Callable[[np.ndarray], object], z_dim: int,
             out_dir: str, batch_size: int = 64,
             num_batches: Optional[int] = 1, fps: float = 8.0,
             seed: int = 0, start_index: int = 0,
             continuous: bool = False, write: bool = True) -> int:
    """sample_fn: z (B, z_dim) -> videos (B, T, s, s, c) in [-1, 1], numpy
    or tensor. Writes `<n>.gif` per video; num_batches=None with
    continuous=True loops until interrupted. Returns the GIFs written.
    write=False samples the same requests and writes nothing (a mesh's
    ranks other than 0)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = start_index
    batch = 0
    while continuous or batch < (num_batches or 0):
        z = rng.uniform(-1, 1, (batch_size, z_dim)).astype(np.float32)
        videos = sample_fn(z)
        if write:
            for i, vid in enumerate(denorm_u8(videos)):
                write_gif(os.path.join(out_dir, f"{n + i}.gif"), vid,
                          fps=fps, atomic=True)
        n += len(videos)
        batch += 1
    return n - start_index


def render_z_trajectory(sample_fn: Callable[[np.ndarray], object],
                        z_path: str, out_path: str, scale: int = 2,
                        fps: float = 8.0) -> str:
    """z_path: .npy of (T, z_dim), one latent per frame; sample_fn: z ->
    images (T, s, s, c) in [-1, 1], numpy or tensor. Writes an upscaled
    GIF."""
    zs = np.load(z_path).astype(np.float32)
    u8 = denorm_u8(sample_fn(zs))
    if scale != 1:
        u8 = np.repeat(np.repeat(u8, scale, axis=1), scale, axis=2)
    write_gif(out_path, u8, fps=fps)
    return out_path
