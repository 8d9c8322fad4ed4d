"""Batch dataset z-extraction (gifgan_tpu/invert/z_finder.py): videos ->
per-video latent trajectories, the production form of the iterative video
inverter. Kept from the reference:

  - resume: a clip whose output .npy exists is skipped;
  - a partial batch is padded to the batch size by repeating its last clip
    (with train-mode activations the padding takes part in the BN batch
    statistics, as in the reference);
  - `stop_after` counts clips processed, not clips written;
  - a clip whose shape differs from its batch's is skipped;
  - per batch, `num_initial_steps` Adam steps on frame 0, then
    `num_steps_per_frame` warm-started steps on every frame
    (optimize.invert_video_iterative), all videos of the batch at once;
  - optional comparison renders (target | reconstruction), written as a
    GIF where the reference writes an mp4.

With `mesh=` every rank runs the same walk and each batch's inversions run
data-parallel over the mesh's data axis (optimize.py shard_problem); rank
0 writes the outputs.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import DCGANConfig, InvertConfig
from gifgan_tpu_torch.data.video import write_gif
from gifgan_tpu_torch.invert.optimize import invert_video_iterative
from gifgan_tpu_torch.models import dcgan
from gifgan_tpu_torch.ops.image import denorm_u8


def extract_z_trajectories(params, state, cfg: DCGANConfig,
                           icfg: InvertConfig,
                           clip_paths: Sequence[str],
                           load_clip: Callable[[str], Optional[np.ndarray]],
                           output_dir: str,
                           batch_size: int = 8,
                           num_initial_steps: int = 500,
                           num_steps_per_frame: int = 100,
                           post_initial_lr_decay: float = 0.9,
                           stop_after: Optional[int] = None,
                           write_comparisons: bool = False,
                           seed: int = 0, device=None,
                           mesh=None) -> List[str]:
    """load_clip: path -> (T, s, s, c) float [-1, 1] frames, or None to
    skip. Writes `<output_dir>/<clip-stem>.npy` of shape (T, z_dim) and
    returns the outputs written by this call.

    mesh: run each batch's per-frame optimizations data-parallel over the
    mesh's data axis (the partial-batch padding keeps the batch at
    batch_size: pick a multiple of the data axis); only rank 0 writes."""
    device = resolve_device(device)
    primary = mesh is None or not dist.is_initialized() or dist.get_rank() == 0
    os.makedirs(output_dir, exist_ok=True)
    written: List[str] = []
    pending: List[tuple] = []
    processed = 0

    def out_path(p):
        return os.path.join(output_dir,
                            os.path.splitext(os.path.basename(p))[0] + ".npy")

    def flush(batch):
        if not batch:
            return
        clips = [c for _, c in batch]
        while len(clips) < batch_size:        # pad a partial batch
            clips.append(clips[-1])
        zs = invert_video_iterative(
            params, state, np.stack(clips), cfg, icfg,
            num_initial_steps=num_initial_steps,
            num_steps_per_frame=num_steps_per_frame,
            post_initial_lr_decay=post_initial_lr_decay, seed=seed,
            device=device, mesh=mesh)                     # (T, V, z_dim)
        for i, (path, clip) in enumerate(batch):
            traj = zs[:, i, :]
            written.append(out_path(path))
            if not primary:
                continue
            np.save(out_path(path), traj)
            if write_comparisons:
                _write_comparison(params, state, cfg, traj, clip,
                                  out_path(path)[:-4] + "_comparison.gif",
                                  device)

    for path in clip_paths:
        if stop_after is not None and processed >= stop_after:
            break
        if os.path.exists(out_path(path)):     # resume
            continue
        clip = load_clip(path)
        if clip is None:
            print(f"skipping undecodable/short clip {path}")
            continue
        if pending and clip.shape != pending[0][1].shape:
            print(f"skipping {path}: shape {clip.shape} != batch shape "
                  f"{pending[0][1].shape}")
            continue
        pending.append((path, clip))
        processed += 1
        if len(pending) == batch_size:
            flush(pending)
            pending = []
    flush(pending)
    return written


def _write_comparison(params, state, cfg, traj: np.ndarray,
                      clip: np.ndarray, out_path: str, device) -> None:
    recon = dcgan.sample(dcgan.to_device(params, device),
                         dcgan.to_device(state, device),
                         torch.as_tensor(traj, device=device), cfg)
    side = np.concatenate([clip, recon.cpu().numpy()], axis=2)
    write_gif(out_path, denorm_u8(side))      # target | reconstruction
