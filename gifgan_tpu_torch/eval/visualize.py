"""Per-dimension z-sweep sampling grids (gifgan_tpu/eval/visualize.py), the
reference's `visualize` modes; `sample_fn(z) -> (B, s, s, c)` in [-1, 1],
numpy or tensor.

Modes (the reference's option numbers):
  0: one random-z batch -> 8x8 grid png
  1: for each latent dim, sweep 0..1 across the batch with all other dims
     zero -> one grid png per dim
  2: random base z ~ U[-0.2, 0.2] tiled over the batch, sweep randomly
     chosen dims -> one GIF per dim
  3: like 1 but rendered as a GIF per dim
  4: like 3, plus a merged "bounce" GIF of grids animating over the
     batch (sweep) index forward then backward

Grids are written by ops/image.py write_png, GIFs by the native encoder.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch

from gifgan_tpu_torch.data.video import write_gif
from gifgan_tpu_torch.ops.image import (denorm_u8, inverse_transform,
                                        merge_grid, write_png)


def _samples(sample_fn: Callable, z: np.ndarray) -> np.ndarray:
    out = sample_fn(z)
    if isinstance(out, torch.Tensor):
        return out.detach().float().cpu().numpy()
    return np.asarray(out)


def _grid_u8(samples: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(N, s, s, c) [-1, 1] -> a rows x cols grid, uint8 by truncation of
    [0, 1] * 255 (as the reference writes it)."""
    grid = merge_grid(inverse_transform(torch.from_numpy(
        np.ascontiguousarray(samples, np.float32))), rows, cols).numpy()
    return (np.clip(grid, 0, 1) * 255).astype(np.uint8)


def _grid_png(samples: np.ndarray, path: str, rows: int = 8, cols: int = 8):
    b = samples.shape[0]
    cols = min(cols, b)
    rows = min(rows, -(-b // cols))
    write_png(path, _grid_u8(samples[:rows * cols], rows, cols))


def _sweep_z(batch_size: int, z_dim: int, idx: int,
             base: Optional[np.ndarray] = None) -> np.ndarray:
    values = np.arange(0, 1, 1.0 / batch_size)
    z = np.zeros((batch_size, z_dim), np.float32) if base is None \
        else np.tile(base, (batch_size, 1)).astype(np.float32)
    z[:, idx] = values
    return z


def visualize(sample_fn: Callable, z_dim: int, batch_size: int, option: int,
              out_dir: str, num_dims: Optional[int] = None,
              seed: int = 0) -> List[str]:
    """Run one reference visualize mode; returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    num_dims = num_dims if num_dims is not None else min(100, z_dim)
    written = []

    if option == 0:
        z = rng.uniform(-1, 1, (batch_size, z_dim)).astype(np.float32)
        p = os.path.join(out_dir, "test_random.png")
        _grid_png(_samples(sample_fn, z), p)
        written.append(p)
        return written

    if option == 2:
        dims = rng.integers(0, z_dim, size=num_dims)
        base = rng.uniform(-0.2, 0.2, size=z_dim)
    else:
        dims = np.arange(num_dims)
        base = None

    image_set = []
    for idx in dims:
        z = _sweep_z(batch_size, z_dim, int(idx), base)
        samples = _samples(sample_fn, z)
        if option == 1:
            p = os.path.join(out_dir, f"test_arange_{idx}.png")
            _grid_png(samples, p)
        else:
            p = os.path.join(out_dir, f"test_gif_{idx}.gif")
            write_gif(p, denorm_u8(samples), fps=8.0)
            if option == 4:
                image_set.append(samples)
        written.append(p)

    if option == 4 and image_set:
        # bounce over the sweep index: frame k = a grid of (dim, k)
        k_max = min(batch_size, image_set[0].shape[0])
        order = list(range(k_max)) + list(range(k_max - 1, -1, -1))
        side = int(np.ceil(np.sqrt(len(image_set))))
        grids = [_grid_u8(np.stack([s[k] for s in image_set]), side, side)
                 for k in order]
        p = os.path.join(out_dir, "test_gif_merged.gif")
        write_gif(p, np.stack(grids), fps=8)
        written.append(p)
    return written
