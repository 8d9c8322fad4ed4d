"""Data-derived expression paths: extracted z-trajectories -> path files.
numpy only, a copy of gifgan_tpu/demo/derive.py with its names and results.

Closes the reference's empirical loop. The reference's webcam demo consumed
demo/manual_paths/*.txt (run_webcam_demo:46-48) which were hand-curated from
z_space_finder.py outputs — real clips inverted to latent trajectories, the
expressive ones kept as animation paths. This module automates that curation:
load the per-clip (T, z_dim) .npy trajectories written by
invert/z_finder.extract_z_trajectories, rank them by expressiveness, smooth,
re-zero, and emit the top paths in the same repr'd-array .txt protocol the
webcam demo loads (`invert --input-paths` reads them with
serve/explorer.py parse_z_text).

Also derives dominant MOTION DIRECTIONS via PCA over trajectory deltas, for
use with the procedural envelope library
(demo/paths.make_expression_paths(directions=...)) — named envelopes riding
empirically observed directions instead of seeded random ones.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np


def load_trajectories(traj_dir: str) -> Dict[str, np.ndarray]:
    """{clip stem: (T, z_dim) float32} from a z_finder output directory.
    Non-2D arrays and *_comparison artifacts are skipped."""
    out: Dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(traj_dir)):
        if not name.endswith(".npy") or name.endswith("_comparison.npy"):
            continue
        try:
            arr = np.load(os.path.join(traj_dir, name))
        except (OSError, ValueError):
            continue
        if arr.ndim != 2 or arr.shape[0] < 2:
            continue
        out[name[:-4]] = np.asarray(arr, np.float32)
    return out


def score_trajectory(traj: np.ndarray, jerk_weight: float = 2.0) -> float:
    """Expressiveness score: how much the latent moves from its start,
    penalized by frame-to-frame jerkiness (second difference). An inversion
    that wandered noisily scores below one that traced a coherent motion —
    the same judgment the reference applied by eye when curating
    manual_paths from z_space_finder outputs."""
    delta = traj - traj[0]
    motion = float(np.sqrt((delta ** 2).sum(axis=1)).mean())
    if traj.shape[0] >= 3:
        jerk = float(np.sqrt((np.diff(traj, n=2, axis=0) ** 2)
                             .sum(axis=1)).mean())
    else:
        jerk = 0.0
    return motion - jerk_weight * jerk


def smooth_path(path: np.ndarray, window: int = 3) -> np.ndarray:
    """Centered moving average along time (edge-replicated), then re-zero
    frame 0 so delta application (path - path[0]) is preserved."""
    if window <= 1:
        return path - path[0]
    T = path.shape[0]
    pad = window // 2
    padded = np.concatenate([np.repeat(path[:1], pad, 0), path,
                             np.repeat(path[-1:], pad, 0)], axis=0)
    kernel = np.ones(window, np.float32) / window
    sm = np.stack([np.convolve(padded[:, d], kernel, mode="valid")
                   for d in range(path.shape[1])], axis=1)[:T]
    return (sm - sm[0]).astype(np.float32)


def derive_paths(trajs: Dict[str, np.ndarray], top_k: int = 4,
                 smooth_window: int = 3,
                 magnitude: float = 0.0,
                 jerk_weight: float = 2.0) -> Dict[str, np.ndarray]:
    """Rank trajectories by score_trajectory, take the top_k, and return
    {'data_<stem>': (T, z_dim) path} — smoothed, starting at zero, and
    (when magnitude > 0) rescaled so the largest frame-delta norm equals
    `magnitude` (matching make_expression_paths' scale conventions)."""
    ranked: List[Tuple[float, str]] = sorted(
        ((score_trajectory(t, jerk_weight), n) for n, t in trajs.items()),
        reverse=True)
    out: Dict[str, np.ndarray] = {}
    for _, name in ranked[:top_k]:
        path = smooth_path(trajs[name], smooth_window)
        if magnitude > 0:
            peak = float(np.sqrt((path ** 2).sum(axis=1)).max())
            if peak > 1e-9:
                path = path * (magnitude / peak)
        out[f"data_{name}"] = path.astype(np.float32)
    return out


def pca_directions(trajs: Dict[str, np.ndarray],
                   n_directions: int = 8) -> np.ndarray:
    """(n_directions, z_dim) orthonormal dominant motion directions: PCA of
    all per-frame deltas (z_t - z_0) pooled across clips. Feed to
    make_expression_paths(directions=...) to ride real motion axes."""
    deltas = np.concatenate([t - t[0] for t in trajs.values()], axis=0)
    deltas = deltas - deltas.mean(axis=0, keepdims=True)
    # SVD of the (frames, z_dim) delta matrix; rows of Vt = principal axes
    _, s, vt = np.linalg.svd(deltas, full_matrices=False)
    n = min(n_directions, vt.shape[0])
    return vt[:n].astype(np.float32)
