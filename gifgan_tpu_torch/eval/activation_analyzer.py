"""Discriminator-activation-space distance analysis
(gifgan_tpu/eval/activation_analyzer.py): is the image-D h2 activation
space a useful video metric? It compares INTRA-video and INTER-video
pairwise L2 distances of the h2 tap over frames sampled from many videos,
skipping near-duplicate frames within a video.

All frames go through the discriminator in one batch on the device, and the
whole distance matrix is one |a|^2 + |b|^2 - 2ab Gram product.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device


def _pairwise_l2(flat: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(flat * flat, dim=1)
    gram = flat @ flat.T
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    return torch.sqrt(torch.clamp(d2, min=0.0))


def activation_distances(params, state, cfg,
                         videos: Sequence[np.ndarray],
                         frames_per_video: int = 4,
                         seed: int = 0,
                         dedup_atol: float = 1e-6,
                         device=None) -> Dict:
    """videos: list of (T, s, s, c) float arrays in [-1, 1] at model
    resolution; params/state: an image GAN's {"generator",
    "discriminator"} trees. Returns {"intra": [...], "inter": [...],
    "summary": {...}}."""
    from gifgan_tpu_torch.models import dcgan

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    frames, vid_ids = [], []
    for vid_id, vid in enumerate(videos):
        t = vid.shape[0]
        idxs = rng.choice(t, size=min(frames_per_video, t), replace=False)
        picked = []
        for i in sorted(idxs):
            f = np.asarray(vid[i])
            # skip near-duplicate frames within a video
            if any(np.allclose(f, p, atol=dedup_atol) for p in picked):
                continue
            picked.append(f)
        frames.extend(picked)
        vid_ids.extend([vid_id] * len(picked))

    batch = torch.as_tensor(np.stack(frames).astype(np.float32),
                            device=device)
    with torch.no_grad():
        acts, _ = dcgan.discriminator_tap(
            dcgan.to_device(params["discriminator"], device),
            dcgan.to_device(state["discriminator"], device), batch, cfg,
            train=False)
        flat = acts.reshape(acts.shape[0], -1)
        dist = _pairwise_l2(flat).float().cpu().numpy()

    ids = np.asarray(vid_ids)
    same = ids[:, None] == ids[None, :]
    upper = np.triu(np.ones_like(same, dtype=bool), k=1)
    intra = dist[same & upper]
    inter = dist[~same & upper]
    return {
        "intra": intra,
        "inter": inter,
        "summary": {
            "intra_mean": float(intra.mean()) if intra.size else None,
            "inter_mean": float(inter.mean()) if inter.size else None,
            "separation": (float(inter.mean() / intra.mean())
                           if intra.size and inter.size and intra.mean() > 0
                           else None),
            "n_frames": int(len(frames)),
        },
    }


def write_distance_lists(result: Dict, out_prefix: str) -> None:
    """Text dumps for offline histogramming."""
    for kind in ("intra", "inter"):
        with open(f"{out_prefix}_{kind}.txt", "w") as f:
            for v in result[kind]:
                f.write(f"{v}\n")
