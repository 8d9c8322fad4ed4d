"""Fréchet Activation Distance (FAD): the port of gifgan_tpu/eval/fad.py.

The image discriminator's h2 tap, the (s/8, s/8, 4*df) feature map the
latent-optimization and video-GAN stack is built on, is mean-pooled over
space to a (B, 4*df) embedding; real and generated sets are compared by the
Fréchet distance between their Gaussian fits, the FID construction with the
in-domain tap in place of InceptionV3.

Feature extraction runs in batches on the device (the discriminator in
inference mode, the pool in float32 after a compute in cfg.compute_dtype);
the Gaussian fit and the Fréchet formula run on the host in float64, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import DCGANConfig
from gifgan_tpu_torch.models import dcgan


def h2_features(params: Dict, state: Dict, images: torch.Tensor,
                cfg: DCGANConfig) -> torch.Tensor:
    """(B, s, s, c) images in [-1, 1] -> (B, 4*df) pooled h2 embeddings
    (inference-mode discriminator, spatial mean pool in float32). The
    discriminator stops at its tap: the layers after it do not reach the
    features (XLA drops them from the JAX program)."""
    with torch.no_grad():
        h2, _ = dcgan.discriminator_tap(params, state, images, cfg,
                                        train=False)
        return torch.mean(h2.to(torch.float32), dim=(1, 2))


def gaussian_fit(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D)); N must be > 1."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(cov)


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray,
                     mu2: np.ndarray, cov2: np.ndarray) -> float:
    """||mu1-mu2||^2 + tr(c1 + c2 - 2 (c1 c2)^(1/2)) — the FID formula.

    The matrix square root is computed as c1^(1/2) c2 c1^(1/2) via
    symmetric eigendecompositions (eigenvalues clipped at 0 against
    numerical negatives)."""
    d2 = float(np.sum((mu1 - mu2) ** 2))
    w1, v1 = np.linalg.eigh(cov1)
    s1 = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T     # c1^(1/2)
    m = s1 @ cov2 @ s1                                    # symmetric PSD
    wm = np.clip(np.linalg.eigvalsh(m), 0, None)
    tr_sqrt = float(np.sum(np.sqrt(wm)))                  # tr((c1 c2)^(1/2))
    # clamp: identical distributions can land at ~-1e-12 in floats
    return max(0.0, d2 + float(np.trace(cov1) + np.trace(cov2))
               - 2.0 * tr_sqrt)


def embed(params: Dict, state: Dict, images: np.ndarray, cfg: DCGANConfig,
          batch: int = 256, device=None) -> np.ndarray:
    """(N, s, s, c) images in [-1, 1] -> (N, 4*df) float32 features, `batch`
    images a discriminator pass on `device` (the card by default)."""
    device = resolve_device(device)
    params = dcgan.to_device(params, device)
    state = dcgan.to_device(state, device)
    out = []
    for i in range(0, len(images), batch):
        x = torch.as_tensor(np.asarray(images[i:i + batch], np.float32),
                            device=device)
        out.append(h2_features(params, state, x, cfg).cpu().numpy())
    return np.concatenate(out)


def fad(params: Dict, state: Dict, real: np.ndarray, fake: np.ndarray,
        cfg: DCGANConfig, batch: int = 256, device=None) -> float:
    """FAD between two image sets ((N, s, s, c) in [-1, 1]) under the
    image-D h2 embedding; params/state are the discriminator's trees."""
    mu_r, cov_r = gaussian_fit(embed(params, state, real, cfg, batch,
                                     device))
    mu_f, cov_f = gaussian_fit(embed(params, state, fake, cfg, batch,
                                     device))
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)
