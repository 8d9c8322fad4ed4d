"""Shi-Tomasi corners + pyramidal Lucas-Kanade flow by direct gathers: the
port of gifgan_tpu/track/flow_jax.py, the stabilizer's flow for
`flow_backend="jax"` (the value keeps the JAX package's name so params.json
files cross between the packages).

Plain PyTorch on the device, no hand-written kernel: the JAX module is XLA
code, not Pallas. It differs from kernels/flow.py (the "auto"/"mxu" flow,
whose LK iteration is the CUDA kernel K4) in its sampling and its buckets,
and those details are reproduced here, not borrowed:

  * `_bilinear` clamps the base pixel x0 to [0, w-2] and the fraction to
    [0, 1] per sample, so a window past the edge extrapolates the edge
    pixels (kernels/flow.py shifts the whole window inside the image);
  * the pyramid stops once the smaller side is under two windows;
  * `det > 1e-6` guards the solve and the final status, the latter
    recomputed at full resolution;
  * `gather_flow_backend` pads the previous crop to multiples of 16 and pads
    or clips the current crop to that shape, then drops corners that fell
    into the padding.

The convolutions (Sobel, the 5x5 pyramid filter) and the corner detector are
kernels/flow.py's, which compute flow_jax's SAME cross-correlations for the
odd kernels used here in full float32 (tests/test_torch_flow_gather.py holds
them equal).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.kernels import flow as kflow


def shi_tomasi_corners(img: torch.Tensor, max_corners: int = 200,
                       quality: float = 0.01, min_distance: int = 8,
                       block_size: int = 7,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner points of a grayscale (H, W) image: (pts (max_corners, 2)
    float32 [x, y], valid (max_corners,) bool). Min-eigenvalue response,
    border and grid-cell suppression, quality-relative threshold; ties go
    to the lower pixel index, as lax.top_k orders them."""
    pts, valid = kflow.shi_tomasi_corners_batch(
        img[None], max_corners, quality, int(min_distance), block_size)
    return pts[0], valid[0]


def _bilinear(img: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """img (H, W) sampled at float coordinates x, y of any one shape."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(x), 0, w - 2)
    y0 = torch.clamp(torch.floor(y), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    x0i, y0i = x0.long(), y0.long()
    g00 = img[y0i, x0i]
    g01 = img[y0i, x0i + 1]
    g10 = img[y0i + 1, x0i]
    g11 = img[y0i + 1, x0i + 1]
    return (g00 * (1 - fx) * (1 - fy) + g01 * fx * (1 - fy)
            + g10 * (1 - fx) * fy + g11 * fx * fy)


def _gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    ix, iy = kflow._sobel(img[None])
    return ix[0], iy[0]


def _window_sums(gxw: torch.Tensor, gyw: torch.Tensor):
    a11 = (gxw * gxw).sum((1, 2))
    a12 = (gxw * gyw).sum((1, 2))
    a22 = (gyw * gyw).sum((1, 2))
    return a11, a12, a22, a11 * a22 - a12 * a12


def lk_flow(img0: torch.Tensor, img1: torch.Tensor, pts: torch.Tensor,
            valid: torch.Tensor, win: int = 15, levels: int = 3,
            iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal LK: track pts (K, 2) from img0 to img1, (H, W) each.

    Returns (new_pts (K, 2), status (K,) bool). Fixed window, fixed
    iterations, coarse-to-fine over at most `levels` pyramid levels."""
    img0 = img0.to(torch.float32)
    img1 = img1.to(torch.float32)
    pyr0, pyr1 = [img0], [img1]
    for _ in range(levels - 1):
        if min(pyr0[-1].shape) < 2 * win:
            break
        pyr0.append(kflow._pyr_down_b(pyr0[-1][None])[0])
        pyr1.append(kflow._pyr_down_b(pyr1[-1][None])[0])

    r = win // 2
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=img0.device)
    gy, gx = torch.meshgrid(d, d, indexing="ij")     # window offsets

    flow = torch.zeros_like(pts)
    for lvl in range(len(pyr0) - 1, -1, -1):
        scale = 2.0 ** lvl
        p_lvl = pts / scale
        f = flow / scale
        i0, i1 = pyr0[lvl], pyr1[lvl]
        ix, iy = _gradients(i0)
        # fixed windows around each point in img0: (K, win, win)
        wx = p_lvl[:, 0, None, None] + gx[None]
        wy = p_lvl[:, 1, None, None] + gy[None]
        t0 = _bilinear(i0, wx, wy)
        gxw = _bilinear(ix, wx, wy)
        gyw = _bilinear(iy, wx, wy)
        a11, a12, a22, det = _window_sums(gxw, gyw)
        ok = det > 1e-6
        den = torch.clamp(det, min=1e-6)
        zero = torch.zeros((), device=img0.device)
        for _ in range(iters):
            t1 = _bilinear(i1, wx + f[:, 0, None, None],
                           wy + f[:, 1, None, None])
            dt = t1 - t0
            b1 = -(dt * gxw).sum((1, 2))
            b2 = -(dt * gyw).sum((1, 2))
            du = torch.where(ok, (a22 * b1 - a12 * b2) / den, zero)
            dv = torch.where(ok, (a11 * b2 - a12 * b1) / den, zero)
            f = f + torch.stack([du, dv], dim=1)
        flow = f * scale

    new_pts = pts + flow
    h, w = img0.shape
    inb = ((new_pts[:, 0] >= 0) & (new_pts[:, 0] <= w - 1)
           & (new_pts[:, 1] >= 0) & (new_pts[:, 1] <= h - 1))
    # final structure-tensor validity at full resolution
    ix, iy = _gradients(img0)
    wx = pts[:, 0, None, None] + gx[None]
    wy = pts[:, 1, None, None] + gy[None]
    det = _window_sums(_bilinear(ix, wx, wy), _bilinear(iy, wx, wy))[3]
    return new_pts, valid & inb & (det > 1e-6)


def _pad16(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    return np.pad(img.astype(np.float32), ((0, (-h) % 16), (0, (-w) % 16)))


def gather_flow_backend(prev_crop: np.ndarray, crop: np.ndarray,
                        max_corners: int = 200, quality: float = 0.01,
                        min_distance: float = 8.0, block_size: int = 7,
                        win_size: int = 15, max_level: int = 3,
                        device=None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Drop-in for stabilize.cv2_flow_backend on `device` (the card by
    default): (pts0, pts1) of the tracked corners and the corner count."""
    if min(prev_crop.shape[:2]) <= block_size + 2 or \
            min(crop.shape[:2]) <= block_size + 2:
        return np.zeros((0, 2)), np.zeros((0, 2)), 0
    device = resolve_device(device)
    p0 = _pad16(prev_crop)
    ph, pw = p0.shape
    p1 = np.pad(crop.astype(np.float32),
                ((0, max(ph - crop.shape[0], 0)),
                 (0, max(pw - crop.shape[1], 0))))[:ph, :pw]
    t0 = torch.as_tensor(p0).to(device)
    t1 = torch.as_tensor(p1).to(device)
    pts, valid = shi_tomasi_corners(t0, max_corners, quality,
                                    int(min_distance), block_size)
    new_pts, status = lk_flow(t0, t1, pts, valid, win=win_size,
                              levels=max_level)
    # exclude corners that fell into the padding region
    h, w = prev_crop.shape[:2]
    pts_np, new_np = pts.cpu().numpy(), new_pts.cpu().numpy()
    ok = (status.cpu().numpy() & (pts_np[:, 0] < w - 1)
          & (pts_np[:, 1] < h - 1))
    return pts_np[ok], new_np[ok], int(valid.sum())
