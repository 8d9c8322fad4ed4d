"""Batched Shi-Tomasi corners + pyramidal Lucas-Kanade flow on the card.

The port of gifgan_tpu/kernels/flow.py, function for function. What
changes with the hardware:

  * window sampling is a direct bilinear gather with the same clamps; the
    JAX package's one-hot selector matmuls exist because gathers serialize
    on a TPU;
  * the LK iteration always goes through `lk_refine` (kernels/flow_refine.py,
    K4): the CUDA kernel on the card, its plain version on the CPU, one call
    per pyramid level for all pairs;
  * the convolutions stay library calls (F.conv2d), as XLA runs them in the
    JAX package, in full float32 (TF32 off).

Everything is batched over image pairs: the stabilizer's (prev_crop, crop)
pairs stack into one (B, H, W) call. Parity with the JAX package is held by
tests/test_torch_flow.py; parity with OpenCV is statistical, as for the JAX
package (3 px on tracked points).
"""

from __future__ import annotations

import functools
import threading
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.kernels.flow_refine import bilinear_windows, lk_refine

_tf32_lock = threading.Lock()


# ---------------------------------------------------------------------------
# shared small ops (batched over leading B)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _filter(name: str, size: int, device: torch.device) -> torch.Tensor:
    """The (kh, kw) filter `name` on `device`. Cached: a fresh host-to-device
    copy per convolution would stall the stream a dozen times per flow
    call."""
    if name == "box":
        k = torch.ones((size, size))
    elif name == "pyr":
        k = torch.tensor([1., 4., 6., 4., 1.])
        k = torch.outer(k, k) / 256.0
    else:
        k = torch.tensor([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]]) / 8.0
        k = k.T if name == "sobel_y" else k
    return k.contiguous().to(device)


def _conv2_b(imgs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, W) x (kh, kw) SAME cross-correlation (odd kernels), in full
    float32: corner responses are compared for equality and against a
    relative threshold, which TF32's 10-bit mantissa would blur."""
    pad = (k.shape[0] // 2, k.shape[1] // 2)
    if not imgs.is_cuda:
        return F.conv2d(imgs[:, None], k[None, None], padding=pad)[:, 0]
    with _tf32_lock:     # the flag is process-wide; flow may run on threads
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return F.conv2d(imgs[:, None], k[None, None], padding=pad)[:, 0]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32


def _sobel(imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (_conv2_b(imgs, _filter("sobel_x", 3, imgs.device)),
            _conv2_b(imgs, _filter("sobel_y", 3, imgs.device)))


def _pyr_down_b(imgs: torch.Tensor) -> torch.Tensor:
    return _conv2_b(imgs, _filter("pyr", 5, imgs.device))[:, ::2, ::2]


def sample_windows(img: torch.Tensor, pts: torch.Tensor,
                   win: int) -> torch.Tensor:
    """Bilinear windows around pts. img (H, W) with pts (K, 2) [x, y]
    window centres -> (K, win, win); or a stack, img (B, H, W) with pts
    (B, K, 2) -> (B, K, win, win). out[k, i, j] = bilinear(img,
    y = pts[k, 1] + i - r, x = pts[k, 0] + j - r), r = win // 2."""
    if img.ndim == 2:
        return bilinear_windows(img[None], pts[None], win)[0]
    return bilinear_windows(img, pts, win)


def pyramid_levels(h: int, w: int, win: int, levels: int) -> int:
    """How many pyramid levels lk_flow_batch runs on (h, w) images: it stops
    halving once the smaller side is under two windows."""
    n = 1
    for _ in range(levels - 1):
        if min(h, w) < 2 * win:
            break
        h, w = -(-h // 2), -(-w // 2)
        n += 1
    return n


# ---------------------------------------------------------------------------
# batched Shi-Tomasi
# ---------------------------------------------------------------------------

def shi_tomasi_corners_batch(imgs: torch.Tensor, max_corners: int = 200,
                             quality: float = 0.01, min_distance: int = 8,
                             block_size: int = 7,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corners for a stack of grayscale images.

    imgs: (B, H, W). Returns (pts (B, max_corners, 2) [x, y] f32,
    valid (B, max_corners) bool). Same semantics as goodFeaturesToTrack:
    min-eigenvalue response, quality-relative threshold, grid-cell NMS."""
    imgs = imgs.to(torch.float32)
    b, h, w = imgs.shape
    ix, iy = _sobel(imgs)
    box = _filter("box", block_size, imgs.device)
    sxx = _conv2_b(ix * ix, box)
    syy = _conv2_b(iy * iy, box)
    sxy = _conv2_b(ix * iy, box)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    resp = tr / 2.0 - torch.sqrt((tr * tr / 4.0 - det).clamp(min=0.0))

    m = block_size
    rows = torch.arange(h, device=imgs.device)[:, None]
    cols = torch.arange(w, device=imgs.device)[None, :]
    border = (rows >= m) & (rows < h - m) & (cols >= m) & (cols < w - m)
    zero = torch.zeros((), device=imgs.device)
    resp = torch.where(border[None], resp, zero)

    cell = max(int(min_distance), 1)
    ph, pw = (-h) % cell, (-w) % cell
    rp = F.pad(resp, (0, pw, 0, ph))
    hh, ww = rp.shape[1:]
    cmax = rp.reshape(b, hh // cell, cell, ww // cell, cell).amax((2, 4))
    is_max = rp == cmax.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    resp = torch.where(is_max[:, :h, :w], resp, zero)

    thresh = quality * resp.amax((1, 2), keepdim=True)
    resp = torch.where(resp > thresh, resp, zero)

    # a stable sort breaks ties towards the lower index, as lax.top_k does;
    # torch.topk leaves the order of ties open
    vals, idx = torch.sort(resp.reshape(b, -1), dim=1, descending=True,
                           stable=True)
    vals, idx = vals[:, :max_corners], idx[:, :max_corners]
    if idx.shape[1] < max_corners:     # fewer pixels than corner slots
        fill = max_corners - idx.shape[1]
        vals, idx = F.pad(vals, (0, fill)), F.pad(idx, (0, fill))
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    return torch.stack([xs, ys], dim=-1), vals > 0.0


# ---------------------------------------------------------------------------
# batched pyramidal LK
# ---------------------------------------------------------------------------

def _lk_system(i0: torch.Tensor, pts: torch.Tensor, win: int):
    """Gradient windows of i0 at pts and their 2x2 normal matrix:
    (gxw, gyw, a11, a12, a22, det)."""
    ix, iy = _sobel(i0)
    gxw = bilinear_windows(ix, pts, win)
    gyw = bilinear_windows(iy, pts, win)
    a11 = (gxw * gxw).sum((-1, -2))
    a12 = (gxw * gyw).sum((-1, -2))
    a22 = (gyw * gyw).sum((-1, -2))
    return gxw, gyw, a11, a12, a22, a11 * a22 - a12 * a12


def lk_flow_batch(img0s: torch.Tensor, img1s: torch.Tensor,
                  pts: torch.Tensor, valid: torch.Tensor, win: int = 15,
                  levels: int = 3, iters: int = 10,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track pts (B, K, 2) from img0s to img1s, (B, H, W) each.

    Returns (new_pts (B, K, 2), status (B, K) bool). Coarse-to-fine, fixed
    window and iteration count; each level's iteration is one `lk_refine`
    call over all pairs."""
    img0s = img0s.to(torch.float32)
    img1s = img1s.to(torch.float32)
    pyr0, pyr1 = [img0s], [img1s]
    for _ in range(pyramid_levels(*img0s.shape[1:], win, levels) - 1):
        pyr0.append(_pyr_down_b(pyr0[-1]))
        pyr1.append(_pyr_down_b(pyr1[-1]))

    flow = torch.zeros_like(pts)
    for lvl in range(len(pyr0) - 1, -1, -1):
        scale = 2.0 ** lvl
        p_lvl = (pts / scale).contiguous()
        i0 = pyr0[lvl]
        t0 = bilinear_windows(i0, p_lvl, win)
        gxw, gyw, a11, a12, a22, det = _lk_system(i0, p_lvl, win)
        amat = torch.stack([a11, a12, a22, det], dim=-1)
        f = lk_refine(pyr1[lvl], t0, gxw, gyw, amat, p_lvl,
                      (flow / scale).contiguous(), win=win, iters=iters)
        flow = f * scale

    new_pts = pts + flow
    h, w = img0s.shape[1:]
    inb = ((new_pts[..., 0] >= 0) & (new_pts[..., 0] <= w - 1)
           & (new_pts[..., 1] >= 0) & (new_pts[..., 1] <= h - 1))
    # det is level 0's: the JAX package recomputes it there from the same
    # image and points
    return new_pts, valid & inb & (det > 1e-6)


# ---------------------------------------------------------------------------
# drop-in stabilizer backend (single pair; batching happens via flow_pairs)
# ---------------------------------------------------------------------------

def _pad_pair(prev_crop: np.ndarray, crop: np.ndarray):
    """Pad both crops to a common multiple-of-32 shape, the JAX package's
    shape buckets, kept so both packages see the same zero margins."""
    h = max(prev_crop.shape[0], crop.shape[0])
    w = max(prev_crop.shape[1], crop.shape[1])
    hb, wb = -(-h // 32) * 32, -(-w // 32) * 32

    def pad(img):
        return np.pad(img.astype(np.float32),
                      ((0, hb - img.shape[0]), (0, wb - img.shape[1])))

    return pad(prev_crop), pad(crop)


def flow_pairs(prev_crops: np.ndarray, crops: np.ndarray,
               max_corners: int = 200, quality: float = 0.01,
               min_distance: float = 8.0, block_size: int = 7,
               win_size: int = 15, max_level: int = 3, device=None):
    """Batched corner+flow over stacked pairs (B, H, W) -> host arrays
    (pts (B, K, 2), new_pts (B, K, 2), status (B, K), n_corners (B,))."""
    device = resolve_device(device)
    prev = torch.as_tensor(prev_crops, dtype=torch.float32).to(device)
    cur = torch.as_tensor(crops, dtype=torch.float32).to(device)
    pts, valid = shi_tomasi_corners_batch(prev, max_corners, quality,
                                          int(min_distance), block_size)
    new_pts, status = lk_flow_batch(prev, cur, pts, valid, win=win_size,
                                    levels=max_level)
    return (pts.cpu().numpy(), new_pts.cpu().numpy(), status.cpu().numpy(),
            valid.sum(dim=1).cpu().numpy())


def mxu_flow_backend(prev_crop: np.ndarray, crop: np.ndarray,
                     max_corners: int = 200, quality: float = 0.01,
                     min_distance: float = 8.0, block_size: int = 7,
                     win_size: int = 15, max_level: int = 3, device=None,
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Drop-in for stabilize.cv2_flow_backend on the device kernels. It
    keeps the JAX package's name ("mxu" is also the flow_backend value that
    selects it in TrackConfig)."""
    if min(prev_crop.shape[:2]) <= block_size + 2 or \
            min(crop.shape[:2]) <= block_size + 2:
        return np.zeros((0, 2)), np.zeros((0, 2)), 0
    p0, p1 = _pad_pair(prev_crop, crop)
    pts, new_pts, status, n_corners = flow_pairs(
        p0[None], p1[None], max_corners, quality, min_distance,
        block_size, win_size, max_level, device=device)
    h, w = prev_crop.shape[:2]
    ok = (status[0] & (pts[0, :, 0] < w - 1) & (pts[0, :, 1] < h - 1))
    return pts[0][ok], new_pts[0][ok], int(n_corners[0])
