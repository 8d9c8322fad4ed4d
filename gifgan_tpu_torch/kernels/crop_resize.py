"""Batched crop + bilinear resize for arbitrary boxes.

The port of gifgan_tpu/kernels/crop_resize.py crop_resize_bilinear (an XLA
gather there, not a Pallas kernel; plain PyTorch indexing here): for each
output pixel, compute its source coordinate inside the box and gather its 4
neighbours, one vectorized program for any number of crops of any box sizes.

Sampling convention matches cv2.INTER_LINEAR / kernels.resize.interp_matrix:
half-pixel centers, src = (dst + 0.5) * box/out - 0.5, edge-clamped.
"""

from __future__ import annotations

import torch


def crop_resize_bilinear(frames: torch.Tensor, frame_idx: torch.Tensor,
                         boxes: torch.Tensor, target: int) -> torch.Tensor:
    """frames (T, H, W, C) any float/uint dtype; frame_idx (N,) int;
    boxes (N, 4) [y1, x1, y2, x2] INCLUSIVE pixel bounds. Returns
    (N, target, target, C) float32."""
    t, h, w, c = frames.shape
    boxes = boxes.to(torch.float32)
    bh = boxes[:, 2] - boxes[:, 0] + 1.0
    bw = boxes[:, 3] - boxes[:, 1] + 1.0

    d = (torch.arange(target, dtype=torch.float32, device=frames.device)
         + 0.5) / target                                        # (target,)
    src_y = boxes[:, 0, None] + d[None, :] * bh[:, None] - 0.5  # (N, t)
    src_x = boxes[:, 1, None] + d[None, :] * bw[:, None] - 0.5

    y0 = torch.floor(src_y).clamp(0, h - 1)
    x0 = torch.floor(src_x).clamp(0, w - 1)
    fy = (src_y - y0).clamp(0.0, 1.0)[:, :, None, None]
    fx = (src_x - x0).clamp(0.0, 1.0)[:, None, :, None]
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    fi = frame_idx.long()[:, None, None]                        # (N, 1, 1)

    def gather(yi, xi):                       # (N, t, t, C), widened after
        return frames[fi, yi[:, :, None], xi[:, None, :]].to(torch.float32)

    top = gather(y0i, x0i) * (1 - fx) + gather(y0i, x1i) * fx
    bot = gather(y1i, x0i) * (1 - fx) + gather(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy
