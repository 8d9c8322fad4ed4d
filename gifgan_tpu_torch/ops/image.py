"""Image transforms (gifgan_tpu/ops/image.py:15-56) and the sample-grid
PNG encoder.

The transforms take tensors and return tensors on the same device;
`resize_bilinear` is jax.image.resize(..., "linear") with its weights,
which low-pass filter on a downscale (a triangle widened by the scale),
not F.interpolate's two-tap bilinear. `encode_png` needs only zlib and
struct: the card's machine has no imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def transform(x: torch.Tensor) -> torch.Tensor:
    """uint8/float [0, 255] -> float32 [-1, 1]."""
    return x.to(torch.float32) / 127.5 - 1.0


def inverse_transform(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return (x + 1.0) / 2.0


def center_crop(x, crop_h: int, crop_w: int | None = None):
    """Centre crop of an H x W (x C) image."""
    crop_w = crop_w or crop_h
    h, w = x.shape[0], x.shape[1]
    j = int(round((h - crop_h) / 2.0))
    i = int(round((w - crop_w) / 2.0))
    return x[j:j + crop_h, i:i + crop_w]


def _weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) float32 weights of jax.image's linear resize along one
    axis (jax/_src/image/scale.py compute_weight_mat, antialias on)."""
    inv = 1.0 / (n_out / n_in)
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C) float32, half-pixel centres,
    antialiased on a downscale, as jax.image.resize(..., "linear")."""
    x = x.to(torch.float32)
    h, w = x.shape[-3], x.shape[-2]
    if out_h != h:
        x = torch.einsum("...hwc,ho->...owc", x,
                         _weights(h, out_h).to(x.device))
    if out_w != w:
        x = torch.einsum("...hwc,wo->...hoc", x,
                         _weights(w, out_w).to(x.device))
    return x


def merge_grid(images: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(N, H, W, C) -> (rows*H, cols*W, C); missing tiles are zeros."""
    n, h, w, c = images.shape
    if n < rows * cols:
        pad = images.new_zeros((rows * cols - n, h, w, c))
        images = torch.cat([images, pad], dim=0)
    grid = images[:rows * cols].reshape(rows, cols, h, w, c)
    return grid.permute(0, 2, 1, 3, 4).reshape(rows * h, cols * w, c)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8, rounded half to even, clipped."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def denorm_u8(x) -> np.ndarray:
    """[-1, 1] float -> uint8 numpy: round((x + 1) * 127.5), clipped.

    A tensor is converted where it lies (on the card only the uint8 result
    crosses to the host, a quarter of the float bytes)."""
    if isinstance(x, torch.Tensor):
        y = torch.round((x.detach().float() + 1.0) * 127.5).clamp_(0, 255)
        return y.to(torch.uint8).cpu().numpy()
    x = np.asarray(x)
    return np.clip(np.round((x + 1.0) * 127.5), 0, 255).astype(np.uint8)


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, C) uint8, C in {1, 3, 4} (or (H, W)) -> the bytes of an 8-bit
    PNG (no filtering)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          image.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """`image` as a PNG file (encode_png)."""
    with open(path, "wb") as f:
        f.write(encode_png(image))
