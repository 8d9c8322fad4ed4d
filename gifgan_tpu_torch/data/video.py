"""Host-side video/GIF IO (the port of gifgan_tpu/data/video.py's clip
readers and writers).

Decode stays on the host (the card cannot read a GIF or an mp4): decode
workers produce uint8 clip arrays, and the resize + normalize transform runs
on the card (kernels/resize.py, K2), in `read_gif(size=...)` here and in the
streaming feed (data/loader.py). GIFs go through the shared native codec
(data/native_gif.py); the mp4 functions need cv2, which is imported when
they are called and is never used to resize a GIF.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.data import native_gif


class ClipTooShortError(ValueError):
    pass


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"cv2 unavailable: no {what} on this host") from e
    return cv2


def decode_clip(path: str, length: int, size: Optional[int],
                strict: bool = True) -> np.ndarray:
    """Decode the first `length` frames of a video with cv2, resized to
    (size, size), RGB uint8: (length, size, size, 3). size=None keeps the
    source size (the streaming feed resizes on the card instead).

    strict=True raises ClipTooShortError on short clips; strict=False pads
    by repeating the last frame."""
    cv2 = _cv2("mp4 decode")
    cap = cv2.VideoCapture(path)
    frames = []
    while cap.isOpened() and len(frames) < length:
        ret, im = cap.read()
        if not ret:
            break
        if size is not None:
            im = cv2.resize(im, (size, size), interpolation=cv2.INTER_LINEAR)
        frames.append(cv2.cvtColor(im, cv2.COLOR_BGR2RGB))
    cap.release()
    if len(frames) < length:
        if strict or not frames:
            raise ClipTooShortError(
                f"{path}: {len(frames)} frames < {length}")
        frames.extend([frames[-1]] * (length - len(frames)))
    return np.stack(frames[:length])


def decode_clip_batch(paths: Sequence[str], length: int, size: int,
                      strict: bool = True) -> np.ndarray:
    """(N, length, size, size, 3) uint8."""
    return np.stack([decode_clip(p, length, size, strict) for p in paths])


def encode_mp4(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """frames: (T, H, W, 3) uint8 RGB -> mp4 (fourcc mp4v)."""
    cv2 = _cv2("mp4 encode")
    t, h, w = frames.shape[:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def write_gif(path: str, frames: np.ndarray, fps: float = 8.0,
              atomic: bool = True) -> None:
    """frames (T, H, W, 3) uint8 RGB -> GIF through the native encoder,
    atomically (tmp file + rename)."""
    native_gif.encode_gif(path, np.ascontiguousarray(frames[..., :3]),
                          fps=fps, atomic=atomic)


def resize_u8(frames: np.ndarray, size: int, device=None) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, size, size, C) uint8: the bilinear resize of
    kernels/resize.py on `device` (no normalize), rounded to nearest and
    clipped. Within one grey level of cv2.INTER_LINEAR, which rounds in
    fixed point."""
    from gifgan_tpu_torch.kernels.resize import resize_normalize

    device = resolve_device(device)
    x = torch.as_tensor(np.ascontiguousarray(frames)).to(device)
    y = resize_normalize(x, size, size, normalize=False)
    return torch.round(y).clamp(0, 255).to(torch.uint8).cpu().numpy()


def read_gif(path: str, size: Optional[int] = None,
             device=None) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB through the native decoder; with `size`,
    resized to (size, size) on `device` (resize_u8)."""
    frames = native_gif.decode_gif(path)
    if size is not None and frames.shape[1:3] != (size, size):
        frames = resize_u8(frames, size, device)
    return frames


def video_to_gif(in_path: str, out_path: str, fps: float = 8.0) -> None:
    """avi/mp4 -> GIF."""
    cv2 = _cv2("video decode")
    cap = cv2.VideoCapture(in_path)
    frames = []
    while cap.isOpened():
        ret, im = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(im, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise RuntimeError(f"could not decode {in_path}")
    write_gif(out_path, np.stack(frames), fps=fps)
