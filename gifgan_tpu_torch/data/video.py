"""Host-side video/GIF IO: the port of gifgan_tpu/data/video.py.

Decode stays on the host (the card cannot read a GIF or an mp4): decode
workers produce uint8 clip arrays, and the resize + normalize transform runs
on the card (kernels/resize.py, K2), in `read_gif(size=...)` and
`sample_frames_from_video` on GIFs here and in the streaming feed
(data/loader.py). GIFs go through the shared native codec
(data/native_gif.py); the mp4 and avi functions need cv2, which is imported
when they are called and is never used to resize a GIF. Frames are written
as PNGs by ops/image.py write_png (zlib only).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

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
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write mp4v to {path}: no mp4 "
                           "encoder in this build")
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


def sample_frames_from_video(path: str, n: int, size: int,
                             rng: np.random.Generator,
                             device=None) -> List[np.ndarray]:
    """Randomly sample n frames (by index) resized to (size, size): the
    image-DCGAN training-set builder (reference sample_frames.py:19-37).

    A GIF is decoded by the native decoder, its indices drawn from the
    decoded count, and the chosen frames resized together on `device` by
    resize_u8 (K2 on the card; within one grey level of cv2.INTER_LINEAR).
    Other videos go through cv2 as in the JAX package: indices from
    CAP_PROP_FRAME_COUNT, frames resized by cv2.INTER_LINEAR."""
    if path.lower().endswith(".gif"):
        device = resolve_device(device)
        frames = native_gif.decode_gif(path)
        total = len(frames)
        if total <= 0:
            return []
        idxs = sorted(rng.choice(total, size=min(n, total), replace=False))
        picked = frames[np.asarray(idxs, np.int64)]
        if picked.shape[1:3] != (size, size):
            picked = resize_u8(picked, size, device)
        return list(picked)
    cv2 = _cv2("video decode")
    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        cap.release()
        return []
    idxs = sorted(rng.choice(total, size=min(n, total), replace=False))
    out = []
    pos = 0
    want = set(int(i) for i in idxs)
    while cap.isOpened() and pos <= max(want):
        ret, im = cap.read()
        if not ret:
            break
        if pos in want:
            im = cv2.resize(im, (size, size), interpolation=cv2.INTER_LINEAR)
            out.append(cv2.cvtColor(im, cv2.COLOR_BGR2RGB))
        pos += 1
    cap.release()
    return out


def bulk_resize(in_dir: str, out_dir: str, width: int, length: int,
                pattern: str = ".mp4") -> dict:
    """Re-encode every video in a dir to width x width and exactly `length`
    frames, skipping short clips (reference bulk_resize.py:38-64). Returns
    counts; a file that fails to decode counts as an error, as in the JAX
    package, but a missing cv2 raises before any file is read."""
    _cv2("mp4 decode")
    os.makedirs(out_dir, exist_ok=True)
    stats = {"written": 0, "skipped_short": 0, "errors": 0}
    for name in sorted(os.listdir(in_dir)):
        if not name.endswith(pattern):
            continue
        try:
            clip = decode_clip(os.path.join(in_dir, name), length, width,
                               strict=True)
        except ClipTooShortError:
            stats["skipped_short"] += 1
            continue
        except Exception:
            stats["errors"] += 1
            continue
        encode_mp4(os.path.join(out_dir, name), clip)
        stats["written"] += 1
    return stats


def video_to_frames(video_path: str, out_dir: str, rate: float,
                    detector=None, crop_size: int = 108,
                    prefix: str = "frame") -> dict:
    """Extract frames at `rate` fps through cv2; with a detector (called as
    detector(rgb_frame, frame_index) -> Detections, e.g. a
    DeviceHaarDetector), keep only frames with a face and crop a fixed
    crop_size box around the biggest face's centre (reference
    video_to_frames.py:53-91). PNGs through ops/image.py write_png."""
    from gifgan_tpu_torch.ops.image import write_png

    cv2 = _cv2("video decode")
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    step = max(1, int(round(fps / rate)))
    stats = {"frames": 0, "kept": 0, "no_face": 0}
    i = out_i = 0
    while cap.isOpened():
        ret, im = cap.read()
        if not ret:
            break
        if i % step == 0:
            stats["frames"] += 1
            rgb = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
            keep = rgb
            if detector is not None:
                dets = detector(rgb, i)
                if not dets:
                    stats["no_face"] += 1
                    i += 1
                    continue
                best = max(dets, key=lambda d: d.width * d.height)
                cx = (best.x1 + best.x2) // 2
                cy = (best.y1 + best.y2) // 2
                half = crop_size // 2
                y0 = min(max(cy - half, 0), max(rgb.shape[0] - crop_size, 0))
                x0 = min(max(cx - half, 0), max(rgb.shape[1] - crop_size, 0))
                keep = rgb[y0:y0 + crop_size, x0:x0 + crop_size]
            write_png(os.path.join(out_dir, f"{prefix}_{out_i:06d}.png"),
                      keep)
            out_i += 1
            stats["kept"] += 1
        i += 1
    cap.release()
    return stats
