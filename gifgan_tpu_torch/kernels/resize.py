"""K2: fused bilinear resize + widen + [-1, 1] scale.

`resize_normalize(frames, out_h, out_w, normalize=True)` maps (N, H, W, C)
uint8 or float32 frames to (N, out_h, out_w, C) float32 — the function of the
Pallas kernel gifgan_tpu/kernels/resize.py resize_normalize (:80,
pallas_call :94) and of its reference resize_normalize_ref (:52): per
channel plane `A . X . B^T` with A and B from `interp_matrix` (cv2
INTER_LINEAR half-pixel centres, edge-clamped, no antialiasing), then
`y * (1 / 127.5) - 1` when `normalize`.

On a CUDA tensor the wrapper launches the hand-written kernel
csrc/resize_normalize.cu (bound and design are noted there: bytes-bound,
a 4-tap gather per output value from tap tables built here). On a CPU
tensor it takes the plain PyTorch version below, which the CPU tests hold
against the JAX package and the card run holds the kernel against. There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from gifgan_tpu_torch.kernels import _build

NAME = "resize_normalize"


def interp_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The bilinear taps of a resize along one axis, cv2.INTER_LINEAR
    half-pixel centers: src = (dst + 0.5) * in/out - 0.5, edge-clamped. As
    the kernel reads them: idx (out_size, 2) int32 source positions and wt
    (out_size, 2) float32 weights (computed in float64, stored as float32).
    Where the edge clamp folds both taps onto one position, the first
    carries their float32 sum and the second is zero."""
    scale = in_size / out_size
    idx = np.zeros((out_size, 2), np.int32)
    wt = np.zeros((out_size, 2), np.float32)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        lo_c = min(max(lo, 0), in_size - 1)
        hi_c = min(max(lo + 1, 0), in_size - 1)
        w_lo, w_hi = np.float32(1.0 - frac), np.float32(frac)
        if lo_c == hi_c:
            w_lo, w_hi = np.float32(w_lo + w_hi), np.float32(0.0)
        idx[i] = (lo_c, hi_c)
        wt[i] = (w_lo, w_hi)
    return idx, wt


def interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear weights: row i holds wt[i, 0] at
    idx[i, 0] and wt[i, 1] at idx[i, 1] of `interp_taps`. Equal to
    gifgan_tpu/kernels/resize.py interp_matrix."""
    idx, wt = interp_taps(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size)[:, None], idx), wt)
    return m


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    """interp_matrix on `device`, cached like the kernel's tap tables."""
    return torch.from_numpy(interp_matrix(in_size, out_size)).to(device)


def resize_normalize_plain(frames: torch.Tensor, out_h: int, out_w: int,
                           normalize: bool = True) -> torch.Tensor:
    """The plain version: the two dense interpolation products of
    resize_normalize_ref as one einsum, then the scale."""
    h, w = frames.shape[1:3]
    a = _device_matrix(h, out_h, frames.device)
    b = _device_matrix(w, out_w, frames.device)
    y = torch.einsum("ih,nhwc,jw->nijc", a, frames.to(torch.float32), b)
    return y * (1.0 / 127.5) - 1.0 if normalize else y


def _check(frames: torch.Tensor, out_h: int, out_w: int) -> None:
    if not isinstance(frames, torch.Tensor):
        raise ValueError("frames must be a torch.Tensor; put a numpy clip "
                         "on its device first (torch.as_tensor(...).to(...))")
    if frames.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"frames must be uint8 or float32, got "
                         f"{frames.dtype}")
    if frames.ndim != 4:
        raise ValueError(f"frames must be (N, H, W, C), got shape "
                         f"{tuple(frames.shape)}")
    if min(frames.shape[1:]) == 0:
        raise ValueError(f"frames have an empty axis: {tuple(frames.shape)}")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size must be positive, got "
                         f"({out_h}, {out_w})")


_fn = None


def _kernel():
    """The C entry point, built and loaded on first use."""
    global _fn
    if _fn is None:
        fn = _build.load(NAME).resize_normalize_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=64)
def _device_taps(in_size: int, out_size: int, device: torch.device):
    """interp_taps on `device`. Cached: building them copies from the host,
    which would stall the stream once per call."""
    idx, wt = interp_taps(in_size, out_size)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(wt).to(device))


def resize_normalize(frames: torch.Tensor, out_h: int, out_w: int,
                     normalize: bool = True) -> torch.Tensor:
    """frames (N, H, W, C) uint8 or float32 -> (N, out_h, out_w, C) float32,
    in [-1, 1] for uint8 input when `normalize`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `resize_normalize.launches`); anything else raises."""
    _check(frames, out_h, out_w)
    if frames.device.type == "cpu":
        return resize_normalize_plain(frames, out_h, out_w, normalize)
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    fn = _kernel()
    n, h, w, c = frames.shape
    out = torch.empty((n, out_h, out_w, c), dtype=torch.float32,
                      device=frames.device)
    if n == 0:
        return out
    yidx, ywt = _device_taps(h, out_h, frames.device)
    xidx, xwt = _device_taps(w, out_w, frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(frames.data_ptr(), int(frames.dtype == torch.uint8),
                 out.data_ptr(), yidx.data_ptr(), ywt.data_ptr(),
                 xidx.data_ptr(), xwt.data_ptr(), n, h, w, c, out_h, out_w,
                 int(bool(normalize)), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    resize_normalize.launches += 1
    return out


resize_normalize.launches = 0
