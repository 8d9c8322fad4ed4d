"""Face detection backends + face ranking / similarity.

The port of gifgan_tpu/track/detect.py. Backends:

  - the device detector (track/haar_device.py DeviceHaarDetector): the
    pyramid-packed cascade with its early stages as the CUDA kernel K3;
    what "auto" means;
  - the host detectors of track/haar.py (the C++ early-exit evaluator, the
    numpy one) and OpenCV's CascadeClassifier where the build has it, by
    name only;
  - CallableDetector: inject any (frame -> rects) function.

Sharpness ranking (Laplacian energy), centrality/size scoring and MSSIM face
similarity are batched convolutions on tensors.
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gifgan_tpu_torch.track.boxes import Detection

try:
    import cv2
    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False


class CV2HaarDetector:
    """Haar-cascade detection through OpenCV, with the size bounds of the
    other backends (min fixed, max a factor of sqrt(frame area))."""

    def __init__(self, cascade_path: Optional[str] = None,
                 scale_factor: float = 1.1, min_neighbors: int = 5,
                 min_size: int = 50, max_size_factor: float = 1.0):
        if not _HAVE_CV2 or not hasattr(cv2, "CascadeClassifier"):
            raise RuntimeError("cv2 with objdetect unavailable")
        if cascade_path is None:
            cascade_path = (cv2.data.haarcascades +
                            "haarcascade_frontalface_alt2.xml")
        self.cc = cv2.CascadeClassifier(cascade_path)
        if self.cc.empty():
            raise RuntimeError(f"failed to load cascade {cascade_path}")
        self.scale_factor = scale_factor
        self.min_neighbors = min_neighbors
        self.min_size = min_size
        self.max_size_factor = max_size_factor

    def __call__(self, frame: np.ndarray, frame_number: int = 0,
                 ) -> List[Detection]:
        side = math.sqrt(frame.shape[0] * frame.shape[1])
        minlen = self.min_size
        maxlen = int(side * self.max_size_factor)
        rects = self.cc.detectMultiScale(
            frame, self.scale_factor, self.min_neighbors, 0,
            (minlen, minlen), (maxlen, maxlen))
        return [Detection.from_rect(r, frame_number) for r in rects]


class CallableDetector:
    """Wrap a (frame, frame_number) -> list[rect(x,y,w,h)] function."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, frame, frame_number: int = 0) -> List[Detection]:
        return [Detection.from_rect(r, frame_number)
                for r in self.fn(frame, frame_number)]


# ---------------------------------------------------------------------------
# Face ranking: weighted sharpness / centrality / size, weights 0.7 / 0.1 /
# 0.2. Images are (N, h, w, c) or (N, h, w) tensors on any device.
# ---------------------------------------------------------------------------

def _to_gray(images: torch.Tensor) -> torch.Tensor:
    if images.ndim == 4 and images.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                         device=images.device)
        return torch.tensordot(images.to(torch.float32), w, dims=1)
    return (images.to(torch.float32).squeeze(-1) if images.ndim == 4
            else images)


def sharpness(images: torch.Tensor) -> torch.Tensor:
    """Mean |Laplacian| per image: one batched 3x3 convolution."""
    gray = _to_gray(images).to(torch.float32)[:, None]
    kernel = torch.tensor([[0., 1., 0.], [1., -4., 1.], [0., 1., 0.]],
                          dtype=torch.float32,
                          device=gray.device).reshape(1, 1, 3, 3)
    return F.conv2d(gray, kernel).abs().mean(dim=(1, 2, 3))


def rank_faces(images: torch.Tensor, boxes: np.ndarray, frame_shape,
               w_sharp: float = 0.7, w_central: float = 0.1,
               w_size: float = 0.2) -> np.ndarray:
    """Scores for candidate face crops: normalized sharpness + centrality +
    size. images: (N, h, w, c) crops resized to a common size; boxes:
    (N, 4) x1y1x2y2 in the original frame."""
    s = sharpness(images)
    s = s / (s.max() + 1e-8)

    fh, fw = frame_shape[:2]
    cx = (boxes[:, 0] + boxes[:, 2]) / 2.0 / fw - 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) / 2.0 / fh - 0.5
    centrality = 1.0 - np.sqrt(cx ** 2 + cy ** 2) / np.sqrt(0.5)
    area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            ).astype(np.float64)
    size = area / (area.max() + 1e-8)

    return (w_sharp * s.cpu().numpy() + w_central * centrality
            + w_size * size)


def mssim(a: torch.Tensor, b: torch.Tensor, window: int = 8) -> torch.Tensor:
    """Mean structural similarity between two batches of same-size gray
    images, as batched average-pool convolutions."""
    C1, C2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    ga = _to_gray(a).to(torch.float32)[:, None]
    gb = _to_gray(b).to(torch.float32)[:, None]
    k = torch.ones((1, 1, window, window), dtype=torch.float32,
                   device=ga.device) / (window * window)

    def pool(x):
        return F.conv2d(x, k)

    mu_a, mu_b = pool(ga), pool(gb)
    var_a = pool(ga * ga) - mu_a * mu_a
    var_b = pool(gb * gb) - mu_b * mu_b
    cov = pool(ga * gb) - mu_a * mu_b
    ssim_map = (((2 * mu_a * mu_b + C1) * (2 * cov + C2)) /
                ((mu_a * mu_a + mu_b * mu_b + C1) * (var_a + var_b + C2)))
    return ssim_map.mean(dim=(1, 2, 3))


# Conventional locations for the frontalface_alt2 cascade (model data, not
# code). Nothing is bundled; we look in the user's home and the system
# OpenCV share dir.
_CASCADE_SEARCH = (
    os.path.expanduser("~/haarcascade_frontalface_alt2.xml"),
    "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt2.xml",
    "/usr/share/opencv/haarcascades/haarcascade_frontalface_alt2.xml",
)


def find_default_cascade() -> Optional[str]:
    """First frontalface_alt2.xml found in the conventional locations, or
    None. Lets tools default their --cascade flag without bundling the
    (user-supplied) model file."""
    for p in _CASCADE_SEARCH:
        if os.path.exists(p):
            return p
    return None


# Clips per detect_clips dispatch when the caller names no batch: a default,
# not a measured optimum.
AUTO_DETECT_BATCH = 8
BACKENDS = ("auto", "device", "native", "cv2", "python")


def select_detector_backend(*, device_available: bool,
                            detect_batch_clips: int = 1):
    """Pick (backend, detect_batch_clips) for `detector_backend="auto"`:
    the device detector, batching detect_batch_clips clips per dispatch
    (AUTO_DETECT_BATCH when the caller asked for no batch); it composes
    with workers > 1 through run_directory's dispatcher thread. No device
    raises: the port does not move work to the host unasked (pass
    device="cpu" to run the device detector's plain version there). The
    JAX package also sends small frames to a host backend, below a
    crossover measured on its own hardware; no crossover has shown on the
    card, so the frame size picks nothing here. Explicit backends bypass
    this function."""
    if not device_available:
        raise RuntimeError(
            'detector_backend="auto" is the device detector and CUDA is not '
            "available; name a host backend (native, python, cv2) or pass "
            "device='cpu'")
    batch = detect_batch_clips if detect_batch_clips > 1 \
        else AUTO_DETECT_BATCH
    return "device", batch


def default_detector(cascade_path: Optional[str] = None,
                     scale_factor: float = 1.1, min_neighbors: int = 3,
                     min_size: int = 20, max_size_factor: float = 1.0,
                     backend: str = "auto", device=None):
    """The detector of a backend name: "auto" and "device" give the
    pyramid-packed cascade on `device` (the card; track/haar_device.py),
    "native" the C++ early-exit evaluator, "python" the numpy one, "cv2"
    OpenCV's CascadeClassifier. `cascade_path` points at a standard OpenCV
    cascade XML (user-supplied model data); only "cv2", asked for by name,
    can do without it (OpenCV ships its own). An unknown name raises, and
    so does a backend that cannot run here: none gives way to another."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown detector backend {backend!r}; one of "
                         f"{BACKENDS}")
    if backend == "auto":
        backend = "device"
    if backend == "device":
        from gifgan_tpu_torch import resolve_device

        device = resolve_device(device)      # no card: raises here
    if backend == "cv2":
        return CV2HaarDetector(cascade_path, scale_factor, min_neighbors,
                               min_size, max_size_factor)
    if cascade_path is None:
        raise ValueError(
            f"the {backend} detector needs a cascade file: pass "
            "cascade_path (--cascade), or name the cv2 backend "
            "(--detector-backend cv2) to run OpenCV's own classifier on "
            "the host")
    if backend == "device":
        from gifgan_tpu_torch.track.haar_device import DeviceHaarDetector

        return DeviceHaarDetector(cascade_path, scale_factor, min_neighbors,
                                  min_size, max_size_factor, device=device)
    from gifgan_tpu_torch.track.haar import HaarDetector, NativeHaarDetector

    cls = NativeHaarDetector if backend == "native" else HaarDetector
    return cls(cascade_path, scale_factor, min_neighbors, min_size,
               max_size_factor)
