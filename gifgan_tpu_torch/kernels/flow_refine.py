"""K4: Lucas-Kanade refinement of per-corner flow at one pyramid level.

`lk_refine(img1, t0, gx, gy, amat, pts, flow, win, iters)` runs `iters`
dependent LK steps for every corner of every image pair — the function of
the Pallas kernel gifgan_tpu/kernels/flow_pallas.py lk_refine (:106,
pallas_call :116), batched here over pairs: one launch per pyramid level
where the JAX package loops over the pairs in Python
(gifgan_tpu/kernels/flow.py:211-215). The template and gradient windows
(t0, gx, gy) and the 2x2 system (amat) do not change over the steps and are
computed once by the caller (kernels/flow.py lk_flow_batch); only the
resample of img1 iterates.

On CUDA tensors the wrapper launches the hand-written kernel
csrc/lk_refine.cu (arithmetic, bound and design are noted there). On CPU
tensors it takes the plain PyTorch version below, which the CPU tests hold
against the JAX kernel in interpret mode and the card run holds the kernel
against. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from gifgan_tpu_torch.kernels import _build

NAME = "lk_refine"
MAX_WIN = 32                      # csrc/lk_refine.cu: win * win <= 1024


def bilinear_windows(imgs: torch.Tensor, pts: torch.Tensor,
                     win: int) -> torch.Tensor:
    """Bilinear (win, win) windows around pts: imgs (B, H, W) float32, pts
    (B, K, 2) [x, y] centres -> (B, K, win, win), out[b, k, i, j] =
    bilinear(imgs[b], y = pts[b, k, 1] + i - r, x = pts[b, k, 0] + j - r),
    r = win // 2.

    An integer-base (win + 1)^2 window is gathered and its four shifted
    sub-windows are combined with the fractional weights. The base is
    clamped into the frame (bx to [0, W - win - 1]) and the fraction to
    [0, 1], as gifgan_tpu/kernels/flow.py sample_windows :77-83 and the
    LK kernel clamp them."""
    b, h, w = imgs.shape
    m = win + 1
    r = win // 2
    x = pts[..., 0] - r
    y = pts[..., 1] - r
    bx = torch.floor(x).clamp(0, w - m)
    by = torch.floor(y).clamp(0, h - m)
    ax = (x - bx).clamp(0.0, 1.0)[..., None, None]
    ay = (y - by).clamp(0.0, 1.0)[..., None, None]
    span = torch.arange(m, device=imgs.device)
    rows = (by.long()[..., None] + span)[..., :, None]       # (B, K, m, 1)
    cols = (bx.long()[..., None] + span)[..., None, :]       # (B, K, 1, m)
    pair = torch.arange(b, device=imgs.device)[:, None, None, None]
    grid = imgs[pair, rows, cols]                            # (B, K, m, m)
    return ((1 - ax) * (1 - ay) * grid[..., :-1, :-1]
            + ax * (1 - ay) * grid[..., :-1, 1:]
            + (1 - ax) * ay * grid[..., 1:, :-1]
            + ax * ay * grid[..., 1:, 1:])


def lk_refine_plain(img1: torch.Tensor, t0: torch.Tensor, gx: torch.Tensor,
                    gy: torch.Tensor, amat: torch.Tensor, pts: torch.Tensor,
                    flow: torch.Tensor, win: int,
                    iters: int = 10) -> torch.Tensor:
    """The plain version: the same steps with tensor indexing, batched over
    (B, K)."""
    a11, a12, a22, det = amat.unbind(-1)
    ok = det > 1e-6
    safe_det = det.clamp(min=1e-6)
    zero = torch.zeros_like(det)
    f = flow
    for _ in range(iters):
        dt = bilinear_windows(img1, pts + f, win) - t0
        b1 = -(dt * gx).sum((-1, -2))
        b2 = -(dt * gy).sum((-1, -2))
        du = torch.where(ok, (a22 * b1 - a12 * b2) / safe_det, zero)
        dv = torch.where(ok, (a11 * b2 - a12 * b1) / safe_det, zero)
        f = f + torch.stack([du, dv], dim=-1)
    return f


def _check(img1, t0, gx, gy, amat, pts, flow, win: int, iters: int) -> None:
    tensors = dict(img1=img1, t0=t0, gx=gx, gy=gy, amat=amat, pts=pts,
                   flow=flow)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != img1.device:
            raise ValueError(f"{name} on {t.device}, img1 on {img1.device}")
    if img1.ndim != 3:
        raise ValueError(f"img1 must be (B, H, W), got shape "
                         f"{tuple(img1.shape)}")
    b, h, w = img1.shape
    if not 1 <= win <= MAX_WIN:
        raise ValueError(f"win must be in [1, {MAX_WIN}], got {win}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if h < win + 1 or w < win + 1:
        raise ValueError(f"img1 {h}x{w} is smaller than the {win + 1}-pixel "
                         f"sampling window")
    if t0.ndim != 4 or t0.shape[0] != b or t0.shape[2:] != (win, win):
        raise ValueError(f"t0 must be (B, K, {win}, {win}), got shape "
                         f"{tuple(t0.shape)}")
    k = t0.shape[1]
    want = dict(gx=t0.shape, gy=t0.shape, amat=(b, k, 4), pts=(b, k, 2),
                flow=(b, k, 2))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got shape "
                             f"{tuple(tensors[name].shape)}")


_fn = None


def _kernel():
    """The C entry point, built and loaded on first use."""
    global _fn
    if _fn is None:
        fn = _build.load(NAME).lk_refine_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def lk_refine(img1: torch.Tensor, t0: torch.Tensor, gx: torch.Tensor,
              gy: torch.Tensor, amat: torch.Tensor, pts: torch.Tensor,
              flow: torch.Tensor, win: int, iters: int = 10) -> torch.Tensor:
    """img1 (B, H, W), t0/gx/gy (B, K, win, win), amat (B, K, 4)
    [a11 a12 a22 det], pts (B, K, 2), flow (B, K, 2), all float32 ->
    (B, K, 2) refined flow.

    CPU tensors take the plain version; CUDA tensors launch the kernel, once
    for all pairs (counted in `lk_refine.launches`); anything else raises.
    img1 may be strided; the other tensors must be contiguous."""
    _check(img1, t0, gx, gy, amat, pts, flow, win, iters)
    if img1.device.type == "cpu":
        return lk_refine_plain(img1, t0, gx, gy, amat, pts, flow, win, iters)
    if img1.device.type != "cuda":
        raise ValueError(f"no kernel for device {img1.device}")
    for name, t in dict(t0=t0, gx=gx, gy=gy, amat=amat, pts=pts,
                        flow=flow).items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, w = img1.shape
    k = t0.shape[1]
    if b > 65535:
        raise ValueError(f"at most 65535 pairs per launch, got {b}")
    fn = _kernel()
    out = torch.empty((b, k, 2), dtype=torch.float32, device=img1.device)
    if b == 0 or k == 0:
        return out
    with torch.cuda.device(img1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img1.data_ptr(), t0.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                 amat.data_ptr(), pts.data_ptr(), flow.data_ptr(),
                 out.data_ptr(), b, k, h, w, *img1.stride(), win, iters,
                 stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    lk_refine.launches += 1
    return out


lk_refine.launches = 0
