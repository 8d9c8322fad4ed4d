"""K3: the first stages of a Haar cascade over every window of a packed
pyramid canvas.

`haar_stages(ii, ii2, valid, tables, n_stages, stride)` computes, for every
frame and every window origin of the canvas grid, the window's variance
normalizer from the integral canvases and then the cascade's first
`n_stages` stages (depth-2 trees over sums of two or three rectangles),
folding the stage verdicts into an int8 alive mask: the function of the
Pallas kernel gifgan_tpu/track/haar_device.py
DeviceHaarDetector._build_stage_kernel (:426, pallas_call :573). The canvas
layout, the window grid and the survivors' finish are track/haar_device.py's.

On CUDA tensors the wrapper launches the hand-written kernel
csrc/haar_stages.cu (one thread per window, leaving at the first stage it
fails; arithmetic, bound and design are noted there). On CPU tensors it takes
the plain PyTorch version below: the strided-slice formulation of the JAX
package's `_unrolled_stages` (haar_device.py:121), every operation in the
same order, no exit. The CPU tests hold it against the JAX package's mask and
the card run holds the kernel against it, bit for bit. There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gifgan_tpu_torch.kernels import _build

NAME = "haar_stages"
_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class StageTables(NamedTuple):
    """The per-tree tables of a whole cascade, as numpy arrays (`host`, in
    the order geo, wts, thr, leaf, flg, is_last, sthr) and as tensors on one
    device (`dev`, same order), with the window and the furthest corner
    offsets any entry reaches. `stage_end[s]` is the tree count of the first
    s + 1 stages."""

    host: tuple
    dev: tuple
    stage_end: tuple
    window_w: int
    window_h: int
    ext_x: int
    ext_y: int


def cascade_tables_rolled(cas, rects: np.ndarray, n_stages: int,
                          dtype=np.float32):
    """Flat per-tree parameter arrays of the first `n_stages` stages of the
    parsed cascade `cas` (track/haar.py HaarCascade; only its fields are
    read), whose features' base-scale rects are `rects` (n_features, 3, 5:
    x, y, w, h, weight), as gifgan_tpu/track/haar_device.py
    _cascade_params_rolled (:369) builds them: packed geometry (N, 2, 3) int32 (x0 | y0 << 5 | rw << 10 |
    rh << 15 per rect) and weight per rect per node, node thresholds, the
    four possible leaf values (node 0's left and right leaves, node 1's
    left and right), flags that node 0's children are leaves, and per tree
    whether it ends a stage and that stage's threshold. Absent rects and
    nodes get zero weights and thresholds. `dtype` is the canvases' type:
    float32 rounds the cascade's float64 values, float64 keeps them."""
    n_trees = int(cas.stage_first[n_stages - 1]
                  + cas.stage_count[n_stages - 1])
    geo = np.zeros((n_trees, 2, 3, 4), np.int32)
    wts = np.zeros((n_trees, 2, 3), dtype)
    thr = np.zeros((n_trees, 2), dtype)
    leaf = np.zeros((n_trees, 4), dtype)
    flg = np.zeros((n_trees, 2), dtype)
    is_last = np.zeros((n_trees,), dtype)
    sthr = np.zeros((n_trees,), dtype)
    for s in range(n_stages):
        e = int(cas.stage_first[s] + cas.stage_count[s]) - 1
        is_last[e] = 1.0
        sthr[e] = cas.stage_thr[s]
    for tr in range(n_trees):
        l0 = int(cas.node_left[tr, 0])
        r0 = int(cas.node_right[tr, 0])
        flg[tr, 0] = 1.0 if l0 <= 0 else 0.0
        flg[tr, 1] = 1.0 if r0 <= 0 else 0.0
        if l0 <= 0:
            leaf[tr, 0] = cas.leaves[tr][-l0]
        if r0 <= 0:
            leaf[tr, 1] = cas.leaves[tr][-r0]
        nodes = [0]
        thr[tr, 0] = cas.node_thr[tr, 0]
        if l0 > 0 or r0 > 0:
            nodes.append(1)
            thr[tr, 1] = cas.node_thr[tr, 1]
            leaf[tr, 2] = cas.leaves[tr][-int(cas.node_left[tr, 1])]
            leaf[tr, 3] = cas.leaves[tr][-int(cas.node_right[tr, 1])]
        for n in nodes:
            fid = int(cas.node_feat[tr, n])
            for r in range(3):
                x0, y0, rw, rh, wt = rects[fid, r]
                if wt == 0.0:
                    continue
                geo[tr, n, r] = (int(x0), int(y0), int(rw), int(rh))
                wts[tr, n, r] = wt
    if geo.size and geo.max() >= 32:
        raise ValueError(f"a rect coordinate of {geo.max()} does not fit "
                         "the 5-bit geometry fields")
    pgeo = (geo[..., 0] | (geo[..., 1] << 5) | (geo[..., 2] << 10)
            | (geo[..., 3] << 15)).astype(np.int32)
    return n_trees, pgeo, wts, thr, leaf, flg, is_last, sthr


def stage_tables(cas, rects: np.ndarray, dtype: torch.dtype,
                 device) -> StageTables:
    """The tables of all of `cas`'s stages in `dtype` on `device`; `cas` and
    `rects` as for `cascade_tables_rolled`."""
    host = cascade_tables_rolled(cas, rects, len(cas.stage_thr),
                                 _DTYPES[dtype])[1:]
    ext_x = int(max(cas.window_w, (rects[:, :, 0] + rects[:, :, 2]).max()))
    ext_y = int(max(cas.window_h, (rects[:, :, 1] + rects[:, :, 3]).max()))
    dev = tuple(torch.from_numpy(a).to(device) for a in host)
    ends = tuple(int(v) for v in cas.stage_first + cas.stage_count)
    return StageTables(host, dev, ends, int(cas.window_w), int(cas.window_h),
                       ext_x, ext_y)


def haar_stages_plain(ii: torch.Tensor, ii2: torch.Tensor,
                      valid: torch.Tensor, tables: StageTables,
                      n_stages: int, stride: int = 1) -> torch.Tensor:
    """The plain version: every corner of every rect as a strided slice of
    the canvas, every tree a `torch.where`, all windows through all
    `n_stages` stages. Operation order as `_unrolled_stages` and
    `rect_grid` of the JAX package: (c00 + c11) - c01 - c10, times the
    weight, rects summed in order, times inv_area; f < thr * nf; leaf values
    summed in tree order; total >= stage threshold."""
    t = ii.shape[0]
    ny, nx = valid.shape
    st = stride
    dtype, dev = ii.dtype, ii.device
    geo, wts, thr, leaf, flg, is_last, sthr = tables.host
    ww, wh = tables.window_w, tables.window_h
    inv_area = float(_DTYPES[dtype](1.0 / (ww * wh)))

    def corner(img, dy, dx):
        return img[:, dy:dy + (ny - 1) * st + 1:st,
                   dx:dx + (nx - 1) * st + 1:st]

    def rect(img, x0, y0, rw, rh):
        return ((corner(img, y0, x0) + corner(img, y0 + rh, x0 + rw))
                - corner(img, y0, x0 + rw) - corner(img, y0 + rh, x0))

    def const(v):
        return torch.full((), float(v), dtype=dtype, device=dev)

    s1 = rect(ii, 0, 0, ww, wh)
    s2 = rect(ii2, 0, 0, ww, wh)
    mean_c = s1 * inv_area - 128.0
    var = s2 * inv_area - mean_c * mean_c
    nf = torch.where(var > 0, torch.sqrt(torch.clamp(var, min=0.0)),
                     const(1.0))

    def feature(tr, n):
        acc = None
        for r in range(3):
            wt = float(wts[tr, n, r])
            if wt == 0.0:
                continue
            p = int(geo[tr, n, r])
            g = rect(ii, p & 31, (p >> 5) & 31, (p >> 10) & 31,
                     (p >> 15) & 31) * wt
            acc = g if acc is None else acc + g
        return acc * inv_area

    alive = (valid != 0)[None].expand(t, ny, nx)
    total = None
    for tr in range(tables.stage_end[n_stages - 1] if n_stages else 0):
        go0 = feature(tr, 0) < float(thr[tr, 0]) * nf
        left_leaf, right_leaf = flg[tr, 0] != 0, flg[tr, 1] != 0
        if left_leaf and right_leaf:
            node1 = None
        else:
            go1 = feature(tr, 1) < float(thr[tr, 1]) * nf
            node1 = torch.where(go1, const(leaf[tr, 2]), const(leaf[tr, 3]))
        value = torch.where(go0,
                            const(leaf[tr, 0]) if left_leaf else node1,
                            const(leaf[tr, 1]) if right_leaf else node1)
        total = value if total is None else total + value
        if is_last[tr] != 0:
            alive = alive & (total >= float(sthr[tr]))
            total = None
    return alive.to(torch.int8)


def _check(ii, ii2, valid, tables: StageTables, n_stages: int,
           stride: int) -> None:
    for name, t in (("ii", ii), ("ii2", ii2), ("valid", valid)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a torch.Tensor")
        if t.device != ii.device:
            raise ValueError(f"{name} on {t.device}, ii on {ii.device}")
    if ii.dtype not in _DTYPES or ii2.dtype != ii.dtype:
        raise ValueError(f"ii and ii2 must both be float32 or float64, got "
                         f"{ii.dtype} and {ii2.dtype}")
    if ii.ndim != 3 or ii2.shape != ii.shape:
        raise ValueError(f"ii and ii2 must be (T, canvas_h, canvas_w), got "
                         f"{tuple(ii.shape)} and {tuple(ii2.shape)}")
    if valid.ndim != 2 or valid.dtype != torch.int8:
        raise ValueError(f"valid must be (ny, nx) int8, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if tables.dev[1].dtype != ii.dtype or tables.dev[1].device != ii.device:
        raise ValueError(f"tables are {tables.dev[1].dtype} on "
                         f"{tables.dev[1].device}, the canvases {ii.dtype} "
                         f"on {ii.device}")
    if not 0 <= n_stages <= len(tables.stage_end):
        raise ValueError(f"n_stages must be in [0, {len(tables.stage_end)}]"
                         f", got {n_stages}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    ny, nx = valid.shape
    _, ch, cw = ii.shape
    if ((ny - 1) * stride + tables.ext_y > ch - 1
            or (nx - 1) * stride + tables.ext_x > cw - 1):
        raise ValueError(f"a ({ny}, {nx}) grid at stride {stride} reaches "
                         f"past the ({ch}, {cw}) canvas")


_fn = None


def _kernel():
    """The C entry point, built and loaded on first use."""
    global _fn
    if _fn is None:
        fn = _build.load(NAME).haar_stages_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def haar_stages(ii: torch.Tensor, ii2: torch.Tensor, valid: torch.Tensor,
                tables: StageTables, n_stages: int,
                stride: int = 1) -> torch.Tensor:
    """ii, ii2 (T, canvas_h, canvas_w) float32 or float64, valid (ny, nx)
    int8, `tables` from `stage_tables` in the same type on the same device
    -> (T, ny, nx) int8, 1 where the window is valid and passes the first
    `n_stages` stages.

    CPU tensors take the plain version; CUDA tensors launch the kernel, once
    for all frames (counted in `haar_stages.launches`); anything else
    raises. The tensors must be contiguous."""
    _check(ii, ii2, valid, tables, n_stages, stride)
    if ii.device.type == "cpu":
        return haar_stages_plain(ii, ii2, valid, tables, n_stages, stride)
    if ii.device.type != "cuda":
        raise ValueError(f"no kernel for device {ii.device}")
    for name, t in (("ii", ii), ("ii2", ii2), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    t, ch, cw = ii.shape
    ny, nx = valid.shape
    if t > 65535:
        raise ValueError(f"at most 65535 frames per launch, got {t}")
    fn = _kernel()
    alive = torch.empty((t, ny, nx), dtype=torch.int8, device=ii.device)
    if alive.numel() == 0:
        return alive
    n_trees = tables.stage_end[n_stages - 1] if n_stages else 0
    with torch.cuda.device(ii.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ii.data_ptr(), ii2.data_ptr(), valid.data_ptr(),
                 *(a.data_ptr() for a in tables.dev), alive.data_ptr(), t,
                 ch, cw, ny, nx, stride, n_trees, tables.window_w,
                 tables.window_h, tables.ext_y, tables.ext_x,
                 int(ii.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    haar_stages.launches += 1
    return alive


haar_stages.launches = 0
