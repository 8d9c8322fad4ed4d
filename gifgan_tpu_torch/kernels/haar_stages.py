"""K3: the first stages of a Haar cascade over every window of a packed
pyramid canvas.

`haar_stages(ii, ii2, grid, tables, n_stages, stride)` computes, for every
frame and every window origin of the canvas grid, the window's variance
normalizer from the integral canvases and then the cascade's first
`n_stages` stages (depth-2 trees over sums of two or three rectangles),
folding the stage verdicts into an int8 alive mask: the function of the
Pallas kernel gifgan_tpu/track/haar_device.py
DeviceHaarDetector._build_stage_kernel (:426, pallas_call :573). The canvas
layout, the window grid and the survivors' finish are track/haar_device.py's.

On CUDA tensors the wrapper launches the hand-written kernel
csrc/haar_stages.cu (one block per 32x32 tile of the list of valid windows,
survivors compacted in shared memory after every stage, each tree one
packed record; arithmetic, bound and design are noted there), once per
call, into a zero-filled mask. On CPU tensors it takes
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
    """The per-tree tables of a whole cascade: as numpy arrays (`host`, in
    the order geo, wts, thr, leaf, flg, is_last, sthr) for the plain
    version, and on one device as the kernel reads them: `records`, one
    packed record per tree (`pack_records`, uint8 (N, record size)), and
    `ends`, `stage_end` as int32. `stage_end[s]` is the tree count of the
    first s + 1 stages; `dtype` is the canvases' type the values are
    rounded to. Also the window and the furthest corner offsets any entry
    reaches."""

    host: tuple
    records: torch.Tensor
    ends: torch.Tensor
    dtype: torch.dtype
    stage_end: tuple
    window_w: int
    window_h: int
    ext_x: int
    ext_y: int


# Bits of a record's flags: node 0's left child is a leaf, its right child
# is a leaf, the tree ends a stage.
LEFT_LEAF, RIGHT_LEAF, ENDS_STAGE = 1, 2, 4


def record_dtype(dtype) -> np.dtype:
    """The numpy layout of one tree's record, csrc/haar_stages.cu
    TreeRecord<T>: int32 geo[6] (node n's rect r at 3 n + r, packed as in
    `cascade_tables_rolled`), flags, pad, then in the canvases' type
    wts[6], thr[2], leaf[4], sthr; 16-byte aligned, 96 bytes in float32 and
    144 in float64."""
    t = np.dtype(dtype)
    f = t.itemsize
    return np.dtype({
        "names": ["geo", "flags", "pad", "wts", "thr", "leaf", "sthr"],
        "formats": [(np.int32, (6,)), np.int32, np.int32, (t, (6,)),
                    (t, (2,)), (t, (4,)), t],
        "offsets": [0, 24, 28, 32, 32 + 6 * f, 32 + 8 * f, 32 + 12 * f],
        "itemsize": -(-(32 + 13 * f) // 16) * 16})


def pack_records(host: tuple, dtype) -> np.ndarray:
    """`cascade_tables_rolled`'s arrays (geo, wts, thr, leaf, flg, is_last,
    sthr) in `dtype` -> (N, record size) uint8, one record per tree, the
    same values laid out as the kernel reads them."""
    geo, wts, thr, leaf, flg, is_last, sthr = host
    rec = np.zeros(len(geo), record_dtype(dtype))
    rec["geo"] = geo.reshape(-1, 6)
    rec["flags"] = ((flg[:, 0] != 0) * LEFT_LEAF + (flg[:, 1] != 0)
                    * RIGHT_LEAF + (is_last != 0) * ENDS_STAGE)
    rec["wts"] = wts.reshape(-1, 6)
    rec["thr"] = thr
    rec["leaf"] = leaf
    rec["sthr"] = sthr
    return rec.view(np.uint8).reshape(len(geo), -1)


def corner_extent(cas, rects: np.ndarray) -> tuple:
    """(ext_x, ext_y): the furthest corner offsets from a window's origin
    that the cascade's window or any of its rects (`rects` as for
    `cascade_tables_rolled`) reaches."""
    return (int(max(cas.window_w, (rects[:, :, 0] + rects[:, :, 2]).max())),
            int(max(cas.window_h, (rects[:, :, 1] + rects[:, :, 3]).max())))


# Side of the square tiles of grid cells the valid-window list is ordered
# by: a tile is one run of csrc/haar_stages.cu, whose compiled kRun must be
# TILE * TILE (the wrapper passes it and the launch refuses another), so a
# block's corner loads stay inside (TILE + 20)^2 canvas values.
TILE = 32


class WindowGrid(NamedTuple):
    """A canvas grid as both sides of K3 read it: `valid` (ny, nx) int8 for
    the plain version, and `cells` (n, 2) int32, the (gy, gx) of its valid
    windows in tile order, for the kernel. Made by `window_grid` only, so
    the two cannot come from different grids."""

    valid: torch.Tensor
    cells: torch.Tensor


def window_grid(valid: torch.Tensor) -> WindowGrid:
    """valid (ny, nx) int8 -> the WindowGrid of it, built once per grid on
    valid's device (`torch.nonzero`, which waits for the device). The cells
    are those of `torch.nonzero(valid)`, ordered by TILE x TILE tile of the
    grid (tiles in row-major order, cells row-major inside a tile)."""
    cells = torch.nonzero(valid)
    tiles_x = -(-valid.shape[1] // TILE)
    tile = (cells[:, 0] // TILE) * tiles_x + cells[:, 1] // TILE
    order = torch.argsort(tile, stable=True)
    return WindowGrid(valid, cells[order].to(torch.int32).contiguous())


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
    ext_x, ext_y = corner_extent(cas, rects)
    ends = tuple(int(v) for v in cas.stage_first + cas.stage_count)
    records = torch.from_numpy(pack_records(host, _DTYPES[dtype])).to(device)
    return StageTables(host, records,
                       torch.tensor(ends, dtype=torch.int32, device=device),
                       dtype, ends, int(cas.window_w), int(cas.window_h),
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


def _check(ii, ii2, grid, tables: StageTables, n_stages: int,
           stride: int) -> None:
    if not isinstance(grid, WindowGrid):
        raise ValueError(f"grid must be window_grid(valid), got "
                         f"{type(grid).__name__}")
    valid, cells = grid
    for name, t in (("ii", ii), ("ii2", ii2), ("valid", valid),
                    ("cells", cells)):
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
    if (cells.ndim != 2 or cells.shape[1] != 2 or cells.dtype != torch.int32
            or cells.shape[0] > valid.numel()):
        raise ValueError(f"cells must be (n, 2) int32 from window_grid, got "
                         f"{tuple(cells.shape)} {cells.dtype}")
    if (tables.dtype != ii.dtype or tables.records.device != ii.device
            or tables.records.dtype != torch.uint8
            or tables.records.shape[1] != record_dtype(
                _DTYPES[tables.dtype]).itemsize):
        raise ValueError(f"tables are {tables.dtype} records on "
                         f"{tables.records.device}, the canvases {ii.dtype} "
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
    for name, t in (("ii", ii), ("ii2", ii2), ("valid", valid),
                    ("cells", cells)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_fn = None


def _kernel():
    """The C entry point, built and loaded on first use."""
    global _fn
    if _fn is None:
        fn = _build.load(NAME).haar_stages_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def haar_stages(ii: torch.Tensor, ii2: torch.Tensor, grid: WindowGrid,
                tables: StageTables, n_stages: int,
                stride: int = 1) -> torch.Tensor:
    """ii, ii2 (T, canvas_h, canvas_w) float32 or float64, grid =
    window_grid(valid) for the (ny, nx) int8 validity grid, `tables` from
    `stage_tables` in the same type on the same device -> (T, ny, nx) int8,
    1 where the window is valid and passes the first `n_stages` stages.

    CPU tensors take the plain version, which reads `grid.valid`; CUDA
    tensors launch the kernel, which walks `grid.cells` (and skips a cell
    outside the grid), once for all frames (one kernel launch per call,
    counted in `haar_stages.launches`); anything else raises. The tensors
    must be contiguous."""
    _check(ii, ii2, grid, tables, n_stages, stride)
    valid, cells = grid
    if ii.device.type == "cpu":
        return haar_stages_plain(ii, ii2, valid, tables, n_stages, stride)
    if ii.device.type != "cuda":
        raise ValueError(f"no kernel for device {ii.device}")
    t, ch, cw = ii.shape
    ny, nx = valid.shape
    if t > 65535:
        raise ValueError(f"at most 65535 frames per launch, got {t}")
    fn = _kernel()
    alive = torch.zeros((t, ny, nx), dtype=torch.int8, device=ii.device)
    if alive.numel() == 0 or cells.shape[0] == 0:
        return alive
    with torch.cuda.device(ii.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ii.data_ptr(), ii2.data_ptr(), cells.data_ptr(),
                 cells.shape[0], TILE * TILE, tables.records.data_ptr(),
                 tables.ends.data_ptr(), alive.data_ptr(), t, ch, cw, ny, nx,
                 stride, n_stages, tables.window_w, tables.window_h,
                 tables.ext_y, tables.ext_x, int(ii.dtype == torch.float64),
                 stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    haar_stages.launches += 1
    return alive


haar_stages.launches = 0
