"""Pyramid-packed Haar cascade detection on the card.

The port of gifgan_tpu/track/haar_device.py. The design is the JAX
package's:

  1. an image pyramid instead of feature scaling (OpenCV's old-format
     detectMultiScale strategy): every level evaluates the cascade at its
     base window over an antialiased-linear downscale of the frame, so the
     feature geometry is one constant table shared by all scales;
  2. all levels pack into one canvas: each level's (h + 1, w + 1)
     integral-image block sits at an even row offset, and the window
     origins of every scale live on one grid over the canvas;
  3. the first `early_stages` stages run for all windows x all scales x all
     frames in one dispatch; the few survivors finish the deep stages on the
     host in float64, in the shared C++ early-exit evaluator
     (native/haarcascade.cpp gifgan_haar_eval_pyramid), which re-derives
     the level images with the same resampling weights.

What differs on the card. The clip program is tensor code on an explicit
device: a uint8 upload, the per-level resize as two matrix products
(`torch.matmul`, float32 with TF32 off), `cumsum` integrals and the canvas
pack, then the hand-written kernel K3 (kernels/haar_stages.py) where the JAX
package runs its XLA or Pallas stage program. The JAX package packs the
alive mask to bits with a matmul because its link to the device is slow;
here the survivors are compacted on the card (`torch.nonzero`) and only
their indices are copied. Above the bound where a float32 integral image no
longer holds its sums exactly (h * w * 255 > 2^24) the JAX package leaves the
device for the feature-scaled host detector; the port stays on the card and
builds float64 canvases, with K3 instantiated for float64. At or below the
bound the port equals the JAX package; above it parity with the host
detectors is statistical, as it is between the feature-scaled and the
pyramid backends at any size (image resampling against integer rect
scaling).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.kernels.haar_stages import (StageTables, haar_stages,
                                                  stage_tables)
from gifgan_tpu_torch.track.haar import (HaarCascade, _eval_stages,
                                         _scaled_rects, group_rectangles,
                                         integral_images,
                                         make_native_cascade_handle,
                                         parse_cascade)

# float32 holds integers exactly up to 2^24: the largest integral-image sum
# of an (h, w) frame of 255s must stay below it
F32_EXACT_SUM = 2 ** 24
# device bytes of the two canvases one K3 dispatch may hold; more frames
# than fit are evaluated in chunks
MAX_CANVAS_BYTES = 1 << 30


class _Level(NamedTuple):
    scale: float   # detected-size multiplier (original px / level px)
    h: int         # level image height
    w: int         # level image width
    row: int       # canvas row where this level's ii block starts (even)


def _plan_levels(cas: HaarCascade, h: int, w: int, scale_factor: float,
                 min_size: int, max_size_factor: float) -> List[_Level]:
    side = math.sqrt(h * w)
    max_len = side * max_size_factor
    levels = []
    row = 0
    scale = max(min_size / cas.window_w, 1.0)
    while True:
        ww = int(round(cas.window_w * scale))
        wh = int(round(cas.window_h * scale))
        if ww > min(w, max_len) or wh > min(h, max_len):
            break
        lh, lw = int(round(h / scale)), int(round(w / scale))
        if lh < cas.window_h or lw < cas.window_w:
            break
        levels.append(_Level(scale, lh, lw, row))
        # ii block is (lh+1) rows; keep the next block at an even offset so
        # all levels' window origins share one stride-2 canvas grid.
        row += ((lh + 1 + 1) // 2) * 2
        scale *= scale_factor
    return levels


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Antialiased linear (triangle-kernel) resampling matrix (n_out, n_in),
    float32, rows normalized to sum 1."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    out = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        center = (i + 0.5) * scale - 0.5
        lo = int(math.floor(center - support))
        hi = int(math.ceil(center + support))
        js = np.arange(lo, hi + 1)
        w = np.maximum(0.0, 1.0 - np.abs(js - center) / support)
        js = np.clip(js, 0, n_in - 1)
        for j, wt in zip(js, w):
            out[i, j] += wt
        # sequential f32 row sum (not numpy's pairwise .sum()): the C++
        # finisher's resample_weights replicates exactly this ordering so
        # both sides normalize by the bit-identical denominator. Only the
        # taps' span is walked: the zeros outside it add nothing.
        s = np.float32(0.0)
        for v in out[i, js[0]:js[-1] + 1]:
            s = np.float32(s + v)
        out[i] /= s
    return out


class _Plan(NamedTuple):
    """What one frame size needs, built once: the level plan, the canvas
    and grid shapes, the grid's validity and level ids, the resize matrices
    (numpy float64 for the numpy finisher, tensors in the canvas type for
    the card), and K3's tables."""

    levels: List[_Level]
    canvas_h: int
    canvas_w: int
    ny: int
    nx: int
    level_id: np.ndarray
    np_mats: list
    dtype: torch.dtype
    valid: torch.Tensor
    mats: list
    tables: StageTables


def numpy_deep_eval(cas: HaarCascade, rects0: np.ndarray, early_stages: int,
                    g64, xs, ys, need, levels, np_mats, canvas_h, w):
    """The deep stages over survivor windows in numpy: rebuilds the needed
    levels of the canvas by matmul and evaluates stages [early_stages, end).
    The tests hold the C++ finisher against it; no detector falls back to
    it."""
    canvas = np.zeros((canvas_h, w), np.float64)
    for li in need:
        lv = levels[li]
        mh, mw = np_mats[li]
        canvas[lv.row:lv.row + lv.h, :lv.w] = mh @ g64 @ mw.T
    ii, ii2 = integral_images(canvas)
    return _eval_stages(cas, ii, ii2, np.asarray(xs, np.int64),
                        np.asarray(ys, np.int64), 1.0, early_stages,
                        len(cas.stage_thr), rects0)


def letterbox_stack(clips: List[np.ndarray],
                    pad_multiple: int = 32) -> np.ndarray:
    """Clips of (T_i, H_i, W_i) frames -> one (sum T_i, H, W) float64 stack:
    every frame padded bottom/right with black onto a common canvas whose
    sides round the largest clip's up to `pad_multiple`."""
    rnd = lambda v, m: -(-int(v) // m) * m
    ch = rnd(max(c.shape[1] for c in clips), pad_multiple)
    cw = rnd(max(c.shape[2] for c in clips), pad_multiple)
    stack = np.zeros((sum(c.shape[0] for c in clips), ch, cw), np.float64)
    row = 0
    for c in clips:
        stack[row:row + c.shape[0], :c.shape[1], :c.shape[2]] = c
        row += c.shape[0]
    return stack


class DeviceHaarDetector:
    """detectMultiScale-equivalent detector; all scales and frames of a clip
    go through the early stages in one dispatch of K3 on `device` (the card
    unless the caller names another; on the CPU the kernel's plain version
    runs). Exposes the detect_rects / detect_batch / detect_clips /
    detect_video / __call__ surface of the host detectors. The deep stages
    need the native library (native/, built at first use) and raise without
    it."""

    def __init__(self, cascade_path: str, scale_factor: float = 1.1,
                 min_neighbors: int = 3, min_size: int = 20,
                 max_size_factor: float = 1.0, early_stages: int = 10,
                 stride: int = 1, device=None):
        if scale_factor <= 1.0:
            raise ValueError(
                f"scale_factor must be > 1.0, got {scale_factor} "
                "(the pyramid level planner multiplies by it until the "
                "window outgrows the image; <= 1.0 never terminates)")
        self.device = resolve_device(device)
        self.cas = parse_cascade(cascade_path)
        self.scale_factor = scale_factor
        self.min_neighbors = min_neighbors
        self.min_size = min_size
        self.max_size_factor = max_size_factor
        self.early_stages = min(early_stages, len(self.cas.stage_thr))
        self.stride = stride
        self._deep_eval = None
        self._native = None  # (lib, handle, keepalive) when in use
        # base-scale rects: _scaled_rects at 1.0 only re-derives the
        # first-rect weight from the others (exact, no rounding)
        self.rects0 = _scaled_rects(self.cas, 1.0)
        self._plans: Dict[Tuple[int, int], Optional[_Plan]] = {}
        self._tables: Dict[torch.dtype, StageTables] = {}
        # the furthest corner any table entry reaches: the tables' own
        # figures, so the grid here and the launch check agree
        first = self._stage_tables(torch.float32)
        self.ext_x, self.ext_y = first.ext_x, first.ext_y

    # -- plan construction ------------------------------------------------

    def _stage_tables(self, dtype: torch.dtype) -> StageTables:
        if dtype not in self._tables:
            self._tables[dtype] = stage_tables(self.cas, self.rects0, dtype,
                                               self.device)
        return self._tables[dtype]

    def _grid_meta(self, levels: List[_Level], canvas_h: int, canvas_w: int):
        """Static per-canvas-grid arrays: validity + level id."""
        st = self.stride
        # corner reads reach gy*st + ext_y and gx*st + ext_x; keep them
        # strictly inside the canvas
        ny = (canvas_h - 1 - self.ext_y) // st + 1
        nx = (canvas_w - 1 - self.ext_x) // st + 1
        valid = np.zeros((ny, nx), bool)
        level_id = np.full((ny, nx), -1, np.int32)
        for li, lv in enumerate(levels):
            # valid local origins: x in [0, lw - ext_x], y in [0, lh - ext_y]
            y0 = lv.row // st
            y1 = y0 + (lv.h - self.ext_y) // st + 1
            x1 = (lv.w - self.ext_x) // st + 1
            if y1 <= y0 or x1 <= 0:
                continue
            y1 = min(y1, ny)
            x1 = min(x1, nx)
            valid[y0:y1, :x1] = True
            level_id[y0:y1, :x1] = li
        return ny, nx, valid, level_id

    def _plan(self, h: int, w: int) -> Optional[_Plan]:
        key = (h, w)
        if key in self._plans:
            return self._plans[key]
        levels = _plan_levels(self.cas, h, w, self.scale_factor,
                              self.min_size, self.max_size_factor)
        if not levels:
            self._plans[key] = None
            return None
        last = levels[-1]
        canvas_h = last.row + ((last.h + 1 + 1) // 2) * 2 + self.ext_y
        canvas_w = max(lv.w for lv in levels) + 1
        ny, nx, valid, level_id = self._grid_meta(levels, canvas_h, canvas_w)
        np_mats = [(_resize_matrix(h, lv.h).astype(np.float64),
                    _resize_matrix(w, lv.w).astype(np.float64))
                   for lv in levels]
        dtype = (torch.float32 if h * w * 255.0 <= F32_EXACT_SUM
                 else torch.float64)
        mats = [(torch.from_numpy(mh).to(self.device, dtype),
                 torch.from_numpy(np.ascontiguousarray(mw.T)).to(
                     self.device, dtype)) for mh, mw in np_mats]
        plan = _Plan(levels, canvas_h, canvas_w, ny, nx, level_id, np_mats,
                     dtype, torch.from_numpy(valid.astype(np.int8)).to(
                         self.device), mats, self._stage_tables(dtype))
        self._plans[key] = plan
        return plan

    def _canvases(self, plan: _Plan, frames_u8: torch.Tensor):
        """(T, h, w) uint8 on the device -> the packed integral canvases
        ii, ii2 (T, canvas_h, canvas_w) in the plan's type. Each level is
        rows-then-columns resized, integrated by two cumsums, and written
        behind a zero row and column at its block's offset. ii2 integrates
        (g - 128)^2: window variance is shift-invariant, and the offset
        keeps the sums four times smaller, so float32 corners round less;
        the stage arithmetic uses (mean - 128) to match."""
        t = frames_u8.shape[0]
        grays = frames_u8.to(plan.dtype)
        shape = (t, plan.canvas_h, plan.canvas_w)
        ii = torch.zeros(shape, dtype=plan.dtype, device=self.device)
        ii2 = torch.zeros(shape, dtype=plan.dtype, device=self.device)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for lv, (mh, mw_t) in zip(plan.levels, plan.mats):
                g = torch.matmul(torch.matmul(mh, grays), mw_t)
                rows = slice(lv.row + 1, lv.row + 1 + lv.h)
                cols = slice(1, 1 + lv.w)
                ii[:, rows, cols] = torch.cumsum(torch.cumsum(g, 1), 2)
                gc = g - 128.0
                ii2[:, rows, cols] = torch.cumsum(torch.cumsum(gc * gc, 1), 2)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return ii, ii2

    @staticmethod
    def frames_per_dispatch(plan: _Plan) -> int:
        """Frames whose two canvases fit MAX_CANVAS_BYTES: one K3 launch."""
        per_frame = 2 * plan.canvas_h * plan.canvas_w * (
            4 if plan.dtype == torch.float32 else 8)
        return max(1, MAX_CANVAS_BYTES // per_frame)

    def early_mask(self, frames_u8: np.ndarray) -> Optional[torch.Tensor]:
        """(T, h, w) uint8 -> the early stages' alive mask (T, ny, nx) int8
        on the device, frames in chunks of at most MAX_CANVAS_BYTES of
        canvas; None when the frame is smaller than the window."""
        t, h, w = frames_u8.shape
        plan = self._plan(h, w)
        if plan is None:
            return None
        step = self.frames_per_dispatch(plan)
        masks = []
        for i in range(0, t, step):
            chunk = torch.from_numpy(
                np.ascontiguousarray(frames_u8[i:i + step])).to(self.device)
            ii, ii2 = self._canvases(plan, chunk)
            masks.append(haar_stages(ii, ii2, plan.valid, plan.tables,
                                     self.early_stages, self.stride))
        return masks[0] if len(masks) == 1 else torch.cat(masks)

    # -- deep stages: host early-exit evaluator over survivors -----------

    def _host_deep(self):
        """(gray_f64, xs, ys, need_levels, levels, np_mats, canvas_h, w) ->
        pass mask for stages [early_stages, end) over survivor windows in
        canvas coordinates. The C++ evaluator (native/haarcascade.cpp
        gifgan_haar_eval_pyramid) resamples the needed pyramid levels with
        the same triangle kernel as the device program and early-exits per
        window."""
        if self._deep_eval is not None:
            return self._deep_eval
        lib, handle, keep = make_native_cascade_handle(self.cas)
        if not hasattr(lib, "gifgan_haar_eval_pyramid"):
            lib.gifgan_haar_free(handle)
            raise RuntimeError("native library too old; rebuild it "
                               "(make -C native clean all)")
        self._native = (lib, handle, keep)

        def ev(g64, xs, ys, need, levels, np_mats, canvas_h, w):
            lh = np.asarray([levels[li].h for li in need], np.int32)
            lw = np.asarray([levels[li].w for li in need], np.int32)
            lrow = np.asarray([levels[li].row for li in need], np.int32)
            out = np.zeros(len(xs), np.uint8)
            lib.gifgan_haar_eval_pyramid(
                handle, np.ascontiguousarray(g64, np.float64),
                g64.shape[0], g64.shape[1], lh, lw, lrow, len(need),
                int(canvas_h), np.ascontiguousarray(xs, np.int32),
                np.ascontiguousarray(ys, np.int32), len(xs),
                int(self.early_stages), out)
            return out.astype(bool)

        self._deep_eval = ev
        return ev

    def __del__(self):
        native = getattr(self, "_native", None)
        if native:
            lib, handle, _ = native
            try:
                lib.gifgan_haar_free(handle)
            except Exception:
                pass
            self._native = None

    # -- public API ------------------------------------------------------

    def detect_batch(self, grays: np.ndarray) -> List[np.ndarray]:
        """grays: (T, H, W) float in [0, 255]. Returns T (M, 4) x,y,w,h
        arrays in original image coordinates."""
        grays = np.asarray(grays)
        t, h, w = grays.shape
        rounded = np.clip(np.rint(grays), 0, 255).astype(np.uint8)
        mask = self.early_mask(rounded)
        if mask is None:
            return [np.zeros((0, 4), np.int32) for _ in range(t)]
        plan = self._plan(h, w)
        levels, level_id = plan.levels, plan.level_id
        # survivors compacted on the card; (n, 3) [frame, gy, gx] in
        # row-major order
        idx = torch.nonzero(mask).cpu().numpy()
        fi, gy, gx = idx[:, 0], idx[:, 1], idx[:, 2]
        candidates: List[List[tuple]] = [[] for _ in range(t)]
        if len(fi):
            st = self.stride
            cas = self.cas
            deep = self._host_deep()
            lids = level_id[gy, gx]
            # one finisher call per frame covers every scale: the canvas
            # mirrors the device row layout (level k's image at rows
            # lv.row..lv.row+lv.h) so rect sums stay block-local; only
            # the levels this frame's survivors touch get resampled
            for fr in np.unique(fi):
                sel = fi == fr
                ok = deep(rounded[fr].astype(np.float64), gx[sel] * st,
                          gy[sel] * st, np.unique(lids[sel]), levels,
                          plan.np_mats, plan.canvas_h, w)
                for gyi, gxi in zip(gy[sel][ok], gx[sel][ok]):
                    lv = levels[level_id[gyi, gxi]]
                    lx = gxi * st
                    ly = gyi * st - lv.row
                    candidates[fr].append((
                        int(round(lx * lv.scale)), int(round(ly * lv.scale)),
                        int(round(cas.window_w * lv.scale)),
                        int(round(cas.window_h * lv.scale))))
        return [group_rectangles(np.asarray(c, np.int64).reshape(-1, 4),
                                 self.min_neighbors) for c in candidates]

    def detect_rects(self, gray: np.ndarray) -> np.ndarray:
        return self.detect_batch(np.asarray(gray)[None])[0]

    def detect_clips(self, clips: List[np.ndarray],
                     pad_multiple: int = 32) -> List[List[np.ndarray]]:
        """N clips through one detect_batch: every clip is letterbox-padded
        (bottom/right, black) onto a common canvas whose sides round up to
        `pad_multiple`, and the frames of all clips stack on the batch
        axis. (The JAX package also rounds the frame count up with black
        frames so that repeat calls reuse one compiled program; nothing is
        compiled here, so exactly the clips' frames are stacked.)

        clips: list of (T_i, H_i, W_i) float [0, 255] grayscale stacks.
        Returns, per clip, T_i arrays of (M, 4) x,y,w,h rects; windows
        extending into the padding are dropped (they straddle content and
        black border). Scale planning follows the padded canvas, so rects
        are statistically, not bit-, identical to per-clip detect_batch."""
        if not clips:
            return []
        clips = [np.asarray(c) for c in clips]
        per_frame = self.detect_batch(letterbox_stack(clips, pad_multiple))
        out: List[List[np.ndarray]] = []
        row = 0
        for c in clips:
            t_i, h_i, w_i = c.shape
            frames = []
            for rects in per_frame[row:row + t_i]:
                if len(rects):
                    keep = ((rects[:, 0] >= 0) & (rects[:, 1] >= 0)
                            & (rects[:, 0] + rects[:, 2] <= w_i)
                            & (rects[:, 1] + rects[:, 3] <= h_i))
                    rects = rects[keep]
                frames.append(rects)
            out.append(frames)
            row += t_i
        return out

    def detect_video(self, frames_rgb: np.ndarray):
        from gifgan_tpu_torch.track.boxes import Detection

        grays = (np.dot(frames_rgb[..., :3].astype(np.float64),
                        [0.299, 0.587, 0.114])
                 if frames_rgb.ndim == 4 else frames_rgb.astype(np.float64))
        rect_lists = self.detect_batch(grays)
        return [[Detection.from_rect(r, i) for r in rects]
                for i, rects in enumerate(rect_lists)]

    def __call__(self, frame: np.ndarray, frame_number: int = 0):
        from gifgan_tpu_torch.track.boxes import Detection

        gray = (np.dot(frame[..., :3].astype(np.float64),
                       [0.299, 0.587, 0.114])
                if frame.ndim == 3 and frame.shape[-1] >= 3
                else frame.astype(np.float64))
        rects = self.detect_rects(gray)
        return [Detection.from_rect(r, frame_number) for r in rects]
