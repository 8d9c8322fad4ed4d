"""Haar-cascade face detection on the host (numpy and the shared native C++).

The port of gifgan_tpu/track/haar.py's host side: the cascade parser, the
integral images, the feature-scaled evaluator and the rectangle grouping, in
float64 numpy with results equal to the JAX package's, and the binding of the
C++ early-exit evaluator in native/haarcascade.cpp (shared with the JAX
package, built with `make -C native` at first use).

  - `parse_cascade` reads a standard OpenCV new-format cascade XML
    (opencv-cascade-classifier, BOOST stages of depth-2 trees over HAAR rect
    features). The trained cascade is model data the user supplies (e.g.
    OpenCV's haarcascade_frontalface_alt2.xml); track/synthetic_cascade.py
    writes a seeded one for the tests.
  - Multi-scale sliding windows: rects are scaled per pyramid level (with
    OpenCV's first-rect weight re-balancing), features evaluated on the
    variance-normalized window: pass iff the sum of tree leaf values reaches
    the stage threshold in every stage.
  - `group_rectangles` follows cv2.groupRectangles.

The detector that runs on the card by default is track/haar_device.py. The
gather detectors here (GatherStageEvaluator, GatherHaarDetector,
BatchedGatherHaarDetector: the JAX package's JaxStageEvaluator,
JaxHaarDetector, BatchedJaxHaarDetector) run the early stages of every
window in one device program of plain PyTorch gathers and finish the
survivors on the host; as in the JAX package, they are reached by name
only, never from detect.default_detector.
"""

from __future__ import annotations

import math
import threading
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class HaarCascade:
    window_w: int
    window_h: int
    # features: (F, 3, 5) [x, y, w, h, weight]; unused rects zero-weight
    rects: np.ndarray
    n_rects: np.ndarray          # (F,)
    # trees: exactly 2 nodes each (padded), 3 leaves
    node_feat: np.ndarray        # (T, 2) feature index per node
    node_thr: np.ndarray         # (T, 2)
    node_left: np.ndarray        # (T, 2) child code: >0 internal idx, <=0 leaf -v
    node_right: np.ndarray       # (T, 2)
    leaves: np.ndarray           # (T, 4) leaf values (padded)
    stage_first: np.ndarray      # (S,)
    stage_count: np.ndarray      # (S,)
    stage_thr: np.ndarray        # (S,)


def parse_cascade(xml_path: str) -> HaarCascade:
    root = ET.parse(xml_path).getroot()
    cas = root.find("cascade")
    assert cas is not None, "not an opencv-cascade-classifier file"
    assert cas.findtext("featureType").strip() == "HAAR"
    w = int(cas.findtext("width"))
    h = int(cas.findtext("height"))

    feats = []
    for f in cas.find("features"):
        rects = []
        for r in f.find("rects"):
            vals = [float(v) for v in r.text.split()]
            rects.append(vals)  # x y w h weight
        while len(rects) < 3:
            rects.append([0, 0, 0, 0, 0.0])
        feats.append(rects[:3])
    rects = np.asarray(feats, np.float64)  # (F, 3, 5)
    n_rects = (rects[:, :, 4] != 0).sum(axis=1).astype(np.int32)

    node_feat, node_thr, node_left, node_right, leaves = [], [], [], [], []
    stage_first, stage_count, stage_thr = [], [], []
    for stage in cas.find("stages"):
        stage_thr.append(float(stage.findtext("stageThreshold")))
        stage_first.append(len(node_feat))
        count = 0
        for wc in stage.find("weakClassifiers"):
            ints = wc.findtext("internalNodes").split()
            lvs = [float(v) for v in wc.findtext("leafValues").split()]
            nodes = [ints[i:i + 4] for i in range(0, len(ints), 4)]
            assert len(nodes) <= 2, "only depth-2 trees supported"
            nf, nt, nl, nr = [0, 0], [np.inf, np.inf], [0, 0], [0, 0]
            for i, (l, r, fi, th) in enumerate(nodes):
                nl[i], nr[i] = int(l), int(r)
                nf[i], nt[i] = int(fi), float(th)
            if len(nodes) == 1:
                # pad: node1 never reached (children of node0 are leaves)
                nf[1], nt[1] = 0, np.inf
            while len(lvs) < 4:
                lvs.append(0.0)
            node_feat.append(nf)
            node_thr.append(nt)
            node_left.append(nl)
            node_right.append(nr)
            leaves.append(lvs[:4])
            count += 1
        stage_count.append(count)

    return HaarCascade(
        window_w=w, window_h=h,
        rects=rects, n_rects=n_rects,
        node_feat=np.asarray(node_feat, np.int32),
        node_thr=np.asarray(node_thr, np.float64),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        leaves=np.asarray(leaves, np.float64),
        stage_first=np.asarray(stage_first, np.int32),
        stage_count=np.asarray(stage_count, np.int32),
        stage_thr=np.asarray(stage_thr, np.float64),
    )


def integral_images(gray: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-padded integral and squared-integral images, (H+1, W+1)."""
    g = gray.astype(np.float64)
    ii = np.zeros((g.shape[0] + 1, g.shape[1] + 1), np.float64)
    ii[1:, 1:] = g.cumsum(0).cumsum(1)
    ii2 = np.zeros_like(ii)
    ii2[1:, 1:] = (g * g).cumsum(0).cumsum(1)
    return ii, ii2


def _scaled_rects(cas: HaarCascade, scale: float):
    """Scale+round feature rects to a pyramid level, rebalancing the first
    rect's weight so weighted areas still cancel (OpenCV behavior)."""
    r = cas.rects
    sr = np.empty_like(r)
    sr[:, :, 0] = np.round(r[:, :, 0] * scale)
    sr[:, :, 1] = np.round(r[:, :, 1] * scale)
    sr[:, :, 2] = np.round(r[:, :, 2] * scale)
    sr[:, :, 3] = np.round(r[:, :, 3] * scale)
    sr[:, :, 4] = r[:, :, 4]
    area = sr[:, :, 2] * sr[:, :, 3]
    # weight0 = -sum_{i>0} w_i*area_i / area_0
    rest = (sr[:, 1:, 4] * area[:, 1:]).sum(axis=1)
    a0 = np.where(area[:, 0] > 0, area[:, 0], 1.0)
    sr[:, 0, 4] = -rest / a0
    return sr


def _rect_sums(ii: np.ndarray, xs: np.ndarray, ys: np.ndarray,
               rects: np.ndarray) -> np.ndarray:
    """Feature values for windows at (xs, ys): (W,) x (F, 3, 5) -> (W, F)."""
    rx = rects[None, :, :, 0].astype(np.int64)
    ry = rects[None, :, :, 1].astype(np.int64)
    rw = rects[None, :, :, 2].astype(np.int64)
    rh = rects[None, :, :, 3].astype(np.int64)
    wt = rects[None, :, :, 4]
    x1 = xs[:, None, None] + rx
    y1 = ys[:, None, None] + ry
    x2 = x1 + rw
    y2 = y1 + rh
    s = (ii[y1, x1] + ii[y2, x2] - ii[y1, x2] - ii[y2, x1])
    return (s * wt).sum(axis=2)


def _eval_stages(cas: HaarCascade, ii, ii2, xs, ys, scale: float,
                 stage_lo: int, stage_hi: int,
                 rects_scaled: np.ndarray) -> np.ndarray:
    """Evaluate stages [lo, hi) for windows at (xs, ys); returns pass mask."""
    ww = int(round(cas.window_w * scale))
    wh = int(round(cas.window_h * scale))
    inv_area = 1.0 / (ww * wh)
    s1 = (ii[ys, xs] + ii[ys + wh, xs + ww]
          - ii[ys, xs + ww] - ii[ys + wh, xs])
    s2 = (ii2[ys, xs] + ii2[ys + wh, xs + ww]
          - ii2[ys, xs + ww] - ii2[ys + wh, xs])
    mean = s1 * inv_area
    var = s2 * inv_area - mean * mean
    nf = np.where(var > 0, np.sqrt(np.maximum(var, 0)), 1.0)

    t0 = cas.stage_first[stage_lo]
    t1 = cas.stage_first[stage_hi - 1] + cas.stage_count[stage_hi - 1]
    feats_needed = np.unique(cas.node_feat[t0:t1].ravel())
    fmap = np.full(cas.rects.shape[0], -1, np.int64)
    fmap[feats_needed] = np.arange(len(feats_needed))
    fvals = _rect_sums(ii, xs, ys, rects_scaled[feats_needed])  # (W, Fsub)
    fvals = fvals * inv_area

    alive = np.ones(len(xs), bool)
    for s in range(stage_lo, stage_hi):
        a, b = cas.stage_first[s], cas.stage_first[s] + cas.stage_count[s]
        total = np.zeros(len(xs))
        for t in range(a, b):
            f0 = fvals[:, fmap[cas.node_feat[t, 0]]]
            go_left0 = f0 < cas.node_thr[t, 0] * nf
            child = np.where(go_left0, cas.node_left[t, 0],
                             cas.node_right[t, 0])
            # child > 0 -> internal node 1; <= 0 -> leaf -child
            f1 = fvals[:, fmap[cas.node_feat[t, 1]]]
            go_left1 = f1 < cas.node_thr[t, 1] * nf
            leaf_from_n1 = np.where(go_left1, -cas.node_left[t, 1],
                                    -cas.node_right[t, 1])
            leaf_idx = np.where(child <= 0, -child, leaf_from_n1)
            total += cas.leaves[t][leaf_idx]
        alive &= total >= cas.stage_thr[s]
        if not alive.any():
            break
    return alive


def group_rectangles(boxes: np.ndarray, min_neighbors: int,
                     eps: float = 0.2) -> np.ndarray:
    """cv2.groupRectangles semantics: boxes (N, 4) as x,y,w,h; cluster boxes
    whose edges are within eps-relative distance, keep clusters with
    STRICTLY MORE than min_neighbors members (OpenCV eliminates clusters
    "smaller or equal to groupThreshold"), return averaged boxes.
    min_neighbors=0 returns the boxes ungrouped (cv2 behavior)."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 4), np.int32)
    if min_neighbors <= 0:
        return np.asarray(boxes, np.int32).reshape(-1, 4)
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    b = boxes.astype(np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            delta = eps * (min(b[i, 2], b[j, 2]) + min(b[i, 3], b[j, 3])) * 0.5
            if (abs(b[i, 0] - b[j, 0]) <= delta
                    and abs(b[i, 1] - b[j, 1]) <= delta
                    and abs(b[i, 0] + b[i, 2] - b[j, 0] - b[j, 2]) <= delta
                    and abs(b[i, 1] + b[i, 3] - b[j, 1] - b[j, 3]) <= delta):
                pi, pj = find(i), find(j)
                if pi != pj:
                    parent[pj] = pi
    roots = np.array([find(i) for i in range(n)])
    out = []
    for root in np.unique(roots):
        members = b[roots == root]
        if len(members) > min_neighbors:
            out.append(np.round(members.mean(axis=0)))
    return np.asarray(out, np.int32).reshape(-1, 4)


def _window_origins(cas: HaarCascade, scale: float, h: int, w: int):
    """(ww, wh, scaled rects, xs, ys) of one pyramid scale's window grid
    on an (h, w) image, stride max(2, round(scale))."""
    ww = int(round(cas.window_w * scale))
    wh = int(round(cas.window_h * scale))
    stride = max(2, int(round(scale)))
    rs = _scaled_rects(cas, scale)
    # rounding can push a scaled rect a pixel past the nominal window;
    # bound origins by the true max extent so integral lookups stay in
    # range while still scanning the last window
    ext_x = int(max(ww, (rs[:, :, 0] + rs[:, :, 2]).max()))
    ext_y = int(max(wh, (rs[:, :, 1] + rs[:, :, 3]).max()))
    gx, gy = np.meshgrid(np.arange(0, w - ext_x + 1, stride),
                         np.arange(0, h - ext_y + 1, stride))
    return ww, wh, rs, gx.ravel(), gy.ravel()


class HaarDetector:
    """Face detector with detectMultiScale-like parameters: the pure-numpy
    feature-scaled evaluator, all windows through the first `early_stages`
    stages, the survivors through the rest. Returns Detections."""

    def __init__(self, cascade_path: str, scale_factor: float = 1.1,
                 min_neighbors: int = 3, min_size: int = 20,
                 max_size_factor: float = 1.0,
                 early_stages: int = 6):
        if scale_factor <= 1.0:
            raise ValueError(
                f"scale_factor must be > 1.0, got {scale_factor} "
                "(the scale loop multiplies by it until the window "
                "outgrows the image; <= 1.0 never terminates)")
        self.cas = parse_cascade(cascade_path)
        self.scale_factor = scale_factor
        self.min_neighbors = min_neighbors
        self.min_size = min_size
        self.max_size_factor = max_size_factor
        self.early_stages = min(early_stages, len(self.cas.stage_thr))

    def detect_rects(self, gray: np.ndarray) -> np.ndarray:
        cas = self.cas
        h, w = gray.shape[:2]
        side = math.sqrt(h * w)
        max_len = side * self.max_size_factor
        ii, ii2 = integral_images(gray)

        candidates = []
        scale = max(self.min_size / cas.window_w, 1.0)
        while True:
            ww, wh, rs, xs, ys = _window_origins(cas, scale, h, w)
            if ww > min(w, max_len) or wh > min(h, max_len):
                break
            if len(xs):
                alive = _eval_stages(cas, ii, ii2, xs, ys, scale, 0,
                                     self.early_stages, rs)
                if alive.any():
                    xs2, ys2 = xs[alive], ys[alive]
                    alive2 = _eval_stages(cas, ii, ii2, xs2, ys2, scale,
                                          self.early_stages,
                                          len(cas.stage_thr), rs)
                    for x, y in zip(xs2[alive2], ys2[alive2]):
                        candidates.append((x, y, ww, wh))
            scale *= self.scale_factor
        return group_rectangles(np.asarray(candidates, np.int64)
                                .reshape(-1, 4), self.min_neighbors)

    def __call__(self, frame: np.ndarray, frame_number: int = 0):
        from gifgan_tpu_torch.track.boxes import Detection

        gray = (np.dot(frame[..., :3].astype(np.float64),
                       [0.299, 0.587, 0.114])
                if frame.ndim == 3 and frame.shape[-1] >= 3
                else frame.astype(np.float64))
        rects = self.detect_rects(gray)
        return [Detection.from_rect(r, frame_number) for r in rects]


# ---------------------------------------------------------------------------
# Gather evaluation on the device: the early (cheap) stages for all windows
# run as one program of plain PyTorch ops (no hand-written kernel: the JAX
# package's version is XLA code, not Pallas). Features are gathered from the
# float32 integral images in bulk, every tree is evaluated at once, the
# stage sums are one product with a stage-indicator matrix; the few
# survivors go through the deep stages on the host in float64. The JAX
# package pads window counts to power-of-two buckets so XLA compiles once a
# bucket; eager PyTorch compiles nothing, and padded windows are masked out
# there, so the buckets are not kept.
# ---------------------------------------------------------------------------

_tf32_lock = threading.Lock()


def _stage_sums(vals, stage_ind):
    """(..., W, T) leaf values @ (T, S) indicator in full float32 (TF32
    would round the leaf values the stage thresholds are compared with)."""
    import torch

    if not vals.is_cuda:
        return vals @ stage_ind
    with _tf32_lock:     # the flag is process-wide
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return vals @ stage_ind
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32


class GatherStageEvaluator:
    """Stages [0, stage_hi) of `cas` for many windows at once on `device`
    (the JAX package's JaxStageEvaluator). Call with float32 integral images
    (H+1, W+1), or a stack of them (N, H+1, W+1) sharing one window grid,
    and the window origins; returns the alive mask, (W,) or (N, W)."""

    def __init__(self, cas: HaarCascade, stage_hi: int, device=None):
        import torch

        from gifgan_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.cas = cas
        t1 = cas.stage_first[stage_hi - 1] + cas.stage_count[stage_hi - 1]
        self.n_trees = int(t1)
        feats = np.unique(cas.node_feat[:t1].ravel())
        self.feats = feats
        fmap = np.full(cas.rects.shape[0], -1, np.int64)
        fmap[feats] = np.arange(len(feats))

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self.local_feat = dev(fmap[cas.node_feat[:t1]], torch.int64)
        self.node_thr = dev(cas.node_thr[:t1], torch.float32)
        self.node_left = dev(cas.node_left[:t1], torch.int64)
        self.node_right = dev(cas.node_right[:t1], torch.int64)
        self.leaves = dev(cas.leaves[:t1], torch.float32)
        ind = np.zeros((self.n_trees, stage_hi), np.float32)
        for s in range(stage_hi):
            a = cas.stage_first[s]
            ind[a:a + cas.stage_count[s], s] = 1.0
        self.stage_ind = dev(ind, torch.float32)
        self.stage_thr = dev(cas.stage_thr[:stage_hi], torch.float32)
        self._rects = {}

    def _scale_rects(self, scale: float):
        """The needed features' rects at `scale` on the device, cached."""
        import torch

        if scale not in self._rects:
            rs = _scaled_rects(self.cas, scale)[self.feats]  # (Fsub, 3, 5)
            to = lambda a, dt: torch.as_tensor(
                np.ascontiguousarray(a), dtype=dt, device=self.device)
            self._rects[scale] = (
                to(rs[:, :, 0], torch.int64), to(rs[:, :, 1], torch.int64),
                to(rs[:, :, 2], torch.int64), to(rs[:, :, 3], torch.int64),
                to(rs[:, :, 4], torch.float32))
        return self._rects[scale]

    def __call__(self, ii, ii2, xs: np.ndarray, ys: np.ndarray,
                 scale: float) -> np.ndarray:
        import torch

        cas = self.cas
        ii = torch.as_tensor(ii, dtype=torch.float32).to(self.device)
        ii2 = torch.as_tensor(ii2, dtype=torch.float32).to(self.device)
        single = ii.ndim == 2
        if single:
            ii, ii2 = ii[None], ii2[None]
        rx, ry, rw, rh, wt = self._scale_rects(scale)
        ww = int(round(cas.window_w * scale))
        wh = int(round(cas.window_h * scale))
        inv_area = 1.0 / (ww * wh)
        xs = torch.as_tensor(np.asarray(xs, np.int64), device=self.device)
        ys = torch.as_tensor(np.asarray(ys, np.int64), device=self.device)

        # window normalization factor, (N, W)
        s1 = (ii[:, ys, xs] + ii[:, ys + wh, xs + ww]
              - ii[:, ys, xs + ww] - ii[:, ys + wh, xs])
        s2 = (ii2[:, ys, xs] + ii2[:, ys + wh, xs + ww]
              - ii2[:, ys, xs + ww] - ii2[:, ys + wh, xs])
        mean = s1 * inv_area
        var = s2 * inv_area - mean * mean
        one = torch.ones((), device=self.device)
        nf = torch.where(var > 0, torch.sqrt(torch.clamp(var, min=0.0)), one)

        # feature values, (N, W, Fsub): the three rects summed in order
        x1 = xs[:, None, None] + rx
        y1 = ys[:, None, None] + ry
        x2, y2 = x1 + rw, y1 + rh
        sums = (ii[:, y1, x1] + ii[:, y2, x2] - ii[:, y1, x2]
                - ii[:, y2, x1]) * wt
        fvals = (sums[..., 0] + sums[..., 1] + sums[..., 2]) * inv_area

        lf, thr = self.local_feat, self.node_thr
        nl, nr = self.node_left, self.node_right
        f0 = fvals[:, :, lf[:, 0]]                          # (N, W, T)
        f1 = fvals[:, :, lf[:, 1]]
        nfc = nf[:, :, None]
        child = torch.where(f0 < thr[:, 0] * nfc, nl[:, 0], nr[:, 0])
        leaf_n1 = torch.where(f1 < thr[:, 1] * nfc, -nl[:, 1], -nr[:, 1])
        leaf_idx = torch.where(child <= 0, -child, leaf_n1)
        tree = torch.arange(self.n_trees, device=self.device)
        vals = self.leaves[tree, leaf_idx]                  # (N, W, T)
        stage_sums = _stage_sums(vals, self.stage_ind)      # (N, W, S)
        alive = torch.all(stage_sums >= self.stage_thr, dim=-1).cpu().numpy()
        return alive[0] if single else alive


class GatherHaarDetector(HaarDetector):
    """HaarDetector with the early stages of all windows evaluated on
    `device` (the card by default) by GatherStageEvaluator, the survivors
    finished on the host (the JAX package's JaxHaarDetector). The same
    detections as the numpy path, float32 against float64 rounding aside.
    Frames whose float32 integral image would pass 2^24 (h * w * 255) take
    the float64 numpy path, as in the JAX package."""

    def __init__(self, *args, device=None, **kwargs):
        from gifgan_tpu_torch import resolve_device

        device = resolve_device(device)      # no card: raises here
        super().__init__(*args, **kwargs)
        self._gather_eval = GatherStageEvaluator(self.cas, self.early_stages,
                                                 device=device)

    def _candidates(self, grays: np.ndarray):
        """Per frame of a (N, H, W) stack, the windows passing every stage:
        one device evaluation a scale for all frames, then each frame's
        survivors through the deep stages on the host."""
        cas = self.cas
        n, h, w = grays.shape
        max_len = math.sqrt(h * w) * self.max_size_factor
        host = [integral_images(g) for g in grays]
        iis = np.stack([a for a, _ in host]).astype(np.float32)
        ii2s = np.stack([b for _, b in host]).astype(np.float32)
        candidates = [[] for _ in range(n)]
        scale = max(self.min_size / cas.window_w, 1.0)
        while True:
            ww, wh, rs, xs, ys = _window_origins(cas, scale, h, w)
            if ww > min(w, max_len) or wh > min(h, max_len):
                break
            if len(xs):
                alive = self._gather_eval(iis, ii2s, xs, ys, scale)
                for fi in np.nonzero(alive.any(axis=1))[0]:
                    xs2, ys2 = xs[alive[fi]], ys[alive[fi]]
                    ii, ii2 = host[fi]
                    deep = _eval_stages(cas, ii, ii2, xs2, ys2, scale,
                                        self.early_stages,
                                        len(cas.stage_thr), rs)
                    for x, y in zip(xs2[deep], ys2[deep]):
                        candidates[fi].append((x, y, ww, wh))
            scale *= self.scale_factor
        return [group_rectangles(np.asarray(c, np.int64).reshape(-1, 4),
                                 self.min_neighbors) for c in candidates]

    def detect_rects(self, gray: np.ndarray) -> np.ndarray:
        h, w = gray.shape[:2]
        if h * w * 255.0 > 2 ** 24:
            return super().detect_rects(gray)
        return self._candidates(np.asarray(gray)[None])[0]


class BatchedGatherHaarDetector(GatherHaarDetector):
    """Video-rate detection (the JAX package's BatchedJaxHaarDetector): the
    early stages for all frames of a clip in one device program a scale
    (the frames share the window grid), the survivors finished per frame
    on the host. `detect_batch` takes (T, H, W) grays; `detect_video`
    (T, H, W, C) uint8 frames."""

    def detect_batch(self, grays: np.ndarray):
        """grays: (T, H, W) float. Returns a list of T (M_t, 4) rect
        arrays."""
        t, h, w = grays.shape
        if h * w * 255.0 > 2 ** 24:   # float32 precision limit: float64
            return [HaarDetector.detect_rects(self, g) for g in grays]
        return self._candidates(grays)

    def detect_video(self, frames_rgb: np.ndarray):
        """frames (T, H, W, C) uint8 -> list of per-frame Detection lists."""
        from gifgan_tpu_torch.track.boxes import Detection

        grays = np.dot(frames_rgb[..., :3].astype(np.float64),
                       [0.299, 0.587, 0.114])
        rect_lists = self.detect_batch(grays)
        return [[Detection.from_rect(r, i) for r in rects]
                for i, rects in enumerate(rect_lists)]


def make_native_cascade_handle(cas: HaarCascade):
    """(lib, handle, keepalive) for the C++ cascade evaluator
    (native/haarcascade.cpp). Caller must lib.gifgan_haar_free(handle) and
    hold `keepalive` (the arrays the C side reads) as long as the handle
    lives. Raises RuntimeError when the native library is unavailable."""
    import ctypes

    from gifgan_tpu_torch.data.native_gif import _load

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (make -C native "
                           "failed)")
    if not hasattr(lib, "gifgan_haar_create"):
        raise RuntimeError("native library too old; rebuild")
    lib.gifgan_haar_create.restype = ctypes.c_void_p
    lib.gifgan_haar_detect.restype = ctypes.c_int
    # without explicit argtypes ctypes passes the 64-bit handle as a
    # truncated C int — freeing a garbage pointer
    lib.gifgan_haar_free.argtypes = [ctypes.c_void_p]
    lib.gifgan_haar_free.restype = None
    c_int_p = np.ctypeslib.ndpointer(np.int32, flags="C")
    c_dbl_p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.gifgan_haar_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, c_dbl_p,
        ctypes.c_int, c_int_p, c_dbl_p, c_int_p, c_int_p, c_dbl_p,
        ctypes.c_int, c_int_p, c_int_p, c_dbl_p]
    lib.gifgan_haar_detect.argtypes = [
        ctypes.c_void_p, c_dbl_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C,WRITEABLE"),
        ctypes.c_int]
    if hasattr(lib, "gifgan_haar_eval_pyramid"):
        lib.gifgan_haar_eval_pyramid.restype = None
        lib.gifgan_haar_eval_pyramid.argtypes = [
            ctypes.c_void_p, c_dbl_p, ctypes.c_int, ctypes.c_int,
            c_int_p, c_int_p, c_int_p, ctypes.c_int, ctypes.c_int,
            c_int_p, c_int_p, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C,WRITEABLE")]
    # replace inf padding (unreached node 1) with a huge finite value
    thr = np.where(np.isfinite(cas.node_thr), cas.node_thr, 1e30)
    keepalive = (
        np.ascontiguousarray(cas.rects, np.float64),
        np.ascontiguousarray(cas.node_feat, np.int32),
        np.ascontiguousarray(thr, np.float64),
        np.ascontiguousarray(cas.node_left, np.int32),
        np.ascontiguousarray(cas.node_right, np.int32),
        np.ascontiguousarray(cas.leaves, np.float64),
        np.ascontiguousarray(cas.stage_first, np.int32),
        np.ascontiguousarray(cas.stage_count, np.int32),
        np.ascontiguousarray(cas.stage_thr, np.float64),
    )
    k = keepalive
    handle = lib.gifgan_haar_create(
        cas.window_w, cas.window_h, cas.rects.shape[0], k[0],
        len(cas.node_feat), k[1], k[2], k[3], k[4], k[5],
        len(cas.stage_thr), k[6], k[7], k[8])
    return lib, handle, keepalive


class NativeHaarDetector(HaarDetector):
    """C++ early-exit cascade evaluator (native/haarcascade.cpp) — the
    per-window branchy loop the CPU does best: windows die after the first
    failed stage instead of evaluating all trees. Same cascade arrays and
    rounding as the numpy path; cross-checked in tests."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lib, self._handle, self._keepalive = \
            make_native_cascade_handle(self.cas)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        lib = getattr(self, "_lib", None)
        if handle and lib is not None:
            try:
                lib.gifgan_haar_free(handle)
            except Exception:
                pass
            self._handle = None

    def detect_rects(self, gray: np.ndarray) -> np.ndarray:
        g = np.ascontiguousarray(gray, np.float64)
        out = np.zeros((256, 4), np.int32)
        n = self._lib.gifgan_haar_detect(
            self._handle, g, g.shape[0], g.shape[1],
            float(self.scale_factor), int(self.min_size),
            float(self.max_size_factor), int(self.min_neighbors),
            out.reshape(-1), 256)
        return out[:n].copy()
