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

The detector that runs on the card is track/haar_device.py. The gather-based
JaxStageEvaluator / JaxHaarDetector / BatchedJaxHaarDetector of the JAX
package have no counterpart here yet (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import math
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
            ww = int(round(cas.window_w * scale))
            wh = int(round(cas.window_h * scale))
            if ww > min(w, max_len) or wh > min(h, max_len):
                break
            stride = max(2, int(round(scale)))
            rs = _scaled_rects(cas, scale)
            # rounding can push a scaled rect a pixel past the nominal
            # window; bound origins by the true max extent so integral
            # lookups stay in range while still scanning the last window
            ext_x = int(max(ww, (rs[:, :, 0] + rs[:, :, 2]).max()))
            ext_y = int(max(wh, (rs[:, :, 1] + rs[:, :, 3]).max()))
            xs0 = np.arange(0, w - ext_x + 1, stride)
            ys0 = np.arange(0, h - ext_y + 1, stride)
            gx, gy = np.meshgrid(xs0, ys0)
            xs, ys = gx.ravel(), gy.ravel()
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
