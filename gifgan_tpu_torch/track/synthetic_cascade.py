"""A Haar cascade made from a seed: the cascade's counterpart of
data/synthetic.py.

The trained cascade the detectors are written for (OpenCV's
haarcascade_frontalface_alt2.xml) is model data the user supplies; it is not
in the repository. The tests and chip_smoke.py need a cascade all the same,
so `write_cascade` writes one: an OpenCV new-format XML that
track/haar.py parse_cascade reads, with alt2's shape (a 20x20 window,
`ALT2_STAGES` trees per stage, every tree two nodes and three leaves, two-
and three-rectangle features with balanced weights inside the window), fitted
with numpy to one fixed pattern, the glyph of `glyph_image`: a bright
freckled face with two dark eyes, a dark mouth and a lighter forehead inside
a black margin. It finds that glyph over a range of shifts and scales and
rejects noise, edges, flat windows and misplaced glyphs.

The fit is a small boosting loop, not a trainer for users: candidate
features are drawn from the seed, each node keeps the candidate whose
midpoint threshold separates the jittered glyph windows from the negatives
still alive best, leaves get the weighted log odds, and each stage's
threshold sits just under the lowest total of a glyph window.
`SMALL_STAGES` gives a cascade of 116 trees for the CPU tests. The CLI does
not expose this module.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

WINDOW = 20
# trees per stage of haarcascade_frontalface_alt2.xml: 1047 in 20 stages,
# 253 in the first 10
ALT2_STAGES = (3, 9, 14, 19, 19, 27, 31, 39, 45, 47, 53, 67, 63, 71, 75, 78,
               91, 97, 90, 109)
SMALL_STAGES = (3, 5, 8, 12, 16, 20, 24, 28)
_RES = 8                                  # design pixels per window unit
# (x0, y0, x1, y1, grey level), in window units, painted in order
_DESIGN = ((2, 2, 18, 18, 200), (2, 2, 18, 5, 245), (5, 7, 8, 10, 40),
           (12, 7, 15, 10, 40), (6, 14, 14, 16, 60))
_SUB = 4                                  # sub-samples per pixel and axis


def _design() -> np.ndarray:
    g = np.zeros((WINDOW * _RES, WINDOW * _RES), np.float64)
    for x0, y0, x1, y1, v in _DESIGN:
        g[y0 * _RES:y1 * _RES, x0 * _RES:x1 * _RES] = v
    # freckles: one darker unit cell in seven across the face, so that the
    # stabilizer's corner detector finds texture at every size
    for y in range(3, 17):
        for x in range(3, 17):
            if (3 * x + 5 * y) % 7 == 0:
                g[y * _RES:(y + 1) * _RES, x * _RES:(x + 1) * _RES] -= 55
    return np.clip(g, 0, 255)


def glyph_image(side: int) -> np.ndarray:
    """The glyph with its black margin at (side, side) pixels, float64 in
    [0, 255], area-sampled from the design."""
    g = _design()
    pos = (np.arange(side * _SUB) + 0.5) * (g.shape[0] / (side * _SUB))
    idx = np.minimum(pos.astype(np.int64), g.shape[0] - 1)
    fine = g[idx[:, None], idx[None, :]]
    return fine.reshape(side, _SUB, side, _SUB).mean(axis=(1, 3))


def _smooth_noise(rng, n: int, size: int, blur: int) -> np.ndarray:
    """n (size, size) fields of uniform noise under a `blur`-wide box
    filter, stretched to a random range inside [0, 255]."""
    x = rng.uniform(0, 1, (n, size + blur, size + blur))
    c = np.cumsum(np.cumsum(np.pad(x, ((0, 0), (1, 0), (1, 0))), 1), 2)
    x = (c[:, blur:, blur:] - c[:, :-blur, blur:] - c[:, blur:, :-blur]
         + c[:, :-blur, :-blur])[:, :size, :size]
    lo = x.min(axis=(1, 2), keepdims=True)
    hi = x.max(axis=(1, 2), keepdims=True)
    a = rng.uniform(0, 120, (n, 1, 1))
    b = a + rng.uniform(30, 135, (n, 1, 1))
    return a + (x - lo) / np.maximum(hi - lo, 1e-9) * (b - a)


def _glyph_windows(rng, shifts: np.ndarray, scales: np.ndarray,
                   dark: np.ndarray) -> np.ndarray:
    """(n, 20, 20) windows that see the glyph moved by `shifts` (n, 2) window
    pixels and magnified by `scales` (n,), over black where `dark` and over
    smooth noise elsewhere, with a random gain, a faint texture and pixel
    noise."""
    n = len(scales)
    g = _design()
    u = (np.arange(WINDOW * _SUB) + 0.5) / _SUB          # window coordinate
    half = WINDOW / 2.0

    def src(shift):
        pos = ((u[None, :] - half - shift[:, None]) / scales[:, None]
               + half) * _RES
        idx = np.floor(pos).astype(np.int64)
        return np.clip(idx, 0, g.shape[0] - 1), (idx >= 0) & (
            idx < g.shape[0])

    xi, xin = src(shifts[:, 0])
    yi, yin = src(shifts[:, 1])
    fine = g[yi[:, :, None], xi[:, None, :]]
    inside = yin[:, :, None] & xin[:, None, :]
    back = _smooth_noise(rng, n, WINDOW * _SUB, 2 * _SUB)
    back = np.where(dark[:, None, None], 0.0, back)
    tex = _smooth_noise(rng, n, WINDOW * _SUB, _SUB) / 127.5 - 1.0
    gain = rng.uniform(0.75, 1.0, (n, 1, 1))
    fine = np.where(inside, fine * gain * (1.0 + 0.08 * tex), back)
    win = fine.reshape(n, WINDOW, _SUB, WINDOW, _SUB).mean(axis=(2, 4))
    win = win + rng.normal(0, 2.0, win.shape)
    return np.clip(win, 0, 255)


def _positives(rng, n: int) -> np.ndarray:
    shifts = rng.uniform(-1.8, 1.8, (n, 2))
    scales = rng.uniform(0.86, 1.16, n)
    return _glyph_windows(rng, shifts, scales, rng.uniform(size=n) < 0.5)


def _negatives(rng, n: int) -> np.ndarray:
    k = n // 12              # 9 k of clutter, the rest misplaced glyphs
    out = [_smooth_noise(rng, 2 * k, WINDOW, b) for b in (1, 3, 6)]
    out.append(rng.uniform(0, 255, (k, WINDOW, WINDOW)))
    # flat windows, some with a little noise: var 0 means nf 1 and every
    # feature 0, the black background of a clip
    flat = np.repeat(rng.choice([0, 0, 0, 30, 128, 255], k), WINDOW * WINDOW
                     ).reshape(k, WINDOW, WINDOW).astype(np.float64)
    flat[k // 2:] += rng.normal(0, 1.5, flat[k // 2:].shape)
    out.append(np.clip(flat, 0, 255))
    # step edges in random directions
    yy, xx = np.mgrid[:WINDOW, :WINDOW] - (WINDOW - 1) / 2.0
    ang = rng.uniform(0, 2 * np.pi, (k, 1, 1))
    off = rng.uniform(-8, 8, (k, 1, 1))
    side = (xx * np.cos(ang) + yy * np.sin(ang)) > off
    out.append(np.where(side, rng.uniform(0, 255, (k, 1, 1)),
                        rng.uniform(0, 255, (k, 1, 1)))
               + rng.normal(0, 2.0, side.shape))
    # misplaced glyphs: too far off, too small or too large
    m = n - sum(len(o) for o in out)
    far = rng.uniform(4.0, 14.0, (m, 2)) * rng.choice([-1, 1], (m, 2))
    near = rng.uniform(-2.0, 2.0, (m, 2))
    scale = np.where(rng.uniform(size=m) < 0.5, rng.uniform(0.4, 0.7, m),
                     rng.uniform(1.4, 2.6, m))
    moved = rng.uniform(size=m) < 0.5
    shifts = np.where(moved[:, None], far, near)
    scales = np.where(moved, rng.uniform(0.7, 2.6, m), scale)
    out.append(_glyph_windows(rng, shifts, scales, rng.uniform(size=m) < 0.5))
    return np.clip(np.concatenate(out), 0, 255)


def _candidate_features(rng, n: int) -> np.ndarray:
    """(n, 3, 5) [x, y, w, h, weight] rects inside the window: edge features
    (whole -1, one half +2), line features (whole -1, middle third +3) and,
    for about one in six, checker features of three rects (whole -1, two
    diagonal quarters +2 each). Weighted areas cancel."""
    out = np.zeros((n, 3, 5), np.float64)
    for i in range(n):
        kind = rng.choice(5, p=[0.25, 0.25, 0.17, 0.16, 0.17])
        nx, ny = ((2, 1), (1, 2), (3, 1), (1, 3), (2, 2))[kind]
        w = int(rng.integers(1, WINDOW // nx + 1))
        h = int(rng.integers(1, WINDOW // ny + 1))
        x = int(rng.integers(0, WINDOW - nx * w + 1))
        y = int(rng.integers(0, WINDOW - ny * h + 1))
        out[i, 0] = (x, y, nx * w, ny * h, -1.0)
        if kind == 0:
            out[i, 1] = (x + w * int(rng.integers(0, 2)), y, w, h, 2.0)
        elif kind == 1:
            out[i, 1] = (x, y + h * int(rng.integers(0, 2)), w, h, 2.0)
        elif kind == 2:
            out[i, 1] = (x + w, y, w, h, 3.0)
        elif kind == 3:
            out[i, 1] = (x, y + h, w, h, 3.0)
        else:
            out[i, 1] = (x, y, w, h, 2.0)
            out[i, 2] = (x + w, y + h, w, h, 2.0)
    return out


def _normalized_values(windows: np.ndarray, feats: np.ndarray) -> np.ndarray:
    """(N, F) feature values over the window's normalizer, f * inv_area /
    nf: the quantity a node compares with its threshold."""
    n = len(windows)
    ii = np.zeros((n, WINDOW + 1, WINDOW + 1), np.float64)
    ii[:, 1:, 1:] = windows.cumsum(1).cumsum(2)
    inv_area = 1.0 / (WINDOW * WINDOW)
    mean = ii[:, -1, -1] * inv_area
    var = (windows * windows).sum(axis=(1, 2)) * inv_area - mean * mean
    nf = np.where(var > 0, np.sqrt(np.maximum(var, 0)), 1.0)
    x, y, w, h = (feats[:, :, k].astype(np.int64) for k in range(4))
    flat = ii.reshape(n, -1)
    row = WINDOW + 1
    sums = (flat[:, y * row + x] + flat[:, (y + h) * row + x + w]
            - flat[:, y * row + x + w] - flat[:, (y + h) * row + x])
    return (sums * feats[None, :, :, 4]).sum(axis=2) * inv_area / nf[:, None]


def _best_split(vals: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Among the candidate columns of `vals`, the one whose threshold, half
    way between the weighted class means, leaves the least weighted error.
    Returns (column, threshold)."""
    pos, neg = y > 0, y <= 0
    wp, wn = w[pos], w[neg]
    if wp.sum() <= 0 or wn.sum() <= 0:
        return 0, float(np.median(vals[:, 0]))
    mp = (vals[pos] * wp[:, None]).sum(0) / wp.sum()
    mn = (vals[neg] * wn[:, None]).sum(0) / wn.sum()
    thr = (mp + mn) / 2.0
    below = vals < thr[None, :]
    # positives on the side of their mean
    wrong = np.where((mp < mn)[None, :], below != pos[:, None],
                     below == pos[:, None])
    col = int(np.argmin((wrong * w[:, None]).sum(0)))
    return col, float(thr[col])


def _log_odds(y: np.ndarray, w: np.ndarray, mask: np.ndarray) -> float:
    eps = 1.0 / len(y)
    wp = w[mask & (y > 0)].sum()
    wn = w[mask & (y <= 0)].sum()
    return float(np.clip(0.5 * np.log((wp + eps) / (wn + eps)), -2.0, 2.0))


def fit_cascade(seed: int = 0, stages: Sequence[int] = ALT2_STAGES,
                n_pos: int = 400, n_neg: int = 2400,
                candidates: int = 16) -> dict:
    """Fit the cascade; returns its parts as plain lists: `features` (one
    (3, 5) rect array per node, two per tree, in tree order), `trees`
    (node_on_left, thr0, thr1, leaves[3]) and `stages` (count, threshold)."""
    rng = np.random.default_rng(seed)
    n_nodes = 2 * sum(stages)
    pool = _candidate_features(rng, max(4 * candidates,
                                        n_nodes + 8 * candidates))
    windows = np.concatenate([_positives(rng, n_pos), _negatives(rng, n_neg)])
    vals = _normalized_values(windows, pool)
    y = np.concatenate([np.ones(n_pos), -np.ones(n_neg)])
    unused = np.ones(len(pool), bool)
    alive = np.ones(len(y), bool)            # negatives no stage rejected yet
    features, trees, stage_out = [], [], []

    def pick(rows, w):
        cols = rng.choice(np.nonzero(unused)[0], candidates, replace=False)
        col, thr = _best_split(vals[np.ix_(rows, cols)], y[rows], w)
        unused[cols[col]] = False
        return int(cols[col]), thr

    for count in stages:
        neg = np.nonzero(alive & (y < 0))[0]
        if len(neg) < n_neg // 8:            # top up with rejected ones
            rest = np.nonzero(~alive & (y < 0))[0]
            neg = np.concatenate([neg, rng.choice(
                rest, min(len(rest), n_neg // 8 - len(neg)), replace=False)])
        rows = np.concatenate([np.arange(n_pos), neg])
        ys = y[rows]
        w = np.where(ys > 0, 0.5 / n_pos, 0.5 / max(len(neg), 1))
        total = np.zeros(len(y))
        for _ in range(count):
            f0, thr0 = pick(rows, w)
            left = vals[rows, f0] < thr0
            # the second node refines the side that is less pure
            def impurity(m):
                wp, wn = w[m & (ys > 0)].sum(), w[m & (ys <= 0)].sum()
                return min(wp, wn)
            on_left = impurity(left) >= impurity(~left)
            side = left if on_left else ~left
            if side.sum() >= 2:
                sub = np.nonzero(side)[0]
                f1, thr1 = pick(rows[sub], w[sub])
            else:
                f1, thr1 = pick(rows, w)
            left1 = vals[rows, f1] < thr1
            leaves = [_log_odds(ys, w, ~side),
                      _log_odds(ys, w, side & left1),
                      _log_odds(ys, w, side & ~left1)]
            features += [pool[f0], pool[f1]]
            trees.append((bool(on_left), thr0, thr1, leaves))

            def tree_value(r):
                l0 = vals[r, f0] < thr0
                s = l0 if on_left else ~l0
                l1 = vals[r, f1] < thr1
                return np.where(s, np.where(l1, leaves[1], leaves[2]),
                                leaves[0])

            total += tree_value(np.arange(len(y)))
            w = w * np.exp(-ys * tree_value(rows))
            w = w / w.sum()
        pos_total = total[:n_pos]
        thr = float(pos_total.min() - 0.1 * pos_total.std() - 1e-6)
        stage_out.append((count, thr))
        alive &= total >= thr
    return {"features": features, "trees": trees, "stages": stage_out}


def _rect_text(r) -> str:
    x, y, w, h, wt = r
    return f"{int(x)} {int(y)} {int(w)} {int(h)} {float(wt)!r}"


def write_cascade(path: str, seed: int = 0,
                  stages: Sequence[int] = ALT2_STAGES, **fit_args) -> str:
    """Fit a cascade from `seed` and write it to `path` as OpenCV
    new-format XML. Returns `path`."""
    fit = fit_cascade(seed, stages, **fit_args)
    out = ['<?xml version="1.0"?>', "<opencv_storage>",
           '<cascade type_id="opencv-cascade-classifier">'
           "<stageType>BOOST</stageType>",
           "  <featureType>HAAR</featureType>",
           f"  <height>{WINDOW}</height>", f"  <width>{WINDOW}</width>",
           "  <stageParams>",
           f"    <maxWeakCount>{max(stages)}</maxWeakCount></stageParams>",
           "  <featureParams>",
           "    <maxCatCount>0</maxCatCount></featureParams>",
           f"  <stageNum>{len(stages)}</stageNum>", "  <stages>"]
    tree = 0
    for count, thr in fit["stages"]:
        out += ["    <_>", f"      <maxWeakCount>{count}</maxWeakCount>",
                f"      <stageThreshold>{thr!r}</stageThreshold>",
                "      <weakClassifiers>"]
        for _ in range(count):
            on_left, thr0, thr1, leaves = fit["trees"][tree]
            children = "1 0" if on_left else "0 1"
            out += ["        <_>",
                    f"          <internalNodes> {children} {2 * tree} "
                    f"{thr0!r} -1 -2 {2 * tree + 1} {thr1!r}</internalNodes>",
                    "          <leafValues> "
                    + " ".join(repr(v) for v in leaves)
                    + "</leafValues></_>"]
            tree += 1
        out += ["      </weakClassifiers></_>"]
    out += ["  </stages>", "  <features>"]
    for rects in fit["features"]:
        out += ["    <_>", "      <rects>"]
        out += [f"        <_> {_rect_text(r)}</_>" for r in rects
                if r[4] != 0.0]
        out += ["      </rects>", "      <tilted>0</tilted></_>"]
    out += ["  </features></cascade>", "</opencv_storage>", ""]
    with open(path, "w") as f:
        f.write("\n".join(out))
    return path


def planted_frame(rng, h: int, w: int, side: int,
                  background: str = "black") -> Tuple[np.ndarray, tuple]:
    """One (h, w) uint8 frame with the glyph at `side` px at a random
    place, over black or over smooth noise. Returns the frame and the
    glyph's box (x, y, side)."""
    if background == "black":
        frame = np.zeros((h, w), np.float64)
    else:
        frame = _smooth_noise(rng, 1, max(h, w), 6)[0, :h, :w]
    x = int(rng.integers(0, w - side + 1))
    y = int(rng.integers(0, h - side + 1))
    frame[y:y + side, x:x + side] = glyph_image(side)
    return np.clip(np.rint(frame), 0, 255).astype(np.uint8), (x, y, side)
