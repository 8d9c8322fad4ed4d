"""Track stabilization: corner features -> sparse optical flow -> similarity
fit -> scale+offset update (rotation killed).

Behavioral rebuild of the reference stabilizer (track_faces.py:429-583):
per frame, per live track:
  1. recenter the incoming detection to the previous stabilized box's size
     (same_size_crop); off-frame => truncate/drop,
  2. find corners in the previous stabilized crop, run pyramidal LK flow into
     the current crop, keep successfully-tracked points,
  3. fit a similarity (partial-affine) transform between the point sets,
  4. apply the transform to the previous box corners, then KILL the rotation:
     keep the transformed center + diagonal-derived scale, rebuild the box at
     the target aspect ratio,
  5. off-frame or failure at any stage => truncate (if already long enough)
     or drop, counted separately (the 4 truncate/drop counter pairs).

The flow backend is injectable: kernels/flow.py mxu_flow_backend runs
corners and LK flow on the card (the LK iteration is the CUDA kernel K4);
cv2_flow_backend below runs OpenCV on the host and needs cv2. The similarity
fit (least-squares over point pairs) is closed form, shared by both. Host
code, numpy only: the port's own copy of gifgan_tpu/track/stabilize.py.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from gifgan_tpu_torch.track.boxes import Detection, Track, same_size_crop


def fit_similarity(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """Least-squares similarity transform (scale+rotation+translation)
    mapping src -> dst; both (N, 2). Returns 2x3 [[a,-b,tx],[b,a,ty]] or
    None if degenerate — the estimateRigidTransform(fullAffine=False)
    equivalent as a small closed-form solve."""
    if len(src) < 2 or len(dst) < 2:
        return None
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    s, d = src - mu_s, dst - mu_d
    denom = (s ** 2).sum()
    if denom < 1e-9:
        return None
    a = (s * d).sum() / denom
    b = (s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0]).sum() / denom
    t = mu_d - np.array([a * mu_s[0] - b * mu_s[1],
                         b * mu_s[0] + a * mu_s[1]])
    return np.array([[a, -b, t[0]], [b, a, t[1]]])


def cv2_flow_backend(prev_crop: np.ndarray, crop: np.ndarray,
                     max_corners: int = 200, quality: float = 0.01,
                     min_distance: float = 8.0, block_size: int = 7,
                     win_size: int = 15, max_level: int = 3,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Shi-Tomasi corners + pyramidal LK; returns (pts_prev, pts_next,
    n_corners_found) — the tracked point pairs plus how many corners were
    detected before flow, so callers can distinguish the no-corners and
    all-flow-failed cases (the reference's separate counters,
    track_faces.py:498-523)."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cv2 unavailable") from e
    pnts = cv2.goodFeaturesToTrack(prev_crop, maxCorners=max_corners,
                                   qualityLevel=quality,
                                   minDistance=min_distance,
                                   blockSize=block_size)
    if pnts is None or len(pnts) == 0:
        return np.zeros((0, 2)), np.zeros((0, 2)), 0
    pnts2, status, _ = cv2.calcOpticalFlowPyrLK(
        prev_crop, crop, pnts, None, winSize=(win_size, win_size),
        maxLevel=max_level,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 10, 0.03))
    ok = status.ravel().astype(bool)
    return pnts.reshape(-1, 2)[ok], pnts2.reshape(-1, 2)[ok], len(pnts)


def stabilized_box_update(d: Detection, next_d: Detection,
                          transform: np.ndarray, target_aspect: float,
                          ) -> Detection:
    """Apply the similarity transform to the previous stabilized box and
    kill the rotation (track_faces.py:542-560): transformed center +
    diagonal-length scale, box rebuilt at target aspect."""
    m, b = transform[:, :2], transform[:, 2:3]
    x1y1 = m @ np.array([[d.x1], [d.y1]], float) + b
    x2y2 = m @ np.array([[d.x2], [d.y2]], float) + b
    centre = (x1y1 + x2y2) / 2.0
    diag = x1y1 - x2y2
    diag_len = math.hypot(diag[0, 0], diag[1, 0])
    old_diag = math.hypot(d.x2 - d.x1, d.y2 - d.y1)
    scale = diag_len / old_diag
    y1 = int(round(centre[1, 0] - scale * (d.y2 - d.y1) / 2.0))
    y2 = int(round(centre[1, 0] + scale * (d.y2 - d.y1) / 2.0))
    new_h = y2 - y1
    x1 = int(round(centre[0, 0] - target_aspect * new_h / 2.0))
    x2 = int(round(centre[0, 0] + target_aspect * new_h / 2.0))
    return Detection(x1, y1, x2, y2, next_d.frame_number, next_d.interpolated)


def stabilize_tracks(frames: Sequence[np.ndarray], tracks: List[Track],
                     frame_size: Tuple[int, int],
                     min_frame_count: int = 20,
                     target_aspect: float = 1.0,
                     *, flow_backend: Callable,
                     stats=None) -> List[Optional[Track]]:
    """frames: per-frame GRAYSCALE images (iterable in frame order). Returns
    one stabilized track (or None if too short after truncation) per input
    track, index-aligned (track_faces.py:577-583). flow_backend(prev_crop,
    crop) has no default: the caller names the device or the host flow."""
    width, height = frame_size
    lookup = [{d.frame_number: d for d in track[1:]} for track in tracks]
    stable: List[Track] = [[replace(track[0])] for track in tracks]
    onscreen = [True] * len(tracks)

    def fail(track_id, truncate_counter, drop_counter):
        onscreen[track_id] = False
        if stats is not None:
            if len(stable[track_id]) >= min_frame_count:
                setattr(stats, truncate_counter,
                        getattr(stats, truncate_counter) + 1)
            else:
                setattr(stats, drop_counter, getattr(stats, drop_counter) + 1)

    prev_frame = None
    for frame_number, im in enumerate(frames):
        for track_id in range(len(tracks)):
            if not onscreen[track_id] or frame_number not in lookup[track_id]:
                continue
            d = stable[track_id][-1]
            next_d = same_size_crop(lookup[track_id][frame_number], d)
            if (next_d.x1 < 0 or next_d.y1 < 0 or next_d.x2 >= width
                    or next_d.y2 >= height):
                fail(track_id, "cnt_truncate_because_optical_flow_bb_too_big",
                     "cnt_drop_because_optical_flow_bb_too_big")
                continue
            prev_crop = prev_frame[d.y1:d.y2 + 1, d.x1:d.x2 + 1]
            crop = im[next_d.y1:next_d.y2 + 1, next_d.x1:next_d.x2 + 1]
            result = flow_backend(prev_crop, crop)
            if len(result) == 3:          # (pts, pts2, n_corners_found)
                pts, pts2, n_corners = result
            else:
                pts, pts2 = result
                n_corners = len(pts)
            if stats is not None:
                stats.observe_feature_points(len(pts))
            if len(pts) == 0:
                # distinguish the reference's two failure counters
                # (track_faces.py:498-523): no corners found vs corners
                # found but optical flow failed on all of them
                if n_corners == 0:
                    fail(track_id, "cnt_truncate_because_no_feature_points",
                         "cnt_drop_because_no_feature_points")
                else:
                    fail(track_id, "cnt_truncate_because_failed_optical_flow",
                         "cnt_drop_because_failed_optical_flow")
                continue
            # move points into frame coordinates
            pts = pts + np.array([d.x1, d.y1], float)
            pts2 = pts2 + np.array([next_d.x1, next_d.y1], float)
            transform = fit_similarity(pts, pts2)
            if transform is None:
                fail(track_id, "cnt_truncate_because_no_rigid_transform",
                     "cnt_drop_because_no_rigid_transform")
                continue
            new_d = stabilized_box_update(d, next_d, transform, target_aspect)
            if (new_d.x1 < 0 or new_d.y1 < 0 or new_d.x2 >= width
                    or new_d.y2 >= height):
                fail(track_id, "cnt_truncate_because_stabilized_bb_too_big",
                     "cnt_drop_because_stabilized_bb_too_big")
                continue
            stable[track_id].append(new_d)
        prev_frame = im
    return [t if len(t) >= min_frame_count else None for t in stable]
