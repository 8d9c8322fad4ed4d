"""Face-track geometry: detections, Jaccard association, interpolation,
aspect expansion.

Behavioral rebuild of the reference's track association chain
(data_collection/track_faces.py): greedy best-first Jaccard matching with a
skip allowance (:268-297), short-track discard (:320-339), linear
interpolation of missing boxes (:349-369), aspect-ratio + scale expansion
with off-frame track drop (:380-418), and the center-preserving
same-size-crop used by the stabilizer (:1045-1058).

Boxes are (x1, y1, x2, y2) int arrays. Everything here is tiny control-plane
work over <= K boxes and runs in numpy on the host: this is the port's own
copy of gifgan_tpu/track/boxes.py, numpy and stdlib only.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class Detection:
    x1: int
    y1: int
    x2: int
    y2: int
    frame_number: int
    interpolated: bool = False

    @classmethod
    def from_rect(cls, rect, frame_number: int, interpolated: bool = False):
        x, y, w, h = (int(v) for v in rect)
        return cls(x, y, x + w, y + h, frame_number, interpolated)

    @property
    def width(self) -> int:
        return self.x2 - self.x1

    @property
    def height(self) -> int:
        return self.y2 - self.y1

    def as_vec(self) -> np.ndarray:
        return np.array([self.x1, self.y1, self.x2, self.y2], np.float64)


Track = List[Detection]


def jaccard_index(a: Detection, b: Detection) -> float:
    """IoU with the reference's exact edge convention (track_faces.py:1014-1023):
    intersection measured on half-open [x1, x2) widths."""
    iw = min(a.x2, b.x2) - max(a.x1, b.x1)
    ih = min(a.y2, b.y2) - max(a.y1, b.y1)
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    union = a.width * a.height + b.width * b.height - inter
    return float(inter) / float(union)


def jaccard_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray):
    """Batched IoU: (N, 4) x (M, 4) -> (N, M) float32. Same edge convention
    as jaccard_index."""
    a = np.asarray(boxes_a, dtype=np.float32)[:, None, :]
    b = np.asarray(boxes_b, dtype=np.float32)[None, :, :]
    iw = np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])
    ih = np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)


def associate_detections(per_frame_detections: Sequence[Sequence[Detection]],
                         min_jaccard: float = 0.60, max_skip: int = 6,
                         stats=None) -> List[Track]:
    """Greedy best-first track building (track_faces.py:268-297): per frame,
    score every (detection, open track) pair by IoU with the track's last
    box; matches with IoU >= min_jaccard and skip <= max_skip are taken in
    descending-IoU order; unmatched detections open new tracks."""
    tracks: List[Track] = []
    for frame_number, dets in enumerate(per_frame_detections):
        unmatched = list(dets)
        scored = []
        for current in unmatched:
            for track in tracks:
                previous = track[-1]
                skip = frame_number - previous.frame_number - 1
                j = jaccard_index(current, previous)
                if stats is not None and j > 0 and skip <= max_skip:
                    stats.observe_jaccard_raw(j, skip)
                if j >= min_jaccard and skip <= max_skip:
                    scored.append((j, current, track, skip))
        scored.sort(key=lambda t: t[0], reverse=True)
        claimed = set()
        claimed_tracks = set()
        for j, current, track, skip in scored:
            if id(current) in claimed or id(track) in claimed_tracks:
                continue
            track.append(current)
            claimed.add(id(current))
            claimed_tracks.add(id(track))
            if stats is not None:
                stats.observe_jaccard_used(j, skip)
        for current in unmatched:
            if id(current) not in claimed:
                tracks.append([current])
    return tracks


def discard_invalid_tracks(tracks: List[Track], min_frame_count: int = 20,
                           min_total_detections: int = 10, stats=None,
                           ) -> Tuple[List[Track], List[Detection]]:
    """(track_faces.py:320-339): frame span and detection-count thresholds;
    rejected tracks' detections are returned for visualization."""
    valid, untracked = [], []
    for track in tracks:
        span = track[-1].frame_number - track[0].frame_number + 1
        if span < min_frame_count:
            if stats is not None:
                stats.cnt_drop_because_low_frame_count += 1
            untracked.extend(track)
            continue
        if len(track) < min_total_detections:
            if stats is not None:
                stats.cnt_drop_because_low_total_detections += 1
            untracked.extend(track)
            continue
        valid.append(track)
    return valid, untracked


def interpolate_missing_frames(tracks: List[Track]) -> List[Track]:
    """Linear interpolation of skipped frames (track_faces.py:349-369),
    rounding to int boxes."""
    out = []
    for track in tracks:
        filled: Track = []
        for d1, d2 in zip(track[:-1], track[1:]):
            filled.append(replace(d1))
            delta = d2.as_vec() - d1.as_vec()
            span = d2.frame_number - d1.frame_number
            for frm in range(d1.frame_number + 1, d2.frame_number):
                frac = (frm - d1.frame_number) / span
                v = np.round(d1.as_vec() + frac * delta).astype(np.int32)
                filled.append(Detection(int(v[0]), int(v[1]), int(v[2]),
                                        int(v[3]), frm, interpolated=True))
        filled.append(replace(track[-1]))
        out.append(filled)
    return out


def expand_bounding_boxes(tracks: List[Track], frame_size: Tuple[int, int],
                          target_width: int = 256, target_height: int = 256,
                          scaling_factor: float = 1.0, stats=None,
                          ) -> Tuple[List[Track], List[Track]]:
    """Aspect-ratio expansion around the box center plus a global scaling
    factor; tracks whose expanded boxes leave the frame are dropped whole
    (track_faces.py:380-418)."""
    width, height = frame_size
    expanded, oversize = [], []
    for track in tracks:
        drop = False
        new_track: Track = []
        for d in track:
            required = target_width / target_height
            actual = d.width / d.height
            scaling = required / actual
            xs = scaling if scaling > 1.0 else 1.0
            ys = 1.0 / scaling if scaling <= 1.0 else 1.0
            cx = (d.x1 + d.x2) / 2.0
            cy = (d.y1 + d.y2) / 2.0
            f = scaling_factor
            x1 = int(round(xs * f * (d.x1 - cx) + cx))
            y1 = int(round(ys * f * (d.y1 - cy) + cy))
            x2 = int(round(xs * f * (d.x2 - cx) + cx))
            y2 = int(round(ys * f * (d.y2 - cy) + cy))
            if x1 < 0 or y1 < 0 or x2 >= width or y2 >= height:
                drop = True
            new_track.append(Detection(x1, y1, x2, y2, d.frame_number,
                                       d.interpolated))
        if drop:
            if stats is not None:
                stats.cnt_drop_because_expanded_bb_too_big += 1
            oversize.append(new_track)
        else:
            expanded.append(new_track)
    return expanded, oversize


def same_size_crop(inpt: Detection, target: Detection) -> Detection:
    """Recenter target's box size onto inpt's center (track_faces.py:1045-1058)."""
    ix = int(round((inpt.x1 + inpt.x2) / 2.0))
    iy = int(round((inpt.y1 + inpt.y2) / 2.0))
    tx = int(round((target.x1 + target.x2) / 2.0))
    ty = int(round((target.y1 + target.y2) / 2.0))
    return Detection(target.x1 - tx + ix, target.y1 - ty + iy,
                     target.x2 - tx + ix, target.y2 - ty + iy,
                     inpt.frame_number, inpt.interpolated)
