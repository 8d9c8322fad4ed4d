"""Face-track preprocessing pipeline: detect -> associate -> filter ->
interpolate -> expand -> stabilize -> crop.

The port of gifgan_tpu/track/pipeline.py: per-file error isolation with a
consecutive-error abort threshold, params persisted to the output directory,
the live dashboard rewritten periodically, and idempotent resume (files whose
outputs exist are skipped).

The video is decoded once into a frame array. Association and box geometry
are host numpy; the stabilizer's corners and LK flow run on the card
(kernels/flow.py, with the LK iteration as the CUDA kernel K4) unless the
host cv2 backend is asked for by name; the crop + resize of all track frames
is one batched device op (kernels/crop_resize.py).

Detection runs on the card too: without an injected detector,
`cascade_path` and `cfg.detector_backend` pick one (track/detect.py), "auto"
being the pyramid-packed cascade with its early stages as the CUDA kernel K3
(track/haar_device.py), batched over several decoded clips per dispatch. The
host detectors run only when asked for by name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import TrackConfig
from gifgan_tpu_torch.track import boxes as B
from gifgan_tpu_torch.track import stabilize as S
from gifgan_tpu_torch.track.stats import TrackStats


def crop_and_resize_tracks(frames: np.ndarray, tracks: List[B.Track],
                           target: int, device=None) -> List[np.ndarray]:
    """Crop every detection's box and resize to (target, target): all crops
    of all tracks in one device program, whatever the per-box sizes
    (kernels.crop_resize)."""
    from gifgan_tpu_torch.kernels.crop_resize import crop_resize_bilinear

    if not tracks:
        return []
    device = resolve_device(device)
    all_boxes, all_fidx, lengths = [], [], []
    for track in tracks:
        for d in track:
            all_boxes.append((d.y1, d.x1, d.y2, d.x2))
            all_fidx.append(d.frame_number)
        lengths.append(len(track))
    crops = crop_resize_bilinear(
        torch.as_tensor(frames).to(device),
        torch.tensor(all_fidx, dtype=torch.int32, device=device),
        torch.tensor(all_boxes, dtype=torch.float32, device=device), target)
    # clip and truncate (no rounding), as the JAX package does
    crops = crops.clamp(0, 255).to(torch.uint8).cpu().numpy()
    out, pos = [], 0
    for ln in lengths:
        out.append(crops[pos:pos + ln])
        pos += ln
    return out


def _flow_backend(cfg: TrackConfig, device) -> Callable:
    """cfg.flow_backend -> a (prev_crop, crop) flow function: "auto" and
    "mxu" give the device kernels on `device` (the card unless the caller
    names another), whatever else is installed; only "cv2", asked for by
    name, gives OpenCV on the host."""
    choice = cfg.flow_backend
    if choice in ("auto", "mxu"):
        from gifgan_tpu_torch.kernels.flow import mxu_flow_backend

        device = resolve_device(device)
        return lambda a, b: mxu_flow_backend(
            a, b, cfg.max_corners, cfg.corner_quality,
            cfg.corner_min_distance, win_size=cfg.lk_window,
            max_level=cfg.lk_levels, device=device)
    if choice == "cv2":
        return lambda a, b: S.cv2_flow_backend(
            a, b, cfg.max_corners, cfg.corner_quality,
            cfg.corner_min_distance, win_size=cfg.lk_window,
            max_level=cfg.lk_levels)
    if choice == "jax":
        raise NotImplementedError(
            'flow_backend="jax" (gifgan_tpu/track/flow_jax.py) is not '
            'ported yet (ROADMAP.md queue 1 item 12); use "mxu" or "cv2"')
    raise ValueError(f"unknown flow_backend {choice!r}")


def _default_detector(cfg: TrackConfig, cascade_path: Optional[str],
                      backend: str, device):
    from gifgan_tpu_torch.track import detect as D

    return D.default_detector(
        cascade_path=cascade_path, scale_factor=cfg.scale_factor,
        min_neighbors=cfg.min_neighbors, backend=backend, device=device)


def process_video(frames: np.ndarray, detector: Optional[Callable],
                  cfg: TrackConfig, stats: Optional[TrackStats] = None,
                  per_frame: Optional[List[list]] = None,
                  device=None,
                  cascade_path: Optional[str] = None) -> List[np.ndarray]:
    """frames: (T, H, W, C) uint8 RGB. Returns a list of stabilized face
    clips (each (t, target, target, C) uint8).

    detector(frame, i) -> list of Detection, or an object with
    detect_video(frames); None builds cfg.detector_backend's detector from
    `cascade_path` (track/detect.py default_detector). per_frame:
    precomputed per-frame Detection lists; skips stage 1 (run_directory's
    batched detection computes them for several clips in one dispatch,
    DeviceHaarDetector.detect_clips, and feeds them through here)."""
    stats = stats if stats is not None else TrackStats()
    t, height, width = frames.shape[:3]
    frame_size = (width, height)

    # 1. detection: whole-clip when the detector supports it, else per frame
    if per_frame is None:
        if detector is None:
            detector = _default_detector(cfg, cascade_path,
                                         cfg.detector_backend, device)
        if hasattr(detector, "detect_video"):
            per_frame = detector.detect_video(frames)
        else:
            per_frame = [detector(frames[i], i) for i in range(t)]
    for dets in per_frame:
        stats.cnt_total_detections += len(dets)

    # 2-3. association + validity filtering
    tracks = B.associate_detections(per_frame, cfg.min_jaccard, cfg.max_skip,
                                    stats=stats)
    stats.cnt_initial_tracks += len(tracks)
    for tr in tracks:
        stats.observe_track(len(tr), [d.height for d in tr],
                            [d.width for d in tr])
    tracks, _ = B.discard_invalid_tracks(
        tracks, cfg.min_frame_count, cfg.min_total_detections, stats=stats)

    # 4-5. interpolation + aspect expansion
    tracks = B.interpolate_missing_frames(tracks)
    tracks, _ = B.expand_bounding_boxes(
        tracks, frame_size, cfg.target_size, cfg.target_size, stats=stats)

    # 6. stabilization over grayscale frames (float32 weights, truncated)
    gray = (np.dot(frames[..., :3].astype(np.float32),
                   [0.299, 0.587, 0.114]).astype(np.uint8)
            if frames.shape[-1] == 3 else frames[..., 0])
    stable = S.stabilize_tracks(
        list(gray), tracks, frame_size, cfg.min_frame_count,
        target_aspect=1.0, flow_backend=_flow_backend(cfg, device),
        stats=stats)
    stable = [s for s in stable if s is not None]

    stats.cnt_detections_kept += sum(
        1 for tr in stable for d in tr if not d.interpolated)
    stats.cnt_detections_written += sum(len(tr) for tr in stable)
    stats.observe_final(len(stable), [len(tr) for tr in stable])

    # 7. crop + batched device resize
    return crop_and_resize_tracks(frames, stable, cfg.target_size, device)


def _cv2_decode(path: str, max_frames: int) -> Optional[np.ndarray]:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cv2 unavailable") from e
    cap = cv2.VideoCapture(path)
    frames = []
    while cap.isOpened() and len(frames) < max_frames:
        ret, im = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(im, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else None


def _decode(path: str, max_frames: int) -> Optional[np.ndarray]:
    """A GIF through the shared native codec, anything else through cv2."""
    if path.endswith(".gif"):
        from gifgan_tpu_torch.data.video import read_gif

        return read_gif(path)[:max_frames]
    return _cv2_decode(path, max_frames)


def _write_crop(path_base: str, source_name: str, clip: np.ndarray) -> None:
    """A GIF source's crops are GIFs (the native codec, what the clip feed
    reads); a video's are mp4s through cv2."""
    from gifgan_tpu_torch.data.video import encode_mp4, write_gif

    if source_name.endswith(".gif"):
        write_gif(path_base + ".gif", clip)
    else:
        encode_mp4(path_base + ".mp4", clip)


def _to_gray64(f: np.ndarray) -> np.ndarray:
    return (np.dot(f[..., :3].astype(np.float64), [0.299, 0.587, 0.114])
            if f.ndim == 4 and f.shape[-1] >= 3
            else np.asarray(f, np.float64)[..., 0]
            if f.ndim == 4 else np.asarray(f, np.float64))


def run_directory(input_dir: str, output_dir: str, cfg: TrackConfig,
                  detector: Callable = None,
                  cascade_path: str = None,
                  decode_fn: Callable = None,
                  max_consecutive_errors: int = 10,
                  dashboard_every_s: float = 15.0,
                  resume: bool = True,
                  workers: int = 1,
                  detect_batch_clips: int = 1,
                  device=None) -> TrackStats:
    """Process every video in a directory with error isolation, dashboard
    refresh, params persistence, and idempotent resume.

    detector=None builds one from `cascade_path` and cfg.detector_backend:
    "auto" takes the device detector and batches detection (track/detect.py
    select_detector_backend; the choice lands in params.json as
    detector_backend_selected); an explicit backend or an injected detector
    bypasses the selection, and a backend that cannot be built (no card,
    no cascade file) raises.

    workers > 1 runs files concurrently on a thread pool (decode releases
    the GIL in its C++ loops); per-file stats are accumulated locally and
    merged under a lock, so the combined output equals a sequential run up
    to file ordering.

    detect_batch_clips > 1 with a detector that has detect_clips: decode
    that many files per group and run one detection dispatch for the whole
    group (DeviceHaarDetector.detect_clips, letterbox-packed canvas), then
    the host stages per file. With workers > 1 the device detector stays
    one serialized resource owned by this thread, while the workers decode
    ahead of it and track behind it. A dispatch that raises is not retried
    clip by clip on another path: the traceback prints and the group's
    files count as errored."""
    from gifgan_tpu_torch.track import detect as D
    from gifgan_tpu_torch.track.boxes import Detection

    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    if decode_fn is None:
        def decode_fn(path):
            return _decode(path, cfg.max_frames)

    stats = TrackStats()
    params = dataclasses.asdict(cfg)
    files = sorted(f for f in os.listdir(input_dir)
                   if f.endswith((".mp4", ".avi", ".gif")))
    stats.total_files = len(files)

    todo = []
    for name in files:
        base = os.path.splitext(name)[0]
        if resume and any(f.startswith(base + "_crop")
                          for f in os.listdir(output_dir)):
            stats.cnt_files_processed += 1
        else:
            todo.append(name)

    backend = cfg.detector_backend
    if detector is None and backend == "auto":
        backend, detect_batch_clips = D.select_detector_backend(
            detect_batch_clips=detect_batch_clips,
            device_available=(device.type != "cuda"
                              or torch.cuda.is_available()))
        params["detector_backend_selected"] = backend
        params["detect_batch_clips_selected"] = detect_batch_clips
    if detector is None:
        detector = _default_detector(cfg, cascade_path, backend, device)

    def process_one(name, frames=None, per_frame=None, base_seconds=0.0):
        """Decode + track + write one file with a local stats object.
        Returns (local_stats, ok, seconds). frames/per_frame: pre-decoded
        pixels and precomputed detections from the batched-detect path
        (base_seconds carries that file's share of the group dispatch so
        the dashboard's per-file histogram stays meaningful)."""
        local = TrackStats()
        base = os.path.splitext(name)[0]
        t0 = time.time() - base_seconds
        try:
            if frames is None:
                frames = decode_fn(os.path.join(input_dir, name))
            if frames is None:
                raise RuntimeError("decode failed")
            clips = process_video(frames, detector, cfg, local,
                                  per_frame=per_frame, device=device)
            for i, clip in enumerate(clips):
                _write_crop(os.path.join(output_dir, f"{base}_crop_{i}"),
                            name, clip)
            local.cnt_files_processed += 1
            return local, True, time.time() - t0
        except Exception:
            local.cnt_files_errored += 1
            traceback.print_exc()
            return local, False, time.time() - t0

    lock = threading.Lock()
    consecutive_errors = 0
    last_dash = 0.0
    abort = False

    def consume(result):
        nonlocal consecutive_errors, last_dash, abort
        local, ok, seconds = result
        with lock:
            stats.update(local)
            stats.observe_file_time(seconds)
            consecutive_errors = 0 if ok else consecutive_errors + 1
            if consecutive_errors >= max_consecutive_errors:
                print(f"aborting: {consecutive_errors} consecutive errors")
                abort = True
            if time.time() - last_dash > dashboard_every_s:
                stats.write(output_dir, params)
                last_dash = time.time()

    def errored(seconds=0.0):
        local = TrackStats()
        local.cnt_files_errored += 1
        return local, False, seconds

    def decode_one(name):
        frames = decode_fn(os.path.join(input_dir, name))
        if frames is None:
            raise RuntimeError("decode failed")
        return name, frames

    def detect_group(group):
        """One detect_clips dispatch over the decoded (name, frames) group
        -> per file (per-frame Detection lists, its share of the seconds),
        or None for every file when the dispatch raised."""
        t0 = time.time()
        try:
            group_rects = detector.detect_clips(
                [_to_gray64(f) for _, f in group])
        except Exception:
            traceback.print_exc()
            return None, (time.time() - t0) / len(group)
        per_file = [[[Detection.from_rect(r, fi) for r in fr]
                     for fi, fr in enumerate(clip_rects)]
                    for clip_rects in group_rects]
        return per_file, (time.time() - t0) / len(group)

    def drain(pending):
        """On abort the in-flight files still finish (the pool shutdown
        waits for them and their crops land on disk): fold their stats in
        too so stats agree with output_dir contents."""
        for fut in pending:
            local, ok, seconds = fut.result()
            with lock:
                stats.update(local)
                stats.observe_file_time(seconds)

    batched = detect_batch_clips > 1 and hasattr(detector, "detect_clips")
    if batched and workers > 1:
        # Composed dispatcher: decode and tracking are host work that
        # threads; this thread alone owns the device detector and
        # letterbox-batches decoded clips across sources.
        from concurrent.futures import ThreadPoolExecutor

        window = max(2 * workers, detect_batch_clips)
        with ThreadPoolExecutor(max_workers=workers) as dec_pool, \
                ThreadPoolExecutor(max_workers=workers) as trk_pool:
            it = iter(todo)
            dec_pending = []        # decode futures, in submission order
            trk_pending = []        # tracking futures, in submission order

            def top_up():
                while len(dec_pending) < window:
                    name = next(it, None)
                    if name is None:
                        return
                    dec_pending.append(dec_pool.submit(decode_one, name))

            top_up()
            while dec_pending and not abort:
                group = []          # decode failures stay per-file isolated
                while dec_pending and len(group) < detect_batch_clips \
                        and not abort:
                    fut = dec_pending.pop(0)
                    try:
                        group.append(fut.result())
                    except Exception:
                        traceback.print_exc()
                        consume(errored())
                    top_up()
                if not group:
                    continue
                per_file, share = detect_group(group)
                if per_file is None:
                    for _ in group:
                        consume(errored(share))
                    continue
                for (name, frames), pf in zip(group, per_file):
                    trk_pending.append(trk_pool.submit(
                        process_one, name, frames=frames, per_frame=pf,
                        base_seconds=share))
                # harvest finished tracking without stalling the dispatcher
                while trk_pending and not abort and (
                        trk_pending[0].done()
                        or len(trk_pending) > 2 * workers):
                    consume(trk_pending.pop(0).result())
            while trk_pending and not abort:
                consume(trk_pending.pop(0).result())
            drain(trk_pending)
    elif batched:
        i = 0
        while i < len(todo) and not abort:
            names = todo[i:i + detect_batch_clips]
            i += len(names)
            group = []              # decode failures stay per-file isolated
            for name in names:
                try:
                    group.append(decode_one(name))
                except Exception:
                    traceback.print_exc()
                    consume(errored())
                    if abort:
                        break
            if abort or not group:
                continue
            per_file, share = detect_group(group)
            for k, (name, frames) in enumerate(group):
                consume(errored(share) if per_file is None else process_one(
                    name, frames=frames, per_frame=per_file[k],
                    base_seconds=share))
                if abort:
                    break
    elif workers <= 1:
        for name in todo:
            consume(process_one(name))
            if abort:
                break
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = []
            for name in todo:
                pending.append(pool.submit(process_one, name))
                if len(pending) >= 2 * workers:
                    consume(pending.pop(0).result())
                    if abort:
                        break
            while pending and not abort:
                consume(pending.pop(0).result())
            drain(pending)

    stats.write(output_dir, params)
    # the run's parameters on their own too, the selected backend included
    with open(os.path.join(output_dir, "params.json"), "w") as f:
        json.dump(params, f, indent=2)
    return stats
