"""Face-track-rate, the automated sample-quality proxy: the port of
gifgan_tpu/eval/track_rate.py.

Generated clips go through the face tracker (track/pipeline.py
process_video) with the relaxed thresholds of the reference's generated-
sample eval (min_frame_count 6, min_total_detections 3, max_skip 2); the
rate is the share of clips that yield at least one final track. A
DeviceHaarDetector detects a whole clip in one dispatch (its
detect_video, K3); the stabilizer's flow follows cfg.flow_backend ("auto":
the device flow with K4).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import TrackConfig
from gifgan_tpu_torch.track.pipeline import process_video
from gifgan_tpu_torch.track.stats import TrackStats

# relaxed thresholds used for generated-sample eval (reference params.txt)
EVAL_TRACK_CONFIG = TrackConfig(min_frame_count=6, min_total_detections=3,
                                max_skip=2, target_size=64)


def face_track_rate(clips: Sequence[np.ndarray], detector: Callable,
                    cfg: Optional[TrackConfig] = None,
                    device=None) -> Dict:
    """clips: (T, H, W, C) uint8 videos (generated samples). Returns
    {"rate", "tracked", "total", "stats"}. A clip whose tracking raises is
    counted in stats.cnt_files_errored and as untracked, as the reference
    does; a caller that must see every failure reads that counter. The
    device (the card by default) is resolved first, so a missing card
    raises instead of erroring every clip."""
    device = resolve_device(device)
    cfg = cfg or EVAL_TRACK_CONFIG
    stats = TrackStats()
    stats.total_files = len(clips)
    tracked = 0
    for clip in clips:
        before = stats.cnt_final_tracks
        try:
            process_video(np.asarray(clip), detector, cfg, stats,
                          device=device)
            stats.cnt_files_processed += 1
        except Exception:
            stats.cnt_files_errored += 1
            continue
        if stats.cnt_final_tracks > before:
            tracked += 1
    total = len(clips)
    return {
        "rate": tracked / total if total else 0.0,
        "tracked": tracked,
        "total": total,
        "stats": stats,
    }


def track_rate_report(results_by_variant: Dict[str, Dict],
                      out_dir: Optional[str] = None) -> str:
    """Render per-variant track rates (the stats.txt-per-variant layout of
    the reference's survey_samples_test_results/)."""
    lines = ["# face-track-rate eval", ""]
    for name, res in sorted(results_by_variant.items()):
        lines.append(f"{name}: {res['tracked']}/{res['total']} "
                     f"({100.0 * res['rate']:.1f}%)")
        if out_dir:
            res["stats"].write(os.path.join(out_dir, f"{name}_results"))
    text = "\n".join(lines) + "\n"
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "summary.txt"), "w") as f:
            f.write(text)
    return text
