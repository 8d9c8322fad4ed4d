from gifgan_tpu_torch.track.boxes import (
    Detection,
    jaccard_index,
    jaccard_matrix,
    associate_detections,
    discard_invalid_tracks,
    interpolate_missing_frames,
    expand_bounding_boxes,
    same_size_crop,
)
from gifgan_tpu_torch.track.stats import TrackStats, combine_stats_files

__all__ = [
    "Detection", "jaccard_index", "jaccard_matrix", "associate_detections",
    "discard_invalid_tracks", "interpolate_missing_frames",
    "expand_bounding_boxes", "same_size_crop", "TrackStats",
    "combine_stats_files",
]
