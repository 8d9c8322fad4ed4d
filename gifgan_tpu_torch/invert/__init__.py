from gifgan_tpu_torch.invert.optimize import (
    InversionProblem,
    invert,
    invert_images,
    invert_video_joint,
    invert_video_iterative,
    invert_nested_first_frame,
    apply_latent_path,
)

__all__ = [
    "InversionProblem",
    "invert",
    "invert_images",
    "invert_video_joint",
    "invert_video_iterative",
    "invert_nested_first_frame",
    "apply_latent_path",
]
