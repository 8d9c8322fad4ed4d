"""The cell shrunk to CPU test sizes: widths 8, 32 px, 4 frames."""

from benchmark import run as R


def small_spec(name: str, dtype: str = "float32"):
    spec = R.cell_spec(name)
    cfg, traffic = spec["config"], spec["traffic"]
    cfg["image_gan"].update(output_size=32, gf_dim=8, df_dim=8, z_dim=16)
    cfg.update(z_input_size=20, z_output_size=16, vid_length=4,
               hidden_dim=32, d_filters=16, compute_dtype=dtype)
    traffic.update(corpus_clips=64, clip_frames=4, frame=[32, 32, 3],
                   batch_size=8, z_dim=20)
    spec["workload"]["trace_steps"] = 2
    return spec


def fault_spec(name: str):
    """The cell as the fault tests run it: its published widths (at widths
    of 8 the frozen image nets pass the G a gradient that its first-frame
    term drowns, so a fault in their backward pass would not show),
    float32, 4 frames of 4 clips."""
    spec = R.cell_spec(name)
    spec["config"].update(vid_length=4, compute_dtype="float32")
    spec["traffic"].update(corpus_clips=16, clip_frames=4, batch_size=4)
    spec["workload"]["trace_steps"] = 2
    return spec
