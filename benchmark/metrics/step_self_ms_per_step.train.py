"""Device time of a traced step outside the step span's children (K1,
the frames' statistics, the noise, the glue between updates).
On the device's clock (CUDA events at the spans' ends), from the
program's spans of the traced steps (gifgan_tpu_torch/core/profile.py
span_summary); nothing where the program records none."""

from gifgan_tpu_torch.core import profile


def read(run):
    tr = run.get("trace")
    summary = getattr(profile, "span_summary", None)
    spans = summary()["spans"] if tr and summary else {}
    if "vid.step" not in spans:
        return None
    return 1e3 * spans["vid.step"]["self_device_s"] / tr["steps"]
