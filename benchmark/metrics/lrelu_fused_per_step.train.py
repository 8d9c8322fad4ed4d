"""Leaky ReLUs that took the one-pass kernel, a traced step: the count of
the program's `nn.lrelu` spans over the traced steps
(gifgan_tpu_torch/core/profile.py span_summary); nothing where the
program records no step span or no such span."""

from gifgan_tpu_torch.core import profile


def read(run):
    tr = run.get("trace")
    summary = getattr(profile, "span_summary", None)
    spans = summary()["spans"] if tr and summary else {}
    if "vid.step" not in spans or "nn.lrelu" not in spans:
        return None
    return spans["nn.lrelu"]["count"] / tr["steps"]
