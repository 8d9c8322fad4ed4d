"""Inference batch norms folded into the layer before them, a traced
step: the count of the program's `nn.bn_fold` spans of the traced steps
(gifgan_tpu_torch/core/profile.py span_summary); nothing where the
program records no step span or no fold."""

from gifgan_tpu_torch.core import profile


def read(run):
    tr = run.get("trace")
    summary = getattr(profile, "span_summary", None)
    spans = summary()["spans"] if tr and summary else {}
    if "vid.step" not in spans or "nn.bn_fold" not in spans:
        return None
    return spans["nn.bn_fold"]["count"] / tr["steps"]
