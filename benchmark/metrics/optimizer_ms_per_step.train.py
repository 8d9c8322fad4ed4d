"""Device time of Adam a traced step: the spans of each update's Adam,
scaling and apply.
On the device's clock (CUDA events at the spans' ends), from the
program's spans of the traced steps (gifgan_tpu_torch/core/profile.py
span_summary); nothing where the program records none."""

from gifgan_tpu_torch.core import profile

SPANS = ("vid.optimizer",)


def read(run):
    tr = run.get("trace")
    summary = getattr(profile, "span_summary", None)
    spans = summary()["spans"] if tr and summary else {}
    if "vid.step" not in spans:
        return None
    s = sum(spans[n]["device_s"] for n in SPANS if n in spans)
    return 1e3 * s / tr["steps"]
