"""Device time of the frozen image nets a traced step: the spans of the
image G's and the image-D tap's forward calls and of their parts of
the backward passes.
On the device's clock (CUDA events at the spans' ends), from the
program's spans of the traced steps (gifgan_tpu_torch/core/profile.py
span_summary); nothing where the program records none."""

from gifgan_tpu_torch.core import profile

SPANS = ("vid.img_g", "vid.img_d_tap", "vid.img_g.bwd",
         "vid.img_d_tap.bwd")


def read(run):
    tr = run.get("trace")
    summary = getattr(profile, "span_summary", None)
    spans = summary()["spans"] if tr and summary else {}
    if "vid.step" not in spans:
        return None
    s = sum(spans[n]["device_s"] for n in SPANS if n in spans)
    return 1e3 * s / tr["steps"]
