"""Device time of the trained video nets a traced step: the spans of the
vid-G's and the vid-D's forward calls and of their parts of the
backward passes.
On the device's clock (CUDA events at the spans' ends), from the
program's spans of the traced steps (gifgan_tpu_torch/core/profile.py
span_summary); nothing where the program records none."""

from gifgan_tpu_torch.core import profile

SPANS = ("vid.vid_g", "vid.vid_d", "vid.vid_g.bwd", "vid.vid_d.bwd")


def read(run):
    tr = run.get("trace")
    summary = getattr(profile, "span_summary", None)
    spans = summary()["spans"] if tr and summary else {}
    if "vid.step" not in spans:
        return None
    s = sum(spans[n]["device_s"] for n in SPANS if n in spans)
    return 1e3 * s / tr["steps"]
