"""What the PredNet span metrics share (not a metric itself: the harness
loads a metric by its name in BENCHMARK.json): a span of the program's
traced steps, a step, from gifgan_tpu_torch/core/profile.py
span_summary; nothing where the program records no `prednet.step` span
or not the span asked for."""

from gifgan_tpu_torch.core import profile


def _spans(run, span):
    tr = run.get("trace")
    summary = getattr(profile, "span_summary", None)
    spans = summary()["spans"] if tr and summary else {}
    if "prednet.step" not in spans or span not in spans:
        return None, None
    return spans[span], tr["steps"]


def ms_per_step(run, span):
    """The span's device time a traced step, in ms, on the device's clock
    (CUDA events at the spans' ends)."""
    s, steps = _spans(run, span)
    return None if s is None else 1e3 * s["device_s"] / steps


def count_per_step(run, span):
    """How many times the span was recorded a traced step."""
    s, steps = _spans(run, span)
    return None if s is None else s["count"] / steps
