"""The readers of the program's spans: exact on a hand-made summary,
nothing without a trace or a step span, and all six in a traced run of
the cell at CPU test sizes."""

import pytest
import torch

from benchmark import run as R
from benchmark.tests.small import small_spec
from gifgan_tpu_torch.core import profile

READERS = ("forward_ms_per_step.train", "backward_ms_per_step.train",
           "optimizer_ms_per_step.train", "frozen_nets_ms_per_step.train",
           "vid_nets_ms_per_step.train", "step_self_ms_per_step.train")


def _span(device_s, self_device_s=None):
    return {"count": 1, "device_s": device_s, "host_s": device_s,
            "self_device_s": (device_s if self_device_s is None
                              else self_device_s)}


SUMMARY = {"steps": 2, "spans": {
    "vid.step": _span(0.400, 0.004),
    "vid.vid_g": _span(0.002), "vid.img_g": _span(0.050),
    "vid.img_d_tap": _span(0.080), "vid.vid_d": _span(0.010),
    "vid.loss": _span(0.001),
    "vid.backward": _span(0.240, 0.003),
    "vid.vid_d.bwd": _span(0.020), "vid.img_d_tap.bwd": _span(0.120),
    "vid.img_g.bwd": _span(0.090), "vid.vid_g.bwd": _span(0.007),
    "vid.optimizer": _span(0.013)}}
WANT = {"forward_ms_per_step.train": 1e3 * 0.143 / 2,
        "backward_ms_per_step.train": 1e3 * 0.240 / 2,
        "optimizer_ms_per_step.train": 1e3 * 0.013 / 2,
        "frozen_nets_ms_per_step.train": 1e3 * 0.340 / 2,
        "vid_nets_ms_per_step.train": 1e3 * 0.039 / 2,
        "step_self_ms_per_step.train": 1e3 * 0.004 / 2}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_summary(name, monkeypatch):
    monkeypatch.setattr(profile, "span_summary", lambda: SUMMARY)
    read = R.load("metrics", name).read
    assert read({"trace": {"steps": 2}}) == pytest.approx(WANT[name])
    assert read({"trace": None}) is None
    no_step = {"steps": 2, "spans": dict(SUMMARY["spans"])}
    del no_step["spans"]["vid.step"]
    monkeypatch.setattr(profile, "span_summary", lambda: no_step)
    assert read({"trace": {"steps": 2}}) is None
    monkeypatch.delattr(profile, "span_summary")     # a program without
    assert read({"trace": {"steps": 2}}) is None


def test_traced_run_reports_the_spans():
    """A traced run of the cell at CPU test sizes: the six metrics, and
    forward, backward, Adam and the step's own time fill the step."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        spec = small_spec("vid_train_corpus_b256")
        res = R.run_cell(spec, 2 ** 40 + 21, 0.2, True, "cpu")
    finally:
        torch.set_num_threads(n)
    got = {k: res["metrics"][k]["value"] for k in READERS}
    assert all(v > 0 for v in got.values()), got
    steps = spec["workload"]["trace_steps"]
    step_ms = 1e3 * profile.span_summary()["spans"]["vid.step"][
        "device_s"] / steps
    whole = sum(got[k] for k in ("forward_ms_per_step.train",
                                 "backward_ms_per_step.train",
                                 "optimizer_ms_per_step.train",
                                 "step_self_ms_per_step.train"))
    assert whole == pytest.approx(step_ms, rel=1e-2)
