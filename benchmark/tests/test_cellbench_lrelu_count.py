"""The reader of the one-pass leaky ReLUs' count (lrelu_fused_per_step.train):
the count of `nn.lrelu` spans over the traced steps on a hand-made
summary, nothing without a trace, a step span or an lrelu span, and
nothing in a traced run of the cell at CPU test sizes, where no lrelu
takes the kernel."""

import pytest
import torch

from benchmark import run as R
from benchmark.tests.small import small_spec
from gifgan_tpu_torch.core import profile

NAME = "lrelu_fused_per_step.train"


def _span(count, device_s):
    return {"count": count, "device_s": device_s, "host_s": device_s,
            "self_device_s": device_s}


SUMMARY = {"steps": 2, "spans": {"vid.step": _span(2, 0.400),
                                 "vid.img_d_tap": _span(8, 0.060),
                                 "nn.lrelu": _span(48, 0.0120)}}


@pytest.mark.parametrize("drop", [None, "vid.step", "nn.lrelu"])
def test_reader_on_a_summary(drop, monkeypatch):
    """Count over steps; a program with no step span, or one whose lrelus
    take no kernel (as the program did before it, and as the CPU does),
    reports nothing, not 0."""
    spans = {k: v for k, v in SUMMARY["spans"].items() if k != drop}
    monkeypatch.setattr(profile, "span_summary",
                        lambda: {"steps": 2, "spans": spans})
    read = R.load("metrics", NAME).read
    assert read({"trace": None}) is None
    assert read({"trace": {"steps": 2}}) == (24 if drop is None else None)
    monkeypatch.delattr(profile, "span_summary")     # a program without
    assert read({"trace": {"steps": 2}}) is None


def test_traced_cpu_run_reports_nothing():
    """On the CPU every lrelu takes the expression: no span, no metric,
    while the step's other span metrics are there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        spec = small_spec("vid_train_corpus_b256")
        res = R.run_cell(spec, 2 ** 40 + 29, 0.2, True, "cpu")
    finally:
        torch.set_num_threads(n)
    assert NAME in spec["per_layer"]
    assert NAME not in res["metrics"]
    assert res["metrics"]["bn_folded_per_step.train"]["value"] == 20.0
