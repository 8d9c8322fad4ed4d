"""The reader of the folded batch norms' count (bn_folded_per_step.train):
the count of `nn.bn_fold` spans over the traced steps on a hand-made
summary, nothing without a trace, a step span or a fold span, and 20 a
step in a traced run of the cell at CPU test sizes."""

import pytest
import torch

from benchmark import run as R
from benchmark.tests.small import small_spec
from gifgan_tpu_torch.core import profile

NAME = "bn_folded_per_step.train"


def _span(count, device_s):
    return {"count": count, "device_s": device_s, "host_s": device_s,
            "self_device_s": device_s}


SUMMARY = {"steps": 2, "spans": {"vid.step": _span(2, 0.400),
                                 "vid.img_g": _span(6, 0.050),
                                 "nn.bn_fold": _span(40, 0.0004)}}


@pytest.mark.parametrize("drop", [None, "vid.step", "nn.bn_fold"])
def test_reader_on_a_summary(drop, monkeypatch):
    """Count over steps; a program with no step span, or one that folds no
    batch norm (as the program did before the fold), reports nothing, not
    0."""
    spans = {k: v for k, v in SUMMARY["spans"].items() if k != drop}
    monkeypatch.setattr(profile, "span_summary",
                        lambda: {"steps": 2, "spans": spans})
    read = R.load("metrics", NAME).read
    assert read({"trace": None}) is None
    assert read({"trace": {"steps": 2}}) == (20 if drop is None else None)
    monkeypatch.delattr(profile, "span_summary")     # a program without
    assert read({"trace": {"steps": 2}}) is None


def test_traced_run_counts_20_folds_a_step():
    """3 image G passes of 4 folds and 4 taps of 2, each step."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        spec = small_spec("vid_train_corpus_b256")
        res = R.run_cell(spec, 2 ** 40 + 23, 0.2, True, "cpu")
    finally:
        torch.set_num_threads(n)
    assert res["metrics"][NAME] == {"value": 20.0, "unit": "layers"}
