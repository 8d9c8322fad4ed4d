"""The correctness check against what it must refuse: the control (the
plain reference computed in the precision below the configuration's, in
the program's place) and the program with a fault planted underneath a
run (benchmark/faults.py). On the CPU at a small size, in float32; the
control, and the fault in the G's backward pass, also on the card at
each cell's own size."""

import pytest

from benchmark import calibrate, faults
from benchmark import run as R
from benchmark.tests.small import fault_spec, small_spec

CELLS = ("vid_train_corpus_b256",)


def _judge(spec, numbers):
    limits = spec["workload"]["limits"]
    return all(numbers[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = R.run_cell(fault_spec(name), 2 ** 40 + 11, 0.2, False, "cpu")
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_refused(name, fault):
    with faults.planted(fault):
        res = R.run_cell(fault_spec(name), 2 ** 40 + 11, 0.2, False, "cpu")
    assert res["correct"] is False, res["checks"]


def _control_numbers(spec, seed, device):
    check = R.load("checks", spec["workload"]["check"])
    reference = R.load("reference", spec["config_name"])
    prog, weights, traffic = calibrate.readings(spec, seed, device)
    corpus = traffic.device_corpus()
    ref = reference.train_readings(weights, corpus, traffic.recorded,
                                   spec["config"])
    ctl = calibrate.control_readings(spec, weights, corpus, traffic)
    return check.numbers(ctl, ref, spec["workload"]["nets"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused_small(name):
    spec = small_spec(name)
    assert not _judge(spec, _control_numbers(spec, 2 ** 40 + 13, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 41 + 1, 2 ** 41 + 2, 2 ** 41 + 3])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused_on_card(card, name, seed):
    spec = R.cell_spec(name)
    assert not _judge(spec, _control_numbers(spec, seed, card))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_g_backward_is_refused_on_card(card, name):
    """A wrong backward pass in the G's path alone, at the cell's size."""
    with faults.planted("g_backward"):
        res = R.run_cell(R.cell_spec(name), 2 ** 41 + 7, 1.0, False, card)
    assert res["correct"] is False, res["checks"]
