"""The prednet_kitti cell: its plain reference against gifgan_tpu_torch,
its FLOP count against a hand count, its files found and run by name, its
span readers, and its check against the float8 control and the planted
faults (benchmark/prednet_faults.py), the unchanged state's by the
change of the weights. On the CPU at a small size with the
published structure (4 levels, hard_sigmoid gates; 16x24 frames, stacks
(3, 8, 12, 16), 4 time steps, 4 clips); the control and the faults also
on the card at the cell's own size."""

import pytest
import torch

from benchmark import calibrate, prednet_faults
from benchmark import run as R
from gifgan_tpu_torch.core import profile

CELL = "prednet_kitti_corpus_b64"
READERS = {"prednet_lstm_ms_per_step.train": "prednet.lstm",
           "prednet_error_ms_per_step.train": "prednet.error",
           "prednet_backward_ms_per_step.train": "prednet.backward"}
UPDATES = "prednet_lstm_updates_per_step.train"


def small_spec(dtype: str = "float32"):
    spec = R.cell_spec(CELL)
    stacks = [3, 8, 12, 16]
    spec["config"].update(stack_sizes=stacks, r_stack_sizes=stacks,
                          frame=[16, 24], compute_dtype=dtype)
    spec["traffic"].update(corpus_clips=16, clip_frames=4, frame=[16, 24, 3],
                           batch_size=4)
    spec["workload"]["trace_steps"] = 2
    return spec


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _judge(spec, numbers):
    limits = spec["workload"]["limits"]
    return all(numbers[k] <= limits[k] for k in limits)


def _readings(spec, seed, device):
    """(program numbers, control numbers) of one seed."""
    check = R.load("checks", spec["workload"]["check"])
    reference = R.load("reference", spec["config_name"])
    nets = spec["workload"]["nets"]
    prog, weights, traffic = calibrate.readings(spec, seed, device)
    corpus = traffic.device_corpus()
    ref = reference.train_readings(weights, corpus, traffic.recorded,
                                   spec["config"])
    ctl = calibrate.control_readings(spec, weights, corpus, traffic)
    return check.numbers(prog, ref, nets), check.numbers(ctl, ref, nets)


def test_steps_match_the_reference(two_threads):
    """float32: the entry's first steps as the check reads them against
    the reference's: the same losses, step 1's gradient leaf by leaf and
    the change after three steps by the check's rule."""
    spec = small_spec()
    prog, _ = _readings(spec, 3, "cpu")
    assert prog["first_loss_gap"] < 1e-6, prog
    assert prog["p_grad_gap"] < 1e-4 and prog["change_gap"] < 1e-3, prog


def test_hand_count():
    """13.74 GFLOP a frame-step at the published widths, by hand: per
    level the gate conv, A_hat's and A's at 128x160 halved a level."""
    spec = R.cell_spec(CELL)
    flops = R.load("flops", spec["config_name"])
    pos = [128 * 160 // 4 ** l for l in range(4)]
    gate_in = [6 + 48 + 3, 96 + 96 + 48, 192 + 192 + 96, 384 + 192]
    gate_out = [12, 192, 384, 768]
    hand = sum(2 * pos[l] * 9 * (gate_in[l] * gate_out[l])
               for l in range(4))
    hand += sum(2 * pos[l] * 9 * c_in * c_out for l, c_in, c_out in
                ((0, 3, 3), (1, 48, 48), (2, 96, 96), (3, 192, 192)))
    hand += sum(2 * pos[l] * 9 * c_in * c_out for l, c_in, c_out in
                ((0, 6, 48), (1, 96, 96), (2, 192, 192)))
    assert flops.frame_step_flops(spec["config"]) == hand
    assert round(hand / 1e9, 2) == 13.74
    assert flops.step_flops(spec["config"], 64, 10) == 3 * 640 * hand


def test_traced_run_of_the_new_files(two_threads):
    """The cell run by name at CPU test sizes, traced: correct, the
    generic metrics and the four PredNet ones, one LSTM update a level a
    time step, and the lstm, error and backward spans inside the step."""
    spec = small_spec()
    res = R.run_cell(spec, 2 ** 40 + 31, 0.2, True, "cpu")
    assert res["correct"] is True, res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {"train_mfu", "host_dispatch_ms_per_step.train",
                        "launches_per_step.train",
                        "pointwise_ms_per_step.train",
                        "conv_ms_per_step.train", "device_idle_pct.train",
                        *READERS, UPDATES}, got
    assert got[UPDATES] == 4 * 4
    spans = profile.span_summary()["spans"]
    step = spans["prednet.step"]["device_s"]
    parts = sum(spans[n]["device_s"] for n in READERS.values())
    assert all(got[k] > 0 for k in READERS) and parts < step


@pytest.mark.parametrize("name", [*READERS, UPDATES])
def test_reader_on_a_summary(name, monkeypatch):
    """Exact on a hand-made summary; nothing without a trace, a step span
    or the metric's span (a program without them, as the parent)."""
    def span(count, device_s):
        return {"count": count, "device_s": device_s, "host_s": device_s,
                "self_device_s": device_s}

    spans = {"prednet.step": span(2, 0.4), "prednet.lstm": span(80, 0.1),
             "prednet.error": span(80, 0.06),
             "prednet.backward": span(2, 0.2)}
    want = {"prednet_lstm_ms_per_step.train": 50.0,
            "prednet_error_ms_per_step.train": 30.0,
            "prednet_backward_ms_per_step.train": 100.0, UPDATES: 40.0}
    read = R.load("metrics", name).read
    monkeypatch.setattr(profile, "span_summary",
                        lambda: {"steps": 2, "spans": spans})
    assert read({"trace": {"steps": 2}}) == pytest.approx(want[name])
    assert read({"trace": None}) is None
    for drop in ("prednet.step", READERS.get(name, "prednet.lstm")):
        rest = {k: v for k, v in spans.items() if k != drop}
        monkeypatch.setattr(profile, "span_summary",
                            lambda: {"steps": 2, "spans": rest})
        assert read({"trace": {"steps": 2}}) is None
    monkeypatch.delattr(profile, "span_summary")
    assert read({"trace": {"steps": 2}}) is None


@pytest.mark.parametrize("fault", prednet_faults.FAULTS)
def test_fault_is_refused_small(fault, two_threads):
    with prednet_faults.planted(fault):
        res = R.run_cell(small_spec(), 2 ** 40 + 11, 0.2, False, "cpu")
    assert res["correct"] is False, res["checks"]
    if fault == "unchanged":
        # no leaf moved where the reference's did: each leaf's gap is 1
        assert res["checks"]["change_gap"]["value"] == 1.0, res["checks"]


def test_faults_are_lifted():
    """After the block the program is the published model again."""
    from gifgan_tpu_torch.models import prednet
    from gifgan_tpu_torch.train import prednet as ptrain

    gates, above = dict(prednet.GATES), prednet._from_above
    step = ptrain.train_step_ids
    for fault in prednet_faults.FAULTS:
        with prednet_faults.planted(fault):
            pass
    assert prednet.GATES == gates and prednet._from_above is above
    assert ptrain.train_step_ids is step


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 41 + 1, 2 ** 41 + 2, 2 ** 41 + 3])
def test_control_is_refused_on_card(card, seed):
    spec = R.cell_spec(CELL)
    prog, ctl = _readings(spec, seed, card)
    assert _judge(spec, prog), prog
    assert not _judge(spec, ctl), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("fault", prednet_faults.FAULTS)
def test_fault_is_refused_on_card(card, fault):
    with prednet_faults.planted(fault):
        res = R.run_cell(R.cell_spec(CELL), 2 ** 41 + 7, 1.0, False, card)
    assert res["correct"] is False, res["checks"]

