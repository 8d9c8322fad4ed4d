"""The port's PredNet at the published structure (gifgan_tpu_torch/
models/prednet.py with stack_sizes, r_stack_sizes, rectangular frames and
hard_sigmoid gates; train/prednet.py) against the benchmark's plain
reference (benchmark/reference/prednet_kitti.py) on seeded random
weights, on the CPU at a small size: 16x24 frames, stacks (3, 8, 12, 16)
for A and R, 4 time steps, 3 clips. Then `train-prednet` through
`cli.main` on a device corpus, with a resume.

Tolerances, each with its reason, read over 12 seeds:
- float32: predictions and the loss within 1e-6 of the largest |value|
  (read: up to 3.6e-7 and 7e-8), each gradient leaf within 1e-5 of its
  largest |value| (read: up to 1.4e-6): the same function in another
  rounding (channels-last convolutions, a fused gate conv, the port's
  hard sigmoid as hardsigmoid(1.2x)) through 4 recurrent steps and back;
  one Adam step within 1e-6 (a thousandth of the learning rate) where the
  gradient stands clear of rounding, as Adam's first update is lr times
  the gradient's sign;
- bfloat16 convolutions (the benchmark's compute_dtype) against the
  float32 reference: predictions within 2e-2 of the largest (read: up to
  8.0e-3), the loss within 1e-3 relative (2.5e-4), each gradient leaf's
  norm within 4e-2 of the larger of its norm and the median leaf's, the
  benchmark check's rule (1.3e-2): each convolution rounds its operands
  and output to 8 bits of mantissa (2^-9 relative), compounded over 4
  steps and back.
"""

import os
import statistics

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import _plain
from benchmark.reference import prednet_kitti as ref
from gifgan_tpu_torch import cli
from gifgan_tpu_torch.core import checkpoint as ckpt
from gifgan_tpu_torch.core.config import TrainConfig
from gifgan_tpu_torch.core.tree import flatten, unflatten
from gifgan_tpu_torch.models import prednet
from gifgan_tpu_torch.train import prednet as ptrain
from gifgan_tpu_torch.train.gan import (_differentiable, _grads,
                                        make_optimizer)

STACKS = (3, 8, 12, 16)
FRAME = (16, 24)
CFG = {"stack_sizes": list(STACKS), "r_stack_sizes": list(STACKS),
       "frame": list(FRAME), "pixel_max": 1.0, "lstm_gate": "hard_sigmoid",
       "layer_loss_weights": [1.0, 0.0, 0.0, 0.0], "learning_rate": 1e-3,
       "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcfg(dtype="float32"):
    return prednet.PredNetConfig(c_dim=3, stack_sizes=STACKS,
                                 r_stack_sizes=STACKS, frame=FRAME,
                                 lstm_gate="hard_sigmoid",
                                 compute_dtype=dtype)


def _setup(seed):
    """(reference params {"<layer>/<leaf>"}, port params, clips)."""
    gen = torch.Generator().manual_seed(seed)
    w = ref.keras_init(inputs.make_weights(ref.param_specs(CFG), gen, "cpu"))
    flat = {k[len(ref.PREFIX):]: v for k, v in w.items()}
    clips = torch.rand((3, 4, *FRAME, 3), generator=gen)
    return flat, unflatten({k: v.clone() for k, v in flat.items()}), clips


def _close(got, want, rtol, what):
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= rtol, (what, err)


def _port_grads(params, clips, cfg):
    keys, leaves, p = _differentiable(params)
    with torch.enable_grad():
        loss = prednet.loss_fn(p, clips, cfg)
        return loss, flatten(_grads(loss, keys, leaves))


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_equals_the_reference(seed):
    flat, params, clips = _setup(seed)
    cfg = _pcfg()
    with torch.no_grad():
        preds, loss = prednet.forward(params, clips, cfg)
        ref_preds, ref_loss = ref.forward(flat, clips, CFG)
    _close(preds, ref_preds, 1e-6, "predictions")
    _close(loss, ref_loss, 1e-6, "loss")
    loss, grads = _port_grads(params, clips, cfg)
    _, ref_grads, _ = ref.loss_and_grads(flat, clips, CFG)
    assert sorted(grads) == sorted(ref_grads)
    for k, g in ref_grads.items():
        assert float(g.abs().max()) > 0, k
        _close(grads[k], g, 1e-5, k)

    tcfg = TrainConfig(batch_size=3, learning_rate=1e-3, beta1=0.9)
    ts = ptrain.init_train_state(torch.Generator(), cfg, tcfg, "cpu")
    ts, metrics = ptrain.train_step(ts._replace(
        params=params, opt=make_optimizer(tcfg).init(params)),
        clips, cfg, tcfg)
    _close(metrics["loss"], ref_loss, 1e-6, "step loss")
    adam = _plain.Adam(flat, 1e-3, 0.9, 0.999, 1e-8)
    want = adam.step(flat, ref_grads)
    got = flatten(ts.params)
    for k, g in ref_grads.items():
        clear = g.abs() > 1e-3 * g.abs().max()
        diff = (got[k] - want[k]).abs()[clear]
        assert float(diff.max()) <= 1e-6, k
    assert int(ts.step) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_bfloat16_is_near_the_reference(seed):
    flat, params, clips = _setup(seed)
    cfg = _pcfg("bfloat16")
    with torch.no_grad():
        preds, loss = prednet.forward(params, clips, cfg)
        ref_preds, ref_loss = ref.forward(flat, clips, CFG)
    assert preds.dtype == loss.dtype == torch.float32
    _close(preds, ref_preds, 2e-2, "predictions")
    assert abs(float(loss) / float(ref_loss) - 1.0) <= 1e-3
    _, grads = _port_grads(params, clips, cfg)
    _, ref_grads, _ = ref.loss_and_grads(flat, clips, CFG)
    want = {k: float(g.norm()) for k, g in ref_grads.items()}
    floor = statistics.median(want.values())
    for k, v in want.items():
        assert abs(float(grads[k].norm()) - v) <= 4e-2 * max(v, floor), k


def test_the_minimal_model_is_a_case_of_the_widths():
    """channels (c0, c1) is stacks (c_dim, c0), R (c0, c1): the same
    parameter shapes and the same forward pass."""
    small = prednet.PredNetConfig(image_size=16, c_dim=3, channels=(8, 16))
    wide = prednet.PredNetConfig(image_size=16, c_dim=3, stack_sizes=(3, 8),
                                 r_stack_sizes=(8, 16))
    a = prednet.init(torch.Generator().manual_seed(0), small, "cpu")
    b = prednet.init(torch.Generator().manual_seed(0), wide, "cpu")
    for k, v in flatten(a).items():
        assert torch.equal(v, flatten(b)[k]), k
    clips = torch.rand((2, 3, 16, 16, 3), generator=torch.Generator())
    torch.testing.assert_close(prednet.loss_fn(a, clips, small),
                               prednet.loss_fn(a, clips, wide), rtol=0,
                               atol=0)


def test_glorot_uniform_limits():
    """Keras's glorot_uniform: within sqrt(6 / (fan_in + fan_out)), the
    gate conv's fans those of one of its four gates."""
    cfg = prednet.PredNetConfig(c_dim=3, stack_sizes=(3, 48),
                                r_stack_sizes=(48, 96), frame=(16, 24),
                                lstm_gate="hard_sigmoid")
    p = prednet.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for key, fan_in, fan_out in (("lstm0", 6 + 96 + 48, 48),
                                 ("ahat0", 48, 3), ("up0", 6, 48)):
        w, limit = p[key]["w"], np.sqrt(6.0 / (9 * (fan_in + fan_out)))
        assert float(w.abs().max()) <= limit
        assert float(w.abs().max()) > 0.95 * limit, key
        assert float(p[key]["b"].abs().max()) == 0.0


def test_bad_widths_are_refused():
    with pytest.raises(ValueError, match="stack_sizes"):
        prednet.PredNetConfig(c_dim=3, stack_sizes=(1, 8),
                              r_stack_sizes=(8, 8)).widths()
    with pytest.raises(ValueError, match="divisible"):
        prednet.PredNetConfig(c_dim=3, stack_sizes=STACKS,
                              r_stack_sizes=STACKS, frame=(16, 20)).hw()


def test_cli_train_prednet_device_corpus_and_resume(tmp_path):
    run = tmp_path / "run"
    argv = ["train-prednet", "--run-dir", str(run), "--stack-sizes", "3",
            "4", "6", "--r-stack-sizes", "4", "6", "8", "--frame", "16",
            "24", "--nt", "3", "--batch-size", "2", "--dataset-size", "4",
            "--device-corpus", "--checkpoint-every", "2", "--sample-every",
            "2", "--device", "cpu"]
    cli.main(argv + ["--steps-limit", "2"])
    assert ckpt.all_steps(str(run / "checkpoints")) == [2]
    cli.main(argv + ["--steps-limit", "4"])
    assert ckpt.all_steps(str(run / "checkpoints")) == [2, 4]
    with open(run / "train_metrics.jsonl") as f:
        steps = [line for line in f if '"loss"' in line]
    assert len(steps) == 4
    assert os.path.exists(run / "pred_000004.gif")
    tcfg = TrainConfig(run_dir=str(run))
    cfg = prednet.PredNetConfig(c_dim=3, stack_sizes=(3, 4, 6),
                                r_stack_sizes=(4, 6, 8), frame=(16, 24),
                                lstm_gate="hard_sigmoid")
    ts = ckpt.restore(str(run / "checkpoints"), ptrain.init_train_state(
        torch.Generator(), cfg, tcfg, "cpu"))
    assert int(ts.step) == 4 and int(ts.opt.count) == 4
