"""PredNet training (models/prednet.py): one Adam update a batch of clips
on the model's loss, the mean level-0 error over t >= 1.

The optimizer is train/gan.py `make_optimizer(tcfg)` (the published run
takes Keras's Adam: lr 1e-3, b1 0.9, b2 0.999). `train_step` takes float
clips in [0, 1]; `train_step_ids` takes clip ids and gathers them on the
device first (`sample_fn`: data/device.py DeviceCorpus(method="take",
out_range="unit").sample), as `train-prednet --device-corpus` runs it. A
step returns a new state; the one it was given is not modified.

Spans (core/profile.py), on the clips' device: `prednet.step` around a
whole step (the gather included), `prednet.backward` around the
gradients, `prednet.optimizer` around Adam and its update; inside the
forward pass the model's `prednet.lstm` and `prednet.error`.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core import profile
from gifgan_tpu_torch.core.config import TrainConfig
from gifgan_tpu_torch.models import prednet
from gifgan_tpu_torch.train.gan import (AdamState, _differentiable, _grads,
                                        apply_updates, make_optimizer)

Tensor = torch.Tensor


class PredNetTrainState(NamedTuple):
    params: Dict
    opt: AdamState
    step: Tensor          # int32 scalar


def init_train_state(gen: torch.Generator, cfg: prednet.PredNetConfig,
                     tcfg: TrainConfig, device=None) -> PredNetTrainState:
    """Fresh state on `device`; weights drawn on the CPU from `gen`."""
    device = resolve_device(device)
    params = prednet.init(gen, cfg, device)
    return PredNetTrainState(params, make_optimizer(tcfg).init(params),
                             torch.zeros((), dtype=torch.int32,
                                         device=device))


def _update(ts: PredNetTrainState, clips: Tensor, cfg: prednet.PredNetConfig,
            tcfg: TrainConfig) -> Tuple[PredNetTrainState, Dict]:
    keys, leaves, p = _differentiable(ts.params)
    with torch.enable_grad():
        loss = prednet.loss_fn(p, clips, cfg)
        with profile.span("prednet.backward"):
            grads = _grads(loss, keys, leaves)
    with profile.span("prednet.optimizer"):
        updates, opt = make_optimizer(tcfg).update(grads, ts.opt)
        params = apply_updates(ts.params, updates)
    return (PredNetTrainState(params, opt, ts.step + 1),
            {"loss": loss.detach()})


def train_step(ts: PredNetTrainState, clips: Tensor,
               cfg: prednet.PredNetConfig, tcfg: TrainConfig
               ) -> Tuple[PredNetTrainState, Dict]:
    """One update on (B, T, h, w, c) clips in [0, 1]; metrics {"loss"}."""
    with profile.span("prednet.step", clips.device):
        return _update(ts, clips, cfg, tcfg)


def train_step_ids(ts: PredNetTrainState, ids: Tensor,
                   sample_fn: Callable[[Tensor], Tensor],
                   cfg: prednet.PredNetConfig, tcfg: TrainConfig
                   ) -> Tuple[PredNetTrainState, Dict]:
    """train_step on the clips `sample_fn(ids)` gathers on the device."""
    with profile.span("prednet.step", ids.device):
        return _update(ts, sample_fn(ids), cfg, tcfg)


def predict(ts: PredNetTrainState, clips: Tensor,
            cfg: prednet.PredNetConfig) -> Tensor:
    """Each frame's prediction made before seeing it, (B, T, h, w, c)."""
    with torch.no_grad():
        return prednet.forward(ts.params, clips, cfg)[0]
