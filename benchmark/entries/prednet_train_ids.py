"""Runs gifgan_tpu_torch's PredNet training step on its device-corpus
path: `train/prednet.py train_step_ids` with the resident uint8 corpus of
`data/device.py DeviceCorpus(method="take", out_range="unit")`, one step
a call, as `train-prednet --device-corpus` runs it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from gifgan_tpu_torch.core.config import TrainConfig
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.models import prednet
from gifgan_tpu_torch.train import prednet as ptrain
from gifgan_tpu_torch.train.gan import make_optimizer

from benchmark.entries import _tree
from benchmark.reference.prednet_kitti import (NET, PREFIX, keras_init,
                                               pred_sample)


@contextlib.contextmanager
def forward_predictions():
    """Inside the block, the predictions of every forward pass that the
    program's model runs, in order: a list of tensors. The pass itself
    runs unchanged."""
    seen: List[torch.Tensor] = []
    forward = prednet.forward

    def watched(*args, **kw):
        out = forward(*args, **kw)
        seen.append(out[0].detach())
        return out

    prednet.forward = watched
    try:
        yield seen
    finally:
        prednet.forward = forward


def program_configs(cfg: Dict, batch: int):
    pcfg = prednet.PredNetConfig(
        c_dim=cfg["stack_sizes"][0], stack_sizes=tuple(cfg["stack_sizes"]),
        r_stack_sizes=tuple(cfg["r_stack_sizes"]), frame=tuple(cfg["frame"]),
        lstm_gate=cfg["lstm_gate"], compute_dtype=cfg["compute_dtype"])
    tcfg = TrainConfig(batch_size=batch, learning_rate=cfg["learning_rate"],
                       beta1=cfg["beta1"])
    return pcfg, tcfg


class Cell:
    """The program's state, built from the benchmark's weights, and one
    training step a call."""

    def __init__(self, cfg: Dict, traffic, weights: Dict[str, torch.Tensor],
                 device):
        self.traffic = traffic
        self.cfg, self.tcfg = program_configs(cfg, traffic.batch)
        first = {NET + k[len(PREFIX):]: v for k, v in
                 keras_init(weights).items() if k.startswith(PREFIX)}
        params = _tree.nest({k[len(NET):]: v.clone()
                             for k, v in first.items()})
        self.ts = ptrain.PredNetTrainState(
            params=params, opt=make_optimizer(self.tcfg).init(params),
            step=torch.zeros((), dtype=torch.int32, device=device))
        self.first = first
        self.corpus = DeviceCorpus(traffic.host_corpus(), method="take",
                                   out_range="unit", device=device)
        self.items_per_call = traffic.batch
        self.history = None     # calls kept for work(): none needed

    def call(self) -> torch.Tensor:
        """One step; returns the scalar the loop fetches (the loss)."""
        step = self.traffic.next()
        self.ts, self.metrics = ptrain.train_step_ids(
            self.ts, step["ids"], self.corpus.sample, self.cfg, self.tcfg)
        return self.metrics["loss"]

    def work(self) -> Dict[str, Dict[str, float]]:
        """The step runs no hand-written kernel whose work a metric reads."""
        return {}

    def losses(self):
        return [float(self.metrics["loss"])]

    def call_watched(self) -> torch.Tensor:
        """call(), keeping the norms of the gradient that the optimizer
        gets in it (first_grads) and a sample of the predictions that its
        forward pass makes (first_preds)."""
        with _tree.optimizer_inputs() as seen, \
                forward_predictions() as preds:
            out = self.call()
        self.first_grads = {NET + k: v for k, v in seen[0].items()}
        self.first_preds = pred_sample(preds[0])
        return out

    def change_norms(self) -> Dict[str, float]:
        """Norms of each leaf's change since the first weights."""
        now = _tree.flat(self.ts.params, NET)
        return _tree.norms({k: now[k] - v for k, v in self.first.items()})

    def free(self):
        self.ts = self.corpus = self.metrics = None
