"""Runs gifgan_tpu_torch's video-GAN training step on its fast data
path: `train/vid.py train_chunk_ids` with the resident uint8 corpus of
`data/device.py DeviceCorpus` and its `fold_sample_fn` (K1,
`kernels/gather.py gather_rows_scaled`), one step a call, as
`train-vid --device-corpus` runs it at its default --chunk 1.
"""

from __future__ import annotations

from typing import Dict

import torch

from gifgan_tpu_torch.core.config import (DCGANConfig, TrainConfig,
                                          VidGANConfig)
from gifgan_tpu_torch.data.device import DeviceCorpus
from gifgan_tpu_torch.train import vid as vid_train
from gifgan_tpu_torch.train.gan import make_optimizer

from benchmark.entries import _tree
from benchmark.peaks import k1_bytes

K1 = "gather_rows_scaled"
TRAINED = {"opt_d": "vid_discriminator", "opt_g": "vid_generator"}
VID = "vid/"        # where the gradient trees hold the trained video net


def program_configs(cfg: Dict, batch: int):
    img = DCGANConfig(**cfg["image_gan"], compute_dtype=cfg["compute_dtype"])
    vcfg = VidGANConfig(
        z_input_size=cfg["z_input_size"], z_output_size=cfg["z_output_size"],
        vid_length=cfg["vid_length"], hidden_dim=cfg["hidden_dim"],
        d_filters=cfg["d_filters"], image_noise_std=cfg["image_noise_std"],
        activation_noise_std=cfg["activation_noise_std"],
        first_frame_loss_scalar=cfg["first_frame_loss_scalar"],
        image_gan=img, compute_dtype=cfg["compute_dtype"])
    tcfg = TrainConfig(batch_size=batch, learning_rate=cfg["learning_rate"],
                       beta1=cfg["beta1"], disc_updates=cfg["disc_updates"],
                       gen_updates=cfg["gen_updates"])
    return vcfg, tcfg


class Cell:
    """The program's state, built from the benchmark's weights, and one
    training step a call."""

    def __init__(self, cfg: Dict, traffic, weights: Dict[str, torch.Tensor],
                 device):
        self.traffic = traffic
        self.cfg, self.tcfg = program_configs(cfg, traffic.batch)
        tree = _tree.nest({k: v.clone() for k, v in weights.items()})
        opt = make_optimizer(self.tcfg)
        params = tree["params"]
        self.ts = vid_train.VidTrainState(
            params=params, state=tree["state"],
            opt_g=opt.init({"vid": params["vid_generator"]}),
            opt_d=opt.init({"vid": params["vid_discriminator"]}),
            step=torch.zeros((), dtype=torch.int32, device=device))
        self.first = {k: weights[f"params/{k}"] for k in self._trained()}
        self.corpus = DeviceCorpus(traffic.host_corpus(), method="kernel",
                                   device=device)
        self.gen = torch.Generator(device=device)   # noise stds are 0
        self.items_per_call = traffic.batch
        self.history = None     # a list keeps each call's ids (work())

    def _trained(self):
        return [f"{net}/{k}" for net in TRAINED.values()
                for k in _tree.flat(self.ts.params[net])]

    def call(self) -> torch.Tensor:
        """One step; returns the scalar the loop fetches (the D loss)."""
        step = self.traffic.next()
        if self.history is not None:
            self.history.append(step["ids"])
        self.ts, m = vid_train.train_chunk_ids(
            self.ts, step["ids"][None], step["z"][None], self.gen,
            self.corpus.data, self.cfg, self.tcfg,
            self.corpus.fold_sample_fn)
        self.metrics = m
        return m["d_loss"][-1]

    def work(self) -> Dict[str, Dict[str, float]]:
        """What the calls kept in `history` asked of K1, summed: the bytes
        it needs (benchmark/peaks.py k1_bytes)."""
        d, total = self.corpus.data.shape[1], 0
        for ids in self.history:
            rows = ids.clamp(0, self.corpus.n - 1)
            total += k1_bytes(int(torch.unique(rows).numel()), rows.numel(),
                              d)
        return {K1: {"bytes": total}}

    def losses(self):
        return [float(self.metrics["d_loss"][-1]),
                float(self.metrics["g_loss"][-1])]

    def call_watched(self) -> torch.Tensor:
        """call(), keeping the norms of the first gradient that the D's
        and the G's optimizer each get in it (first_grads)."""
        with _tree.optimizer_inputs() as seen:
            out = self.call()
        d, g = seen[0], seen[self.tcfg.disc_updates]
        self.first_grads = {}
        for net, norms in ((TRAINED["opt_d"], d), (TRAINED["opt_g"], g)):
            self.first_grads.update({f"{net}/{k[len(VID):]}": v for k, v
                                     in norms.items() if k.startswith(VID)})
        return out

    def change_norms(self) -> Dict[str, float]:
        """Norms of each trained leaf's change since the first weights."""
        now = _tree.flat(self.ts.params)
        return _tree.norms({k: now[k] - v for k, v in self.first.items()})

    def free(self):
        self.ts = self.corpus = self.metrics = None

