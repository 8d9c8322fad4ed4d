"""recurrent_image GAN training (gifgan_tpu/train/recurrent.py).

Clips of T+1 frames: X = frames 0..T-1, Y = frames 1..T. A step is
`disc_updates` D updates, then `gen_updates` G updates, each with the
optimizer of train/gan.py `make_optimizer(tcfg)` (the JAX step uses its
"g" role for D as well, so `d_learning_rate` does not reach this family).
G's loss is `adv_w * adv + pixel_loss_scalar * mean|fake - Y|`, with
adv_w = adversarial_loss_scalar, zeroed while `step < adversarial_after_steps`.

Dropout masks (cfg.lstm_dropout > 0) come from the step's torch generator,
one draw per update; `dropout_masks=` passes them in instead, so a test
can give the JAX package's threefry masks. A step returns a new state; the
one it was given is not modified.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import RecurrentImageConfig, TrainConfig
from gifgan_tpu_torch.models import recurrent_image as ri
from gifgan_tpu_torch.ops import nn
from gifgan_tpu_torch.train.gan import (AdamState, _differentiable, _grads,
                                        apply_updates, make_optimizer)

Tensor = torch.Tensor


class RecurrentTrainState(NamedTuple):
    params_g: Dict
    params_d: Dict
    opt_g: AdamState
    opt_d: AdamState
    step: Tensor          # int32 scalar

    @classmethod
    def from_tree(cls, tree: Dict) -> "RecurrentTrainState":
        """From the nested dicts of core/interop.from_jax_flat."""
        return cls(params_g=tree["params_g"], params_d=tree["params_d"],
                   opt_g=AdamState(**tree["opt_g"]),
                   opt_d=AdamState(**tree["opt_d"]), step=tree["step"])


def init_train_state(gen: torch.Generator, cfg: RecurrentImageConfig,
                     tcfg: TrainConfig, device=None) -> RecurrentTrainState:
    """Fresh state on `device`; weights drawn on the CPU from `gen`."""
    device = resolve_device(device)
    pg, pd = ri.init(gen, cfg, device)
    opt = make_optimizer(tcfg)
    return RecurrentTrainState(pg, pd, opt.init(pg), opt.init(pd),
                               torch.zeros((), dtype=torch.int32,
                                           device=device))


def split_xy(clips: Tensor) -> Tuple[Tensor, Tensor]:
    """clips (B, T+1, s, s, c) in [0, 1] -> (frames 0..T-1, frames 1..T)."""
    return clips[:, :-1], clips[:, 1:]


def train_step(ts: RecurrentTrainState, clips: Tensor,
               gen: Optional[torch.Generator], cfg: RecurrentImageConfig,
               tcfg: TrainConfig,
               dropout_masks: Optional[List[Tensor]] = None,
               ) -> Tuple[RecurrentTrainState, Dict]:
    """One batch of (B, T+1, s, s, c) clips in [0, 1]. gen: the dropout
    generator on the clips' device (unused without dropout).
    dropout_masks: one (layers, T, B, units) mask per update, D's first,
    in place of draws from gen."""
    opt = make_optimizer(tcfg)
    x, y = split_xy(clips)
    metrics = {}

    def dropout(u):
        if dropout_masks is not None:
            return dropout_masks[u]
        return gen if cfg.lstm_dropout else None

    for u in range(tcfg.disc_updates):
        with torch.no_grad():            # D never needs gradients through G
            fake = ri.generator(ts.params_g, x, cfg, d_params=ts.params_d,
                                dropout=dropout(u))
        keys, leaves, pd = _differentiable(ts.params_d)
        with torch.enable_grad():
            logits_fake = ri.discriminator(pd, fake, cfg)
            logits_real = ri.discriminator(pd, y, cfg)
            lf = nn.sigmoid_ce(logits_fake, torch.zeros_like(logits_fake))
            lr = nn.sigmoid_ce(logits_real, torch.ones_like(logits_real))
            d_loss = lf + lr
            grads = _grads(d_loss, keys, leaves)
        updates, opt_d = opt.update(grads, ts.opt_d)
        ts = ts._replace(params_d=apply_updates(ts.params_d, updates),
                         opt_d=opt_d)
        metrics.update(d_loss=d_loss.detach(), d_loss_fake=lf.detach(),
                       d_loss_real=lr.detach())

    adv_w = cfg.adversarial_loss_scalar
    if cfg.adversarial_after_steps:      # a tensor: no host sync on step
        adv_w = adv_w * (ts.step >= cfg.adversarial_after_steps).float()
    for u in range(tcfg.gen_updates):
        keys, leaves, pg = _differentiable(ts.params_g)
        with torch.enable_grad():
            fake = ri.generator(pg, x, cfg, d_params=ts.params_d,
                                dropout=dropout(tcfg.disc_updates + u))
            logits_fake = ri.discriminator(ts.params_d, fake, cfg)
            adv = nn.sigmoid_ce(logits_fake, torch.ones_like(logits_fake))
            pix = torch.mean(torch.abs(fake - y))
            g_loss = adv_w * adv + cfg.pixel_loss_scalar * pix
            grads = _grads(g_loss, keys, leaves)
        updates, opt_g = opt.update(grads, ts.opt_g)
        ts = ts._replace(params_g=apply_updates(ts.params_g, updates),
                         opt_g=opt_g)
        metrics.update(g_loss=g_loss.detach(), g_loss_adv=adv.detach(),
                       pixel_mae=pix.detach())
    return ts._replace(step=ts.step + 1), metrics


def predict(ts: RecurrentTrainState, clips: Tensor,
            cfg: RecurrentImageConfig) -> Tensor:
    """Teacher-forced next-frame predictions for a (B, T+1, ...) batch."""
    with torch.no_grad():
        return ri.generator(ts.params_g, split_xy(clips)[0], cfg,
                            d_params=ts.params_d)


def sample_rollout(ts: RecurrentTrainState, first_frames: Tensor,
                   length: int, cfg: RecurrentImageConfig) -> Tensor:
    """(B, s, s, c) first frames -> (B, length, s, s, c) rolled out."""
    with torch.no_grad():
        return ri.rollout(ts.params_g, first_frames, length, cfg,
                          d_params=ts.params_d)
