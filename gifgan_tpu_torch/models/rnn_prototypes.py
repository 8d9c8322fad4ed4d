"""The RNN prototype ladder below the recurrent video GAN
(gifgan_tpu/models/rnn_prototypes.py): small trainables, each with a data
function, a loss and `fit`, the smallest checks that the recurrence
machinery (cells, time loops, conv encoders) learns at all.

1. echo: a tanh RNN outputs the input bit from `delay` steps ago;
2. vector echo: an LSTM echoes a one-hot vector;
3. conv-LSTM classification: which channel of a noisy frame sequence
   carries the moving stripe.

The data functions draw from a torch.Generator on its device (torch cannot
draw threefry's), so a test that compares the packages passes the JAX
batch in. The losses are softmax cross-entropy with integer labels, mean
over the batch; `fit` is Adam (train/gan.py, b1 0.9, as optax.adam) over a
Python loop of steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.rng import PRNGSequence
from gifgan_tpu_torch.core.tree import flatten
from gifgan_tpu_torch.models.dcgan import to_device
from gifgan_tpu_torch.models.recurrent_image import lstm_init, lstm_step
from gifgan_tpu_torch.ops import nn
from gifgan_tpu_torch.train.gan import (Adam, _differentiable, _grads,
                                        apply_updates)

Tensor = torch.Tensor


def _ce(logits: Tensor, labels: Tensor) -> Tensor:
    return F.cross_entropy(logits, labels.long())


# ---------------------------------------------------------------------------
# 1. echo: output the input bit from `delay` steps ago
# ---------------------------------------------------------------------------

def echo_data(gen: torch.Generator, batch: int, length: int, delay: int
              ) -> Tuple[Tensor, Tensor]:
    x = (torch.rand(batch, length, generator=gen, device=gen.device)
         < 0.5).float()
    y = torch.roll(x, delay, dims=1)
    y[:, :delay] = 0.0
    return x, y


def echo_rnn_init(gen: torch.Generator, hidden: int = 16,
                  device=None) -> Dict:
    device = resolve_device(device)
    return to_device({"wx": nn.normal_init(gen, (1, hidden), 0.1),
                      "wh": nn.normal_init(gen, (hidden, hidden), 0.1),
                      "b": torch.zeros(hidden),
                      "out": nn.linear_init(gen, hidden, 2)}, device)


def echo_rnn_apply(params, x: Tensor) -> Tensor:
    """x (B, T) -> logits (B, T, 2) through a tanh RNN."""
    h = torch.zeros(x.shape[0], params["wh"].shape[0], device=x.device)
    logits = []
    for xt in x.transpose(0, 1):
        h = torch.tanh(xt[:, None] @ params["wx"] + h @ params["wh"]
                       + params["b"])
        logits.append(nn.linear(params["out"], h))
    return torch.stack(logits, dim=1)


def echo_loss(params, x, y) -> Tensor:
    return _ce(echo_rnn_apply(params, x).reshape(-1, 2), y.reshape(-1))


# ---------------------------------------------------------------------------
# 2. vector echo: echo a one-hot vector
# ---------------------------------------------------------------------------

def vector_echo_data(gen: torch.Generator, batch: int, length: int,
                     dim: int, delay: int) -> Tuple[Tensor, Tensor]:
    idx = torch.randint(0, dim, (batch, length), generator=gen,
                        device=gen.device)
    y = torch.roll(idx, delay, dims=1)
    y[:, :delay] = 0
    return F.one_hot(idx, dim).float(), y


def vector_echo_init(gen: torch.Generator, dim: int, hidden: int = 32,
                     device=None) -> Dict:
    device = resolve_device(device)
    return to_device({"lstm": lstm_init(gen, dim, hidden),
                      "out": nn.linear_init(gen, hidden, dim)}, device)


def vector_echo_apply(params, x: Tensor) -> Tensor:
    """x (B, T, dim) -> logits (B, T, dim) through an LSTM."""
    hidden = params["out"]["w"].shape[0]
    zeros = torch.zeros(x.shape[0], hidden, device=x.device)
    carry, logits = (zeros, zeros), []
    for xt in x.transpose(0, 1):
        carry, h = lstm_step(params["lstm"], carry, xt)
        logits.append(nn.linear(params["out"], h))
    return torch.stack(logits, dim=1)


def vector_echo_loss(params, x, y) -> Tensor:
    logits = vector_echo_apply(params, x)
    return _ce(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))


# ---------------------------------------------------------------------------
# 3. conv-LSTM sequence classification
# ---------------------------------------------------------------------------

def conv_cls_data(gen: torch.Generator, batch: int, length: int,
                  size: int = 16, channels: int = 3) -> Tuple[Tensor, Tensor]:
    """A vertical stripe at column 2t mod size in frame t, on the channel
    of the label, plus N(0, 0.3^2) noise, clipped to [-1, 2]."""
    dev = gen.device
    labels = torch.randint(0, channels, (batch,), generator=gen, device=dev)
    noise = 0.3 * torch.randn(batch, length, size, size, channels,
                              generator=gen, device=dev)
    t_idx = torch.arange(length, device=dev)
    stripe = torch.zeros(length, size, size, device=dev)
    stripe[t_idx, :, (t_idx * 2) % size] = 1.0
    onehot = F.one_hot(labels, channels).float()          # (B, channels)
    signal = stripe[None, :, :, :, None] * onehot[:, None, None, None, :]
    return torch.clamp(noise + signal, -1, 2), labels


def conv_cls_init(gen: torch.Generator, channels: int = 3, filters: int = 8,
                  hidden: int = 32, device=None) -> Dict:
    device = resolve_device(device)
    return to_device({
        "conv1": nn.conv2d_init(gen, channels, filters),
        "conv2": nn.conv2d_init(gen, filters, filters * 2),
        "lstm": lstm_init(gen, 4 * 4 * filters * 2, hidden),
        "out": nn.linear_init(gen, hidden, channels)}, device)


def conv_cls_apply(params, x: Tensor) -> Tensor:
    """x (B, T, s, s, c) -> class logits (B, c): every frame conv-encoded
    in one folded batch, an LSTM over time, the last state classified."""
    b, t = x.shape[:2]
    h = nn.lrelu(nn.conv2d(params["conv1"],
                           x.reshape((b * t,) + tuple(x.shape[2:]))))
    enc = nn.lrelu(nn.conv2d(params["conv2"], h)).reshape(b, t, -1)
    hidden = params["out"]["w"].shape[0]
    zeros = torch.zeros(b, hidden, device=x.device)
    carry = (zeros, zeros)
    for xt in enc.transpose(0, 1):
        carry, _ = lstm_step(params["lstm"], carry, xt)
    return nn.linear(params["out"], carry[1])


def conv_cls_loss(params, x, labels) -> Tensor:
    return _ce(conv_cls_apply(params, x), labels)


# ---------------------------------------------------------------------------
# shared trainer
# ---------------------------------------------------------------------------

def fit(params: Dict, loss_fn: Callable, data_fn: Callable,
        steps: int = 200, lr: float = 1e-2, seed: int = 0
        ) -> Tuple[Dict, float, float]:
    """Adam(lr) for `steps` steps, each on a fresh batch data_fn(generator)
    drawn on the params' device from the stream of `seed`. Returns
    (params, first loss, last loss)."""
    device = next(iter(flatten(params).values())).device
    rngs = PRNGSequence(seed, device)
    opt = Adam(lr)
    state = opt.init(params)
    first = last = None
    for _ in range(steps):
        batch = data_fn(rngs.next())
        keys, leaves, p = _differentiable(params)
        with torch.enable_grad():
            loss = loss_fn(p, *batch)
            grads = _grads(loss, keys, leaves)
        updates, state = opt.update(grads, state)
        params = apply_updates(params, updates)
        last = float(loss.detach())
        first = last if first is None else first
    return params, first, last
