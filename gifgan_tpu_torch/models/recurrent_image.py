"""Frame-conditioned recurrent (conv-LSTM) video GAN, the "recurrent_image"
family (gifgan_tpu/models/recurrent_image.py).

Generator: a per-frame encoder of four 5x5/2 convs (moments normalization
without scale or bias, relu) 64x64x3 -> 4x4x512, flattened into an
LSTM(100); per step a decoder FC 100 -> 8192 and four [moments-norm ->
relu -> 5x5/2 deconv] -> (tanh + 1) / 2 in [0, 1]. Teacher-forced: frames
0..T-1 in, predictions of frames 1..T out. Discriminator: the same conv
stack (lrelu) and an FC embedding per frame, concatenated over time, one
logit. Variants: a multi-layer LSTM with output dropout, the encoder that
reuses D's convs and fc embedding (share_disc_conv), and residual
prediction (the frame delta).

As in the JAX package the encoder and decoder run once over the folded
(B*T) batch and only the LSTM steps through time; `lax.scan` becomes a
Python loop over T. The LSTM is TF's BasicLSTMCell (gate order i, j, f, o,
forget bias 1.0), not nn.LSTMCell's order. The convs and deconvs have no
bias leaf (ops/nn.py's bias-free form). Dropout masks come from a torch
generator, or are passed in (`generator(..., dropout=masks)`), since torch
cannot draw threefry's. Parameters are dicts of float32 tensors in the
port's layouts (core/interop.py): convs (out, in, 5, 5), deconvs
(in, out, 5, 5), LSTM and linear weights (in, out).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.config import RecurrentImageConfig
from gifgan_tpu_torch.models.dcgan import to_device
from gifgan_tpu_torch.ops import nn

Tensor = torch.Tensor
Dropout = Union[None, torch.Generator, Tensor]


def moments_norm(x: Tensor, t: int = 1, eps: float = 1e-5) -> Tensor:
    """Batch moments over (batch, h, w) per channel, no scale or offset;
    per (time step, channel) when x is a folded (B*T, h, w, c) batch and
    t > 1. Moments in float32 (biased variance), result in x's dtype."""
    xf = x.float()
    if t == 1:
        var, mean = torch.var_mean(xf, dim=(0, 1, 2), keepdim=True,
                                   correction=0)
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    x5 = xf.reshape(x.shape[0] // t, t, *x.shape[1:])
    var, mean = torch.var_mean(x5, dim=(0, 2, 3), keepdim=True, correction=0)
    return ((x5 - mean) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)


def _layer_channels(cfg: RecurrentImageConfig):
    f = cfg.base_filters
    return [cfg.c_dim, f, f * 2, f * 4, f * 8]


def fc_size(cfg: RecurrentImageConfig) -> int:
    s16 = cfg.image_size // 16
    return s16 * s16 * cfg.base_filters * 8


# ---------------------------------------------------------------------------
# LSTM (TF BasicLSTMCell: gate order i, j, f, o; forget bias 1.0)
# ---------------------------------------------------------------------------

def lstm_init(gen: torch.Generator, input_dim: int, units: int,
              stddev: float = 0.02) -> Dict:
    return {"w": nn.normal_init(gen, (input_dim + units, 4 * units), stddev),
            "b": torch.zeros(4 * units)}


def lstm_step(params, carry: Tuple[Tensor, Tensor], x: Tensor,
              ) -> Tuple[Tuple[Tensor, Tensor], Tensor]:
    """((c, h), x) -> ((c', h'), h'); float32 (a bf16 x is promoted, as
    jnp.concatenate does)."""
    c, h = carry
    gates = torch.cat([x.float(), h], dim=-1) @ params["w"] + params["b"]
    i, j, f, o = gates.chunk(4, dim=-1)
    new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return (new_c, new_h), new_h


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_generator(gen: torch.Generator, cfg: RecurrentImageConfig) -> Dict:
    """G's params on the CPU, drawn from the CPU generator `gen`. The
    shared-conv variant has no encoder of its own and feeds the LSTM D's
    lstm_units-wide fc embedding."""
    chans = _layer_channels(cfg)
    params: Dict = {}
    if not cfg.share_disc_conv:
        for i in range(4):
            params[f"enc{i}"] = {"w": nn.normal_init(
                gen, (chans[i + 1], chans[i], 5, 5))}
    fc = fc_size(cfg)
    for layer in range(cfg.num_lstm_layers):
        in0 = cfg.lstm_units if cfg.share_disc_conv else fc
        params[f"lstm{layer}"] = lstm_init(
            gen, in0 if layer == 0 else cfg.lstm_units, cfg.lstm_units)
    params["out_fc"] = {"w": nn.normal_init(gen, (cfg.lstm_units, fc)),
                        "b": torch.zeros(1, fc)}
    for i in range(4):
        # deconv (in, out, 5, 5), top-down: 8f -> 4f -> 2f -> f -> c
        params[f"dec{i}"] = {"w": nn.normal_init(
            gen, (chans[4 - i], chans[3 - i], 5, 5))}
    return params


def init_discriminator(gen: torch.Generator, cfg: RecurrentImageConfig
                       ) -> Dict:
    chans = _layer_channels(cfg)
    params: Dict = {f"conv{i}": {"w": nn.normal_init(
        gen, (chans[i + 1], chans[i], 5, 5))} for i in range(4)}
    params["fc"] = {"w": nn.normal_init(gen, (fc_size(cfg), cfg.lstm_units)),
                    "b": torch.zeros(1, cfg.lstm_units)}
    params["final_fc"] = {
        "w": nn.normal_init(gen, (cfg.lstm_units * cfg.seq_length, 1)),
        "b": torch.zeros(1, 1)}
    return params


def init(gen: torch.Generator, cfg: RecurrentImageConfig, device=None,
         ) -> Tuple[Dict, Dict]:
    """(G params, D params) on `device`, drawn on the CPU from `gen`."""
    device = resolve_device(device)
    return (to_device(init_generator(gen, cfg), device),
            to_device(init_discriminator(gen, cfg), device))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _clip01(x: Tensor) -> Tensor:
    """clip to [0, 1] as jnp.clip (maximum, then minimum): a value on a
    bound passes half its gradient, where torch.clamp passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _conv_stack(filters, x: Tensor, act, dtype, t: int = 1) -> Tensor:
    for w in filters:
        x = act(moments_norm(nn.conv2d({"w": w}, x.to(dtype), dtype=dtype),
                             t))
    return x


def _encode(params, d_params, frames_bt: Tensor, cfg, dtype,
            t: int = 1) -> Tensor:
    """(B*T, s, s, c) -> (B*T, fc), or (B*T, lstm_units) through D's convs
    and fc embedding with share_disc_conv."""
    src = d_params if cfg.share_disc_conv else params
    prefix = "conv" if cfg.share_disc_conv else "enc"
    h = _conv_stack([src[f"{prefix}{i}"]["w"] for i in range(4)], frames_bt,
                    torch.relu, dtype, t)
    h = h.reshape(h.shape[0], -1)
    if not cfg.share_disc_conv:
        return h
    return h.to(dtype) @ d_params["fc"]["w"].to(dtype) + d_params["fc"]["b"]


def _decode(params, states_bt: Tensor, cfg, dtype, t: int = 1) -> Tensor:
    """(B*T, units) -> (B*T, s, s, c) float32 in [0, 1]."""
    s16, f8 = cfg.image_size // 16, cfg.base_filters * 8
    h = states_bt.to(dtype) @ params["out_fc"]["w"].to(dtype)
    h = (h + params["out_fc"]["b"]).reshape(-1, s16, s16, f8)
    for i in range(4):
        h = nn.deconv2d(params[f"dec{i}"], torch.relu(moments_norm(h, t)),
                        dtype=dtype)
    return (torch.tanh(h.float()) + 1.0) / 2.0


def dropout_masks(gen: torch.Generator, cfg: RecurrentImageConfig, t: int,
                  b: int) -> Tensor:
    """(layers, T, B, units) float32 masks on gen's device: 1/keep where a
    uniform draw is below keep = 1 - lstm_dropout, else 0 (the JAX
    package's bernoulli(keep) / keep, from torch's stream)."""
    keep = 1.0 - cfg.lstm_dropout
    u = torch.rand((cfg.num_lstm_layers, t, b, cfg.lstm_units),
                   generator=gen, device=gen.device)
    return (u < keep).float() / keep


def _zero_carry(cfg, b: int, device):
    zeros = torch.zeros(b, cfg.lstm_units, device=device)
    return [(zeros, zeros) for _ in range(cfg.num_lstm_layers)]


def _run_lstm(params, inputs_tbf: Tensor, cfg,
              masks: Optional[Tensor]) -> Tensor:
    """(T, B, in) -> (T, B, units) through the layer stack; `masks`
    (layers, T, B, units) scale each layer's output, None for none."""
    carry = _zero_carry(cfg, inputs_tbf.shape[1], inputs_tbf.device)
    states = []
    for step, x in enumerate(inputs_tbf):
        for layer in range(cfg.num_lstm_layers):
            carry[layer], x = lstm_step(params[f"lstm{layer}"], carry[layer],
                                        x)
            if masks is not None:
                x = x * masks[layer, step]
        states.append(x)
    return torch.stack(states)


def generator(params, frames: Tensor, cfg: RecurrentImageConfig,
              d_params: Optional[Dict] = None,
              dropout: Dropout = None) -> Tensor:
    """Teacher-forced next-frame prediction: frames (B, T, s, s, c) in
    [0, 1] -> predictions (B, T, s, s, c) float32 in [0, 1].

    dropout: None (none), a torch.Generator to draw the masks from (when
    cfg.lstm_dropout > 0), or the (layers, T, B, units) masks themselves."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    b, t = frames.shape[:2]
    folded = frames.reshape((b * t,) + tuple(frames.shape[2:]))
    enc = _encode(params, d_params, folded, cfg, dtype, t)
    if isinstance(dropout, torch.Generator):
        dropout = (dropout_masks(dropout, cfg, t, b) if cfg.lstm_dropout > 0
                   else None)
    states = _run_lstm(params, enc.reshape(b, t, -1).transpose(0, 1), cfg,
                       dropout)
    out = _decode(params, states.transpose(0, 1).reshape(b * t, -1), cfg,
                  dtype, t)
    out = out.reshape(b, t, cfg.image_size, cfg.image_size, cfg.c_dim)
    if cfg.residual_prediction:
        # the frame delta: pred = x + d, d = 2 * decoded - 1 in [-1, 1]
        out = _clip01(frames + (2.0 * out - 1.0))
    return out


def rollout(params, first_frame: Tensor, length: int,
            cfg: RecurrentImageConfig, d_params: Optional[Dict] = None,
            ) -> Tensor:
    """Autoregressive generation from one frame (B, s, s, c) in [0, 1],
    each prediction fed back in. Returns (B, length, s, s, c)."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    carry = _zero_carry(cfg, first_frame.shape[0], first_frame.device)
    frame, frames = first_frame, []
    for _ in range(length):
        x = _encode(params, d_params, frame, cfg, dtype)
        for layer in range(cfg.num_lstm_layers):
            carry[layer], x = lstm_step(params[f"lstm{layer}"], carry[layer],
                                        x)
        nxt = _decode(params, x, cfg, dtype)
        if cfg.residual_prediction:
            nxt = _clip01(frame + (2.0 * nxt - 1.0))
        frames.append(nxt)
        frame = nxt
    return torch.stack(frames, dim=1)


def discriminator(params, frames: Tensor, cfg: RecurrentImageConfig
                  ) -> Tensor:
    """(B, T, s, s, c) in [0, 1] -> logits (B, 1) float32: per-frame conv
    stack and fc embedding, concatenated over time, final fc."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    b, t = frames.shape[:2]
    folded = frames.reshape((b * t,) + tuple(frames.shape[2:]))
    h = _conv_stack([params[f"conv{i}"]["w"] for i in range(4)], folded,
                    nn.lrelu, dtype, t)
    emb = h.reshape(b * t, -1).to(dtype) @ params["fc"]["w"].to(dtype)
    emb = emb + params["fc"]["b"]       # float32: the bias promotes it
    # a bf16 weight meets float32 activations here: jnp.dot promotes
    w = params["final_fc"]["w"].to(dtype).to(emb.dtype)
    logits = emb.reshape(b, t * cfg.lstm_units) @ w
    return (logits + params["final_fc"]["b"]).float()
