"""Minimal PredNet (Lotter, Kreiman & Cox 2016), gifgan_tpu/models/prednet.py.

Per layer l, bottom to top:
    R_l      convLSTM representation (gate order i, f, o, g; +1 on f)
    A_hat_l  relu(conv(R_l)), clamped to the pixel range at layer 0
    E_l      [relu(A_l - A_hat_l), relu(A_hat_l - A_l)]   (split error)
    A_{l+1}  maxpool2x2(relu(conv(E_l)))                 (bottom-up target)
A time step updates R top-down (fed E_l(t-1) and the nearest-x2
upsampled R_{l+1}(t)), then A and E bottom-up. The loss is the mean
layer-0 error over t >= 1, i.e. next-frame L1.

Every conv is 3x3, stride 1, SAME, with a bias; weights (out, in, 3, 3)
(core/interop.py carries the JAX package's HWIO). `lax.scan` over time
becomes a Python loop.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.models.dcgan import to_device
from gifgan_tpu_torch.ops import nn

Tensor = torch.Tensor


class PredNetConfig(NamedTuple):
    image_size: int = 64
    c_dim: int = 3
    channels: Tuple[int, ...] = (16, 32)   # R/A channels per layer
    kernel: int = 3
    compute_dtype: str = "float32"


def _conv_init(gen, in_ch, out_ch, k):
    return {"w": nn.normal_init(gen, (out_ch, in_ch, k, k), 0.05),
            "b": torch.zeros(out_ch)}


def _conv(p, x: Tensor, dtype) -> Tensor:
    return nn.conv2d(p, x, stride=1, dtype=dtype)


def init(gen: torch.Generator, cfg: PredNetConfig, device=None) -> Dict:
    """Params on `device`, drawn on the CPU from `gen` (normal, std 0.05)."""
    device = resolve_device(device)
    ch, n = cfg.channels, len(cfg.channels)
    params: Dict = {}
    for l in range(n):
        a_ch = cfg.c_dim if l == 0 else ch[l - 1]       # A_l channels
        e_ch = 2 * a_ch                                  # split error
        r_top = ch[l + 1] if l + 1 < n else 0
        # convLSTM input: [E_l(t-1), upsampled R_{l+1}(t)] + hidden R_l
        params[f"lstm{l}"] = _conv_init(gen, e_ch + r_top + ch[l], 4 * ch[l],
                                        cfg.kernel)
        params[f"ahat{l}"] = _conv_init(gen, ch[l], a_ch, cfg.kernel)
        if l + 1 < n:
            params[f"up{l}"] = _conv_init(gen, e_ch, ch[l], cfg.kernel)
    return to_device(params, device)


def _zeros_state(cfg: PredNetConfig, batch: int, device) -> List[Dict]:
    state = []
    for l, ch in enumerate(cfg.channels):
        size = cfg.image_size // (2 ** l)
        a_ch = cfg.c_dim if l == 0 else cfg.channels[l - 1]
        z = lambda c: torch.zeros(batch, size, size, c, device=device)
        state.append({"c": z(ch), "r": z(ch), "e": z(2 * a_ch)})
    return state


def _step(params, cfg: PredNetConfig, state: List[Dict], frame: Tensor):
    """One time step; frame (B, s, s, c) in [0, 1]. Returns (new state,
    prediction A_hat_0, layer-0 error mean)."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    n = len(cfg.channels)
    new_state = [dict(s) for s in state]

    for l in range(n - 1, -1, -1):                       # top-down
        inputs = [state[l]["e"]]
        if l + 1 < n:
            r_up = new_state[l + 1]["r"]
            inputs.append(r_up.repeat_interleave(2, dim=1)
                          .repeat_interleave(2, dim=2))
        inputs.append(state[l]["r"])
        gates = _conv(params[f"lstm{l}"], torch.cat(inputs, dim=-1), dtype)
        i, f, o, g = gates.float().chunk(4, dim=-1)
        c_new = (torch.sigmoid(f + 1.0) * state[l]["c"]
                 + torch.sigmoid(i) * torch.tanh(g))
        new_state[l]["c"] = c_new
        new_state[l]["r"] = torch.sigmoid(o) * torch.tanh(c_new)

    a, pred0 = frame, None                               # bottom-up
    for l in range(n):
        a_hat = torch.relu(_conv(params[f"ahat{l}"], new_state[l]["r"],
                                 dtype)).float()
        if l == 0:
            a_hat = torch.minimum(a_hat, a_hat.new_ones(()))
            pred0 = a_hat
        e = torch.cat([torch.relu(a - a_hat), torch.relu(a_hat - a)], dim=-1)
        new_state[l]["e"] = e
        if l + 1 < n:
            a = torch.relu(_conv(params[f"up{l}"], e, dtype)).float()
            a = F.max_pool2d(a.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return new_state, pred0, torch.mean(new_state[0]["e"])


def forward(params, clips: Tensor, cfg: PredNetConfig):
    """clips (B, T, s, s, c) in [0, 1] -> (predictions (B, T, s, s, c),
    mean layer-0 error over t >= 1). predictions[:, t] is the guess for
    frame t made before seeing it."""
    state = _zeros_state(cfg, clips.shape[0], clips.device)
    preds, errs = [], []
    for t in range(clips.shape[1]):
        state, pred, err = _step(params, cfg, state, clips[:, t])
        preds.append(pred)
        errs.append(err)
    return torch.stack(preds, dim=1), torch.stack(errs)[1:].mean()


def loss_fn(params, clips: Tensor, cfg: PredNetConfig) -> Tensor:
    return forward(params, clips, cfg)[1]
