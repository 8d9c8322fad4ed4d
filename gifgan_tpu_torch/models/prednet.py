"""PredNet (Lotter, Kreiman & Cox 2016, arXiv:1605.08104): the JAX
package's minimal model (gifgan_tpu/models/prednet.py) and the published
network (github.com/coxlab/prednet prednet.py, kitti_train.py) in one
parameterisation.

Per level l, bottom to top, A_0 being the frame:
    R_l      convLSTM representation
    A_hat_l  relu(conv(R_l)), clipped at the pixel maximum 1 at level 0
    E_l      [relu(A_l - A_hat_l), relu(A_hat_l - A_l)]   (split error)
    A_{l+1}  maxpool2x2(relu(conv(E_l)))                 (bottom-up target)
A time step updates R top-down, level l from [E_l(t-1), the nearest-x2
upsampled R_{l+1}(t), R_l(t-1)], then A and E bottom-up. The loss is the
mean level-0 error over t >= 1 (the paper's "L_0": layer weights
[1, 0, ...], time weight 0 at t = 0 and equal after), i.e. next-frame L1.

Widths: `stack_sizes` are the A and A_hat channels of each level
(stack_sizes[0] = c_dim), `r_stack_sizes` the R channels, as in the Keras
model. Without them, `channels` = (c0, c1, ...) gives the JAX package's
widths: stacks (c_dim, c0, ...), R (c0, c1, ...). Frames are (h, w)
(`frame`), or image_size square; each level halves both.

The convLSTM's four gates come from one fused conv, chunks (i, f, o, g);
the candidate g and the output take tanh. `lstm_gate` "sigmoid" is the
JAX package's form (sigmoid, +1 on f, weights drawn normal with std 0.05),
"hard_sigmoid" the published one (clip(0.2x + 0.5, 0, 1), no bias, Keras's
glorot_uniform weights).

Every conv is 3x3, stride 1, SAME, with a bias; weights (out, in, 3, 3)
(core/interop.py carries the JAX package's HWIO), biases zero. The
convolutions run in `compute_dtype`; gates, cell state, errors and the
loss stay float32. `lax.scan` over time becomes a Python loop. Inner spans
(core/profile.py), recorded inside a step's span only: `prednet.lstm`
around one level's R update of one time step, `prednet.error` around its
A_hat, error and pooled next target.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core import profile
from gifgan_tpu_torch.models.dcgan import to_device
from gifgan_tpu_torch.ops import nn

Tensor = torch.Tensor


@dataclass(frozen=True)
class PredNetConfig:
    image_size: int = 64
    c_dim: int = 3
    channels: Tuple[int, ...] = (16, 32)   # R channels; A_{l+1} = R_l's
    kernel: int = 3
    compute_dtype: str = "float32"
    stack_sizes: Optional[Tuple[int, ...]] = None     # A / A_hat channels
    r_stack_sizes: Optional[Tuple[int, ...]] = None   # R channels
    frame: Optional[Tuple[int, int]] = None           # (h, w)
    lstm_gate: str = "sigmoid"

    def widths(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(A widths, R widths) of each level."""
        if self.stack_sizes is None and self.r_stack_sizes is None:
            ch = tuple(self.channels)
            return (self.c_dim,) + ch[:-1], ch
        a, r = tuple(self.stack_sizes or ()), tuple(self.r_stack_sizes or ())
        if not a or len(a) != len(r) or a[0] != self.c_dim:
            raise ValueError(f"stack_sizes {a} and r_stack_sizes {r} need "
                             f"one entry a level, stack_sizes[0] = c_dim "
                             f"({self.c_dim})")
        return a, r

    def hw(self) -> Tuple[int, int]:
        """Frame (h, w); every level halves it, so 2^(levels-1) divides
        both."""
        h, w = self.frame or (self.image_size, self.image_size)
        step = 2 ** (len(self.widths()[1]) - 1)
        if h % step or w % step:
            raise ValueError(f"frame {h}x{w} is not divisible by {step}")
        return h, w


def _sigmoid_gates(ifo: Tensor):
    i, f, o = ifo.chunk(3, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)


def _hard_sigmoid_gates(ifo: Tensor):
    # clip(0.2x + 0.5, 0, 1) is hardsigmoid(1.2x): one pass each way
    return F.hardsigmoid(1.2 * ifo).chunk(3, dim=-1)


# lstm_gate -> the input, forget and output gates of their pre-activations
# (i, f, o stacked on the channels)
GATES = {"sigmoid": _sigmoid_gates, "hard_sigmoid": _hard_sigmoid_gates}


def _conv_init(gen, in_ch, out_ch, k, glorot: bool, gates: int = 1):
    """A conv's params: normal 0.05, or glorot_uniform, whose fans are
    those of one of Keras's `gates` separate convs that the fused one
    stands for."""
    shape = (out_ch, in_ch, k, k)
    if glorot:
        limit = math.sqrt(6.0 / (k * k * (in_ch + out_ch // gates)))
        w = (2.0 * torch.rand(shape, generator=gen) - 1.0) * limit
    else:
        w = nn.normal_init(gen, shape, 0.05)
    return {"w": w, "b": torch.zeros(out_ch)}


def _conv(p, x: Tensor, dtype) -> Tensor:
    """The 3x3 SAME conv in `dtype`, its bias added in float32 as the
    layer's shift: no rounded copy of the bias is made per call, and its
    gradient sums in float32."""
    return nn.conv2d({"w": p["w"], "shift": p["b"]}, x, stride=1,
                     dtype=dtype)


def init(gen: torch.Generator, cfg: PredNetConfig, device=None) -> Dict:
    """Params on `device`, drawn on the CPU from `gen`."""
    device = resolve_device(device)
    a, r = cfg.widths()
    n, k, how = len(r), cfg.kernel, cfg.lstm_gate == "hard_sigmoid"
    if cfg.lstm_gate not in GATES:
        raise ValueError(f"unknown lstm_gate {cfg.lstm_gate!r}")
    params: Dict = {}
    for l in range(n):
        r_top = r[l + 1] if l + 1 < n else 0
        # convLSTM input: [E_l(t-1), upsampled R_{l+1}(t)] + hidden R_l
        params[f"lstm{l}"] = _conv_init(gen, 2 * a[l] + r_top + r[l],
                                        4 * r[l], k, how, gates=4)
        params[f"ahat{l}"] = _conv_init(gen, r[l], a[l], k, how)
        if l + 1 < n:
            params[f"up{l}"] = _conv_init(gen, 2 * a[l], a[l + 1], k, how)
    return to_device(params, device)


def _zeros_state(cfg: PredNetConfig, batch: int, device) -> List[Dict]:
    """Per level: the cell state "c" in float32, and R "r" and E "e" as
    the convolutions take them (compute dtype)."""
    (h, w), (a, r) = cfg.hw(), cfg.widths()
    dtype = nn.torch_dtype(cfg.compute_dtype)
    z = lambda l, c, dt: torch.zeros(batch, h >> l, w >> l, c, dtype=dt,
                                     device=device)
    return [{"c": z(l, r[l], torch.float32), "r": z(l, r[l], dtype),
             "e": z(l, 2 * a[l], dtype)} for l in range(len(r))]


def _from_above(state: List[Dict], new_state: List[Dict], l: int) -> Tensor:
    """What level l's update takes from the level above: R_{l+1}(t), the
    one this time step has just updated."""
    return new_state[l + 1]["r"]


def _upsample(x: Tensor) -> Tensor:
    """Nearest-neighbour x2 of (B, h, w, c)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def _step(params, cfg: PredNetConfig, state: List[Dict], frame: Tensor):
    """One time step; frame (B, h, w, c) in [0, 1]. Returns (new state,
    prediction A_hat_0, layer-0 error mean). R and E are computed in
    float32 and kept rounded to the compute dtype, once each: every
    convolution that reads them would round them alike."""
    dtype = nn.torch_dtype(cfg.compute_dtype)
    gates = GATES[cfg.lstm_gate]
    n = len(state)
    new_state = [dict(s) for s in state]

    for l in range(n - 1, -1, -1):                       # top-down
        with profile.span("prednet.lstm", inner=True):
            inputs = [state[l]["e"]]
            if l + 1 < n:
                inputs.append(_upsample(_from_above(state, new_state, l)))
            inputs.append(state[l]["r"])
            z = _conv(params[f"lstm{l}"], torch.cat(inputs, dim=-1),
                      dtype).float()
            r_l = z.shape[-1] // 4
            i, f, o = gates(z[..., :3 * r_l])
            c_new = f * state[l]["c"] + i * torch.tanh(z[..., 3 * r_l:])
            new_state[l]["c"] = c_new
            new_state[l]["r"] = (o * torch.tanh(c_new)).to(dtype)

    a, pred0, err0 = frame, None, None                   # bottom-up
    for l in range(n):
        with profile.span("prednet.error", inner=True):
            a_hat = torch.relu(_conv(params[f"ahat{l}"], new_state[l]["r"],
                                     dtype))
            if l == 0:
                a_hat = torch.clamp(a_hat, max=1.0).float()
            d = a - a_hat           # in float32: `a` is, whatever a_hat is
            e = torch.relu(torch.cat([d, -d], dim=-1))
            if l == 0:
                pred0, err0 = a_hat, torch.mean(e)
            new_state[l]["e"] = e.to(dtype)
            if l + 1 < n:
                # relu and the max pool commute with the rounding to dtype:
                # widen the pooled quarter only
                a = torch.relu(_conv(params[f"up{l}"], new_state[l]["e"],
                                     dtype))
                a = F.max_pool2d(a.permute(0, 3, 1, 2), 2).permute(
                    0, 2, 3, 1).float()
    return new_state, pred0, err0


def forward(params, clips: Tensor, cfg: PredNetConfig):
    """clips (B, T, h, w, c) in [0, 1] -> (predictions (B, T, h, w, c),
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
