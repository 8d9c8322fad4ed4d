"""Plain PyTorch layers and Adam shared by the benchmark's references.

Float32 with TF32 off (`tf32(False)`), activations NHWC / NDHWC, weights
in PyTorch's layouts: conv (out, in, k, k[, k]), transposed conv
(in, out, k, k), linear (in, out). Nothing here imports the program.

`Precision` gives the control run a lower precision: every operand and
result of a convolution or a matrix product is rounded to that format on
the way in and out, and so is its gradient on the way back; the products
themselves accumulate in float32, as tensor cores do.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for cuBLAS and cuDNN inside the block; restored
    after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _fp8(x: Tensor, dtype) -> Tensor:
    """x rounded to fp8 under a per-tensor scale that maps |x|max to the
    format's largest value (the usual scaled fp8 cast)."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX[dtype] / amax
    return ((x * scale).to(dtype).to(x.dtype)) / scale


def round_to(x: Tensor, fmt: str, grad: bool = False) -> Tensor:
    """x rounded to `fmt` and returned in x's dtype. fmt: "float32" (as
    is), "float8" (e4m3; e5m2 for gradients, grad=True)."""
    if fmt == "float32":
        return x
    if fmt == "float8":
        return _fp8(x, torch.float8_e5m2 if grad else torch.float8_e4m3fn)
    raise ValueError(f"unknown format {fmt!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return round_to(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.fmt, grad=True), None


class Precision:
    """The format every conv and matmul operand is rounded to."""

    def __init__(self, fmt: str = "float32"):
        round_to(torch.zeros(1), fmt)           # refuses an unknown name
        self.fmt = fmt

    def q(self, x: Tensor) -> Tensor:
        return x if self.fmt == "float32" else _Round.apply(x, self.fmt)


FLOAT32 = Precision()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def same_pads(n: int, k: int, s: int):
    """TF SAME padding of one axis: (low, high), the low side the floor."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_list(sizes, k, s):
    out = []
    for n in reversed(sizes):                 # F.pad: last axis first
        out += list(same_pads(n, k, s))
    return out


def _bias(y: Tensor, b: Optional[Tensor]) -> Tensor:
    return y if b is None else y + b


def conv(x: Tensor, w: Tensor, b: Optional[Tensor], p: Precision = FLOAT32,
         stride: int = 2) -> Tensor:
    """TF-SAME convolution, 2-D (NHWC) or 3-D (NDHWC) by w's rank."""
    nd = w.ndim - 2
    xc = x.movedim(-1, 1)
    xc = F.pad(p.q(xc), _pad_list(x.shape[1:1 + nd], w.shape[-1], stride))
    fn = F.conv2d if nd == 2 else F.conv3d
    y = fn(xc, p.q(w), None, stride=stride).movedim(1, -1)
    return p.q(_bias(y, b))


def deconv(x: Tensor, w: Tensor, b: Optional[Tensor], p: Precision = FLOAT32,
           stride: int = 2) -> Tensor:
    """TF conv2d_transpose SAME (m -> stride*m), NHWC, w (in, out, k, k):
    the whole transposed convolution, cropped where the forward SAME
    convolution of the output size pads (low side first)."""
    k = w.shape[-1]
    m_h, m_w = x.shape[1], x.shape[2]
    y = F.conv_transpose2d(p.q(x.movedim(-1, 1)), p.q(w), None,
                           stride=stride)
    lo_h = same_pads(stride * m_h, k, stride)[0]
    lo_w = same_pads(stride * m_w, k, stride)[0]
    y = y[:, :, lo_h:lo_h + stride * m_h, lo_w:lo_w + stride * m_w]
    return p.q(_bias(y.movedim(1, -1), b))


def linear(x: Tensor, w: Tensor, b: Optional[Tensor],
           p: Precision = FLOAT32) -> Tensor:
    return p.q(_bias(p.q(x) @ p.q(w), b))


def batch_norm(x: Tensor, scale: Tensor, bias: Tensor, mean=None, var=None,
               eps: float = 1e-5) -> Tensor:
    """Over every axis but the last: batch moments (biased variance) when
    mean and var are None, else the given running moments."""
    if mean is None:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(dim=axes)
        var = ((x - mean) ** 2).mean(dim=axes)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def lrelu(x: Tensor, leak: float = 0.2) -> Tensor:
    return torch.where(x > 0, x, leak * x)


def sigmoid_ce(logits: Tensor, label: float) -> Tensor:
    """Mean sigmoid cross-entropy against a constant label, in the
    numerically stable form max(l, 0) - l*y + log(1 + exp(-|l|))."""
    return torch.mean(torch.clamp(logits, min=0) - logits * label
                      + torch.log1p(torch.exp(-logits.abs())))


# ---------------------------------------------------------------------------
# Adam (Kingma and Ba; eps outside the square root, as TF's AdamOptimizer)
# ---------------------------------------------------------------------------

class Adam:
    def __init__(self, params: Dict[str, Tensor], lr: float, b1: float,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, Tensor], grads: Dict[str, Tensor]
             ) -> Dict[str, Tensor]:
        """New params; the first and second moments are kept."""
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            m_hat = self.m[k] / (1.0 - self.b1 ** self.t)
            v_hat = self.v[k] / (1.0 - self.b2 ** self.t)
            out[k] = p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return out


def grads_of(loss: Tensor, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys],
                             allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(keys, gs)}


def leaf_norms(tree: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def keep_first(grad: Dict[str, float], prefix: str,
               grads: Dict[str, Tensor]) -> None:
    """Add the norms of `grads` to `grad` under `prefix`, unless it
    already holds a gradient under it: the first one is kept."""
    if not any(k.startswith(prefix) for k in grad):
        grad.update({f"{prefix}{k}": v for k, v in leaf_norms(grads).items()})
