"""Functional NN layers with gifgan_tpu's numerics (gifgan_tpu/ops/nn.py).

Parameters are dicts of float32 tensors in PyTorch's weight layouts
(core/interop.py converts from the JAX ones). Activations are NHWC / NDHWC
at every function boundary, as in the JAX package; inside a layer the
permute to NCHW is a free view whose strides PyTorch reads as
`channels_last`, so the convolutions see channels-last memory. Each layer
casts its parameters to the compute `dtype` (default: the input's), like
the reference; BatchNorm math runs in float32 and is cast back.

The convolutions themselves are PyTorch's (cuDNN on the card): the JAX
package leaves them to XLA, not to a Pallas kernel.

In a mesh step (parallel/dp.py) each rank holds its rows of the batch, and
the reductions over the batch axis (batch_norm's moments, get_std,
sigmoid_ce's mean) and add_noise's draw go through
parallel/collectives.py, which the step's context points at its data
group; outside a mesh step they are the one-process arithmetic.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from gifgan_tpu_torch.parallel import collectives

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("float32", "bfloat16", ...) -> torch dtype."""
    return _DTYPES[name]


def truncated_normal_init(gen: torch.Generator, shape, stddev=0.02) -> Tensor:
    """TF truncated_normal_initializer: normal truncated at +-2 sigma.
    trunc_normal_'s bounds are absolute, hence +-2*stddev."""
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev,
                                       2.0 * stddev, generator=gen)


def normal_init(gen: torch.Generator, shape, stddev=0.02) -> Tensor:
    return stddev * torch.randn(shape, generator=gen, dtype=torch.float32)


def _same_pads(sizes: Sequence[int], k: int, stride: int) -> list:
    """TF SAME pads in F.pad order (last spatial dim first): total
    max((ceil(n/s)-1)*s + k - n, 0), the low side taking the floor —
    (1, 2) for 5x5/2 on an even input."""
    pads = []
    for n in reversed(sizes):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


@functools.lru_cache(maxsize=None)
def _taps(rows: tuple, device: torch.device) -> Tensor:
    """A constant tap-index table on `device`, made once per device: making
    it per call would copy from the host with a stream synchronize (PyTorch's
    blocking host-to-device copy) inside every training step."""
    return torch.tensor(rows, device=device)


def _bias(params, dtype) -> Optional[Tensor]:
    """The layer's bias in `dtype`, or None for a bias-free layer (a dict
    without "b": the recurrent GAN's convs and deconvs have none)."""
    b = params.get("b")
    return None if b is None else b.to(dtype)


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, *range(2, x.ndim), 1)


# ---------------------------------------------------------------------------
# conv2d — 5x5 stride-2 SAME; weight (out, in, k, k)
# ---------------------------------------------------------------------------

def conv2d_init(gen, in_ch: int, out_ch: int, k: int = 5, stddev=0.02):
    return {"w": truncated_normal_init(gen, (out_ch, in_ch, k, k), stddev),
            "b": torch.zeros(out_ch)}


def conv2d(params, x: Tensor, stride: int = 2, dtype=None,
           impl: Optional[str] = None) -> Tensor:
    """NHWC TF-SAME conv; a `params` without "b" has no bias. impl="s2d"
    takes the space-to-depth form for 5x5/2 on even inputs (same function,
    other accumulation order)."""
    dtype = dtype or x.dtype
    w = params["w"].to(dtype)
    k = w.shape[-1]
    if (impl == "s2d" and stride == 2 and k == 5
            and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
        return _conv2d_s2d(params, x, dtype)
    xc = F.pad(_nchw(x.to(dtype)), _same_pads(x.shape[1:3], k, stride))
    return _nhwc(F.conv2d(xc, w, _bias(params, dtype), stride=stride))


def _conv2d_s2d(params, x: Tensor, dtype) -> Tensor:
    """Stride-2 5x5 SAME conv as a VALID 3x3 conv over the 2x2
    space-to-depth input (gifgan_tpu/ops/nn.py _conv2d_s2d): with pads
    (1, 2), y[j] = x_odd[j-1] w0 + x_even[j] w1 + x_odd[j] w2
    + x_even[j+1] w3 + x_odd[j+1] w4, so tap E[d+1, p] with
    E = [[-, 0], [1, 2], [3, 4]] serves displacement d and phase p."""
    w = params["w"].to(dtype)                      # (co, ci, 5, 5)
    cout, cin = w.shape[0], w.shape[1]
    b, h, wd = x.shape[0], x.shape[1], x.shape[2]
    m, n = h // 2, wd // 2
    xs = x.to(dtype).reshape(b, m, 2, n, 2, cin).permute(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(b, m, n, 4 * cin)              # channels (ph, pw, ci)
    wp = F.pad(w, (0, 1, 0, 1))                    # tap 5 = zeros
    e = _taps(((5, 0), (1, 2), (3, 4)), w.device)
    kern = wp[:, :, e[:, :, None, None], e[None, None, :, :]]
    # (co, ci, dh, ph, dw, pw) -> (co, (ph, pw, ci), dh, dw)
    kern = kern.permute(0, 3, 5, 1, 2, 4).reshape(cout, 4 * cin, 3, 3)
    y = F.conv2d(F.pad(_nchw(xs), (1, 1, 1, 1)), kern, params["b"].to(dtype))
    return _nhwc(y)


# ---------------------------------------------------------------------------
# conv3d — 3x3x3 stride-2 SAME; weight (out, in, k, k, k)
# ---------------------------------------------------------------------------

def conv3d_init(gen, in_ch: int, out_ch: int, k: int = 3, stddev=0.02):
    return {"w": truncated_normal_init(gen, (out_ch, in_ch, k, k, k), stddev),
            "b": torch.zeros(out_ch)}


def conv3d(params, x: Tensor, stride: int = 2, dtype=None) -> Tensor:
    """NDHWC TF-SAME conv3d; the pads follow each input size."""
    dtype = dtype or x.dtype
    w = params["w"].to(dtype)
    xc = F.pad(_nchw(x.to(dtype)), _same_pads(x.shape[1:4], w.shape[-1],
                                              stride))
    return _nhwc(F.conv3d(xc, w, params["b"].to(dtype), stride=stride))


# ---------------------------------------------------------------------------
# deconv2d — TF conv2d_transpose SAME; weight (in, out, k, k)
# ---------------------------------------------------------------------------

def deconv2d_init(gen, in_ch: int, out_ch: int, k: int = 5, stddev=0.02):
    return {"w": normal_init(gen, (in_ch, out_ch, k, k), stddev),
            "b": torch.zeros(out_ch)}


def deconv2d(params, x: Tensor, stride: int = 2, dtype=None,
             impl: Optional[str] = None) -> Tensor:
    """Exact tf.nn.conv2d_transpose(..., padding='SAME'): (m, m) -> (sm, sm);
    a `params` without "b" has no bias.

    The gradient-of-conv form pads the dilated input by (k-1-pl, k-1-pr),
    with (pl, pr) the forward SAME pads: (3, 2) for 5x5/2.
    F.conv_transpose2d(padding=p) pads (k-1-p, k-1-p) and output_padding
    only adds, so it takes p = pl and the surplus trailing rows and columns
    are cropped (output_padding=1 with padding=2 would give (2, 3)).
    impl="subpixel" takes the dense-conv + depth-to-space form for 5x5/2.
    """
    dtype = dtype or x.dtype
    w = params["w"].to(dtype)
    k = w.shape[-1]
    if impl == "subpixel" and stride == 2 and k == 5:
        return _deconv2d_subpixel(params, x, dtype)
    total = max(k - stride, 0)
    pl = total // 2
    crop = (total - pl) - pl
    y = F.conv_transpose2d(_nchw(x.to(dtype)), w, _bias(params, dtype),
                           stride=stride, padding=pl)
    if crop:
        y = y[:, :, :-crop, :-crop]
    return _nhwc(y)


def _deconv2d_subpixel(params, x: Tensor, dtype) -> Tensor:
    """Stride-2 5x5 SAME deconv as a VALID 3x3 conv over x padded by 1 with
    4*out channels, then depth-to-space (gifgan_tpu/ops/nn.py
    _deconv2d_subpixel): y[2i] = x[i-1] w3 + x[i] w1 and
    y[2i+1] = x[i-1] w4 + x[i] w2 + x[i+1] w0 per axis."""
    w = params["w"].to(dtype)                      # (in, out, 5, 5)
    in_ch, out_ch = w.shape[0], w.shape[1]
    wp = F.pad(w, (0, 1, 0, 1))                    # tap 5 = zeros
    idx = _taps(((3, 1, 5), (4, 2, 0)), w.device)
    kern = wp[:, :, idx[:, :, None, None], idx[None, None, :, :]]
    # (i, o, a, r, b, s) -> ((a, b, o), i, r, s)
    kern = kern.permute(2, 4, 1, 0, 3, 5).reshape(4 * out_ch, in_ch, 3, 3)
    y = F.conv2d(F.pad(_nchw(x.to(dtype)), (1, 1, 1, 1)), kern,
                 params["b"].to(dtype).repeat(4))
    bsz, m, n = x.shape[0], x.shape[1], x.shape[2]
    y = _nhwc(y).reshape(bsz, m, n, 2, 2, out_ch).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(bsz, 2 * m, 2 * n, out_ch)


# ---------------------------------------------------------------------------
# linear — weight (in, out), as in the JAX package
# ---------------------------------------------------------------------------

def linear_init(gen, in_dim: int, out_dim: int, stddev=0.02,
                bias_start: float = 0.0):
    return {"w": normal_init(gen, (in_dim, out_dim), stddev),
            "b": torch.full((out_dim,), bias_start)}


def linear(params, x: Tensor, dtype=None) -> Tensor:
    dtype = dtype or x.dtype
    return torch.addmm(params["b"].to(dtype), x.to(dtype),
                       params["w"].to(dtype))


# ---------------------------------------------------------------------------
# batch norm — decay 0.9, eps 1e-5, biased batch variance
# ---------------------------------------------------------------------------

def batch_norm_init(num_features: int):
    """(params, state): learnable scale/bias and the running moments."""
    params = {"scale": torch.ones(num_features),
              "bias": torch.zeros(num_features)}
    state = {"mean": torch.zeros(num_features),
             "var": torch.ones(num_features)}
    return params, state


def batch_norm(params, state, x: Tensor, train: bool,
               momentum: float = 0.9, eps: float = 1e-5):
    """Returns (y, new_state) over the last (channel) axis.

    train=True normalizes by the batch mean and BIASED variance and folds
    both into the running moments with decay `momentum` (tf.contrib
    batch_norm; torch's BatchNorm keeps an unbiased running variance and
    momentum = 1 - decay, hence this functional form). train=False uses the
    running moments and returns `state` unchanged. The new state is
    detached: it is an output of the step, never differentiated.
    """
    axes = tuple(range(x.ndim - 1))
    xf = x.float()
    if train:
        mean, var = collectives.moments(xf, axes)
        new_state = {
            "mean": momentum * state["mean"] + (1.0 - momentum) * mean.detach(),
            "var": momentum * state["var"] + (1.0 - momentum) * var.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + eps) * params["scale"]
    y = (xf - mean) * inv + params["bias"]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# activations / noise / diagnostics
# ---------------------------------------------------------------------------

def lrelu(x: Tensor, leak: float = 0.2) -> Tensor:
    return torch.maximum(x, leak * x)


def add_noise(gen: Optional[torch.Generator], x: Tensor, stddev) -> Tensor:
    """Gaussian instance noise. `gen=None` adds none. A Python-number
    stddev of 0 skips the draw; a tensor stddev always draws (one code path
    for every runtime noise level, as in the JAX package's Knobs)."""
    if gen is None:
        return x
    if isinstance(stddev, (float, int)):
        if stddev == 0.0:
            return x
        return x + stddev * collectives.randn_like_rows(gen, x)
    return x + stddev.to(x.dtype) * collectives.randn_like_rows(gen, x)


def get_std(x: Tensor) -> Tensor:
    """Mean per-feature std over the batch axis — the collapse diagnostic."""
    xf = x.float()
    var = (torch.var(xf, dim=0, correction=0) if collectives.active() is None
           else collectives.moments(xf, (0,))[1])
    return torch.sqrt(torch.mean(var))


def sigmoid_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """tf.nn.sigmoid_cross_entropy_with_logits, mean-reduced (the JAX
    package's expression, so its gradient routing at 0 matches too)."""
    zeros = torch.zeros_like(logits)
    cond = logits >= zeros
    relu_logits = torch.where(cond, logits, zeros)
    neg_abs = torch.where(cond, -logits, logits)
    return collectives.mean(relu_logits - logits * labels
                            + torch.log1p(torch.exp(neg_abs)))

