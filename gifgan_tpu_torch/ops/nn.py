"""Functional NN layers with gifgan_tpu's numerics (gifgan_tpu/ops/nn.py).

Parameters are dicts of float32 tensors in PyTorch's weight layouts
(core/interop.py converts from the JAX ones). Activations are NHWC / NDHWC
at every function boundary, as in the JAX package; inside a layer the
permute to NCHW is a free view whose strides PyTorch reads as
`channels_last`, so the convolutions see channels-last memory. Each layer
casts its parameters to the compute `dtype` (default: the input's), like
the reference; BatchNorm math runs in float32 and is cast back. An
inference-mode BatchNorm after a layer with whole weights folds instead
into that layer's weight and a float32 shift of its output (bn_after).

The convolutions themselves are PyTorch's (cuDNN on the card): the JAX
package leaves them to XLA, not to a Pallas kernel.

In a mesh step (parallel/dp.py, parallel/sp.py) each rank holds its rows
of the batch, and the reductions over the batch axis (batch_norm's
moments, get_std, sigmoid_ce's mean) and add_noise's draw go through
parallel/collectives.py, which the step's context points at its groups;
outside a mesh step they are the one-process arithmetic.

Tensor parallelism (the JAX package's parallel/tp.py layout, which XLA's
partitioner completes there): on a step's model axis a weight that
parallel/tp.py split holds this rank's block, and each layer takes its
Megatron form from the shapes it is given, with the bias (always whole)
as the reference:

- conv2d (and its s2d form), conv3d and linear are column-parallel when
  their weight holds a block of the out-channels: a whole input enters
  through `to_model`, a channel-sharded one is gathered (its cotangent
  reduce-scattered), and the output is this rank's channels;
- deconv2d (and its subpixel form) is row-parallel when its weight holds
  a block of the in-channels: this rank's input channels, the partial
  sums all-reduced, then the bias;
- batch_norm on a channel-sharded input normalizes this rank's channels
  with its slice of the whole gamma, beta and running moments, and
  returns the whole running moments, equal on every model rank;
- `gather_channels` makes a sharded activation whole where a reshape or a
  replicated layer needs every channel.

No layer gathers a weight. A weight left whole (its dim not divisible by
the axis) runs the plain layer on whole inputs.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from gifgan_tpu_torch.core import profile
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


def _shift(params, y: Tensor, shape) -> Tensor:
    """y plus the layer's "shift", a float32 bias (a batch norm's folded
    into the layer by bn_after, or a bias kept in float32), viewed as
    `shape`: added in place, so the sum is taken in float32 and held in
    y's dtype; y as it is without one."""
    s = params.get("shift")
    return y if s is None else y.add_(s.reshape(shape))


def _column(params, x: Tensor, in_dim: int, out_dim: int):
    """(params, x) of a layer with weight dims (in_dim, out_dim) under
    tensor parallelism: a column-parallel layer's bias block and input
    (module docstring), or a whole weight's whole input."""
    if collectives.model_group() is None or "b" not in params:
        return params, x
    w, b = params["w"], params["b"]
    sharded_in = x.shape[-1] != w.shape[in_dim]
    if w.shape[out_dim] == b.shape[0]:
        return params, collectives.gather_model(x) if sharded_in else x
    x = (collectives.gather_model(x, summed=True) if sharded_in
         else collectives.to_model(x))
    return dict(params, b=collectives.split_model(b)), x


def gather_channels(x: Tensor, channels: int) -> Tensor:
    """x with all `channels` on its last dim: a model-sharded activation
    gathered (every rank then computes alike from it), else x."""
    if x.shape[-1] == channels:
        return x
    return collectives.gather_model(x)


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
    other accumulation order). Padding that is the same on both sides of
    each axis (stride 1, odd k) goes to the convolution itself, so no
    padded copy of the input is made."""
    dtype = dtype or x.dtype
    params, x = _column(params, x, 1, 0)
    w = params["w"].to(dtype)
    k = w.shape[-1]
    if (impl == "s2d" and stride == 2 and k == 5
            and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
        return _conv2d_s2d(params, x, dtype)
    xc, pads = _nchw(x.to(dtype)), _same_pads(x.shape[1:3], k, stride)
    if pads[0::2] == pads[1::2]:
        y = F.conv2d(xc, w, _bias(params, dtype), stride=stride,
                     padding=(pads[2], pads[0]))
    else:
        y = F.conv2d(F.pad(xc, pads), w, _bias(params, dtype), stride=stride)
    return _nhwc(_shift(params, y, (-1, 1, 1)))


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
    params, x = _column(params, x, 1, 0)
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
    Under tensor parallelism `x` is whole, and a weight that holds a block
    of the in-channels makes the layer row-parallel.
    """
    dtype = dtype or x.dtype
    if (collectives.model_group() is not None
            and x.shape[-1] != params["w"].shape[0]):
        part = deconv2d({"w": params["w"]}, collectives.split_model(x),
                        stride, dtype, impl)
        y, b = collectives.reduce_model(part), _bias(params, dtype)
        return y if b is None else y + b
    w = params["w"].to(dtype)
    k = w.shape[-1]
    if impl == "subpixel" and stride == 2 and k == 5:
        return _deconv2d_subpixel(params, x, dtype)
    total = max(k - stride, 0)
    pl = total // 2
    crop = (total - pl) - pl
    y = _shift(params, F.conv_transpose2d(_nchw(x.to(dtype)), w,
                                          _bias(params, dtype),
                                          stride=stride, padding=pl),
               (-1, 1, 1))
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
    b = _bias(params, dtype)
    y = F.conv2d(F.pad(_nchw(x.to(dtype)), (1, 1, 1, 1)), kern,
                 None if b is None else b.repeat(4))
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
    params, x = _column(params, x, 0, 1)
    if "b" not in params:
        return _shift(params, x.to(dtype) @ params["w"].to(dtype), (-1,))
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
    detached: it is an output of the step, never differentiated. A
    model-sharded x (fewer channels than `params`) takes its slice of the
    vectors; the new state is whole.
    """
    axes = tuple(range(x.ndim - 1))
    xf = x.float()
    scale, bias = params["scale"], params["bias"]
    sharded = x.shape[-1] != scale.shape[0]
    if sharded:
        scale, bias = (collectives.split_model(scale),
                       collectives.split_model(bias))
    if train:
        mean, var = collectives.moments(xf, axes)
        batch = torch.stack([mean.detach(), var.detach()])
        if sharded:
            batch = collectives.model_whole(batch)
        new_state = {
            "mean": momentum * state["mean"] + (1.0 - momentum) * batch[0],
            "var": momentum * state["var"] + (1.0 - momentum) * batch[1],
        }
    else:
        mean, var = state["mean"], state["var"]
        if sharded:
            mean, var = (collectives.model_block(mean),
                         collectives.model_block(var))
        new_state = state
    inv = torch.rsqrt(var + eps) * scale
    y = (xf - mean) * inv + bias
    return y.to(x.dtype), new_state


def fold_bn(layer: Dict, bn_params: Dict, bn_state: Dict, out_axis: int,
            eps: float = 1e-5) -> Dict:
    """Fold inference-mode batch_norm (train=False) into the preceding
    affine layer: W' = W * g along `out_axis` of W, b' = (b - mean) * g
    + beta, g = scale * rsqrt(var + eps), in float32. Exact up to
    reassociation, and differentiable in the layer's and the BN's params.
    Recorded as an `nn.bn_fold` span inside an open span."""
    with profile.span("nn.bn_fold", inner=True):
        g = bn_params["scale"] * torch.rsqrt(bn_state["var"] + eps)
        w = layer["w"].float()
        shape = [1] * w.ndim
        shape[out_axis] = -1
        return {"w": w * g.reshape(shape),
                "b": (layer["b"].float() - bn_state["mean"]) * g
                     + bn_params["bias"]}


def tile_bn(d: Dict, reps: int) -> Dict:
    """BN vectors repeated over `reps` leading positions: a BN applied
    after reshaping a linear's (B, reps * C) output to (..., C) normalizes
    output index p * C + c with the vectors' entry c."""
    return {k: v.repeat(reps) for k, v in d.items()}


def bn_after(layer: Dict, bn_params: Dict, bn_state: Dict, train: bool,
             out_axis: int, reps: int = 1):
    """(params, norm) for a plain conv2d, deconv2d or linear whose output
    batch_norm(bn_params, bn_state, ., train) normalizes: run the layer
    with `params`, then `y, new_state = norm(out)`.

    In inference mode with whole weights (no model axis) the BN is a
    per-channel affine of constants, so it folds into the layer (fold_bn,
    its vectors tiled `reps` times for a BN after a reshape, tile_bn):
    `params` holds the folded weight and, as its "shift", the folded bias,
    which the layer adds in float32 as the BN did (in the compute dtype it
    would round a bias of order |mean * g| on every channel alike), and
    `norm` passes its input and the state through unchanged. Otherwise
    `params` is the layer's own and `norm` is batch_norm."""
    if train or collectives.model_group() is not None:
        return layer, functools.partial(batch_norm, bn_params, bn_state,
                                        train=train)
    p, s = ((tile_bn(bn_params, reps), tile_bn(bn_state, reps)) if reps > 1
            else (bn_params, bn_state))
    folded = fold_bn(layer, p, s, out_axis)
    return ({"w": folded["w"], "shift": folded["b"]},
            lambda y: (y, bn_state))


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

