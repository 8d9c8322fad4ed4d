"""Leaky ReLU as one pass each way: max(x, leak * x) and its gradient.

`lrelu(x, leak)` gives the numbers of `torch.maximum(x, leak * x)` and of
its gradient through autograd, bit for bit, in float32, bfloat16, float16
and float64 (csrc/lrelu.cu states the arithmetic). It replaces no Pallas
kernel: the JAX package leaves its lrelu to XLA, which fuses it. On the
card the expression runs as two kernels forward and about twelve backward;
this runs as one each way (bound, design and numerics are noted in the
source: memory-bound, 4 bytes an element forward and 6 backward in
bfloat16).

The autograd Function takes CUDA tensors only and launches the
hand-written kernels (counted in `lrelu.launches`, each pass one). The
plain versions below are what the CPU tests hold against autograd through
the expression, and what the card tests hold the kernels against.
`ops/nn.py lrelu` sends CUDA tensors here and keeps the expression itself
for every other tensor.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from gifgan_tpu_torch.kernels import _build

NAME = "lrelu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3}


def lrelu_plain(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    """The forward pass: t = leak * x in x's dtype; x where x is NaN or
    x > t, else t (torch.maximum's choice, its NaN included)."""
    t = leak * x
    return torch.where(torch.isnan(x) | (x > t), x, t)


def lrelu_backward_plain(x: torch.Tensor, g: torch.Tensor,
                         leak: float = 0.2) -> torch.Tensor:
    """The backward pass from the input x (not the output: a tiny negative
    x rounds leak * x to -0) and the output's gradient g: maximum's
    gradient to x (a) and to t = leak * x (b), each halved where x == t,
    then mul's backward and autograd's sum, each rounded to the dtype.
    So g where x > t, leak * g where x < t, 0.6 g at x = 0 (jnp.maximum's
    tie rule) and g + leak * g for a NaN x; a -0 sums to +0 as autograd's
    does."""
    t = leak * x
    h = g / 2
    zero = torch.zeros_like(g)
    a = torch.where(x == t, h, torch.where(x < t, zero, g))
    b = torch.where(x == t, h, torch.where(x > t, zero, g))
    return a + leak * b


_fns = None


def _kernels():
    """The C entry points (forward, backward), built and loaded on first
    use."""
    global _fns
    if _fns is None:
        lib = _build.load(NAME)
        fwd, bwd = lib.lrelu_forward, lib.lrelu_backward
        fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
                        ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = fwd, bwd
    return _fns


def dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill data_ptr() .. + numel exactly once, in
    some order of its dims (non-overlapping and dense): its strides,
    sorted, are the running products of the sizes (dims of size 1 aside)."""
    expect = 1
    for stride, size in sorted((s, n) for n, s in zip(t.shape, t.stride())
                               if n > 1):
        if stride != expect:
            return False
        expect *= size
    return True


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `b` walks its storage as dense `a` does, element for
    element: one dtype and shape, the same strides on dims of size > 1."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and all(sa == sb for n, sa, sb in zip(a.shape, a.stride(),
                                                  b.stride()) if n > 1))


def _launch(fn, leak: float, *tensors: torch.Tensor) -> None:
    """fn over the flat storage of `tensors` (inputs, then the output), on
    the current stream of their device."""
    out = tensors[-1]
    if not out.numel():
        return
    device = out.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(fn, leak, *tensors)
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # which costs the host more than the launch
    err = fn(*(t.data_ptr() for t in tensors), out.numel(),
             DTYPES[out.dtype], leak,
             torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    lrelu.launches += 1


def _forward(x: torch.Tensor, leak: float):
    """(x as the kernel reads it, y): x runs flat over its storage, so an
    x that is not dense is made contiguous first; y takes x's strides
    (empty_like keeps a dense layout)."""
    if not (x.is_contiguous() or dense(x)):
        x = x.contiguous()
    y = torch.empty_like(x)
    _launch(_kernels()[0], leak, x, y)
    return x, y


class _LReLU(torch.autograd.Function):
    """One pass each way on the card: `_forward`, and a backward from the
    saved x, whose gradient, if it does not walk its storage as x does, is
    first copied into x's layout. Nothing in the port takes a second
    derivative."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, leak: float) -> torch.Tensor:
        x, y = _forward(x, leak)
        ctx.leak = leak
        ctx.save_for_backward(x)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, = ctx.saved_tensors
        if not same_layout(x, g):
            g = torch.empty_like(x).copy_(g)
        dx = torch.empty_like(x)
        _launch(_kernels()[1], ctx.leak, x, g, dx)
        return dx, None


def lrelu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    """max(x, leak * x), differentiable once, for a float32, bfloat16,
    float16 or float64 CUDA tensor: one kernel launch each way (counted in
    `lrelu.launches`). Where autograd records nothing (no_grad, or an x
    that needs no gradient) the forward launches without the Function,
    whose dispatch would cost the host more than the launch. Any other
    tensor raises."""
    if x.dtype not in DTYPES:
        raise ValueError(f"no lrelu kernel for {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.requires_grad and torch.is_grad_enabled():
        return _LReLU.apply(x, float(leak))
    return _forward(x, float(leak))[1]


lrelu.launches = 0
