"""The data group of a mesh step and the collectives over it.

Under jit the JAX package's batch reductions (the BN moments, the loss
means, the collapse diagnostics) cover the whole logical batch, because
XLA's partitioner sees the whole batch (gifgan_tpu/ops/nn.py:281-283,
sync-BN). Here each rank holds its rows of the batch, so each such
reduction also sums over the ranks of the data axis. The code that reduces
over a batch axis (ops/nn.py, the losses, inversion) asks `active()` for
the group of the step it runs in: parallel/dp.py make_sharded_step enters
that context (`use`) around the step, and inversion around its loss.
Outside it `active()` is None and each function here is the one-process
arithmetic, unchanged.

Autograd: `all_sum` is differentiable, and its backward all-reduces the
cotangents. Every rank seeds its backward with the same replicated loss,
so the gradient a rank computes is `size` times its share of the
one-process gradient: `reduce_gradients` takes the mean over the ranks
(the gradient of the one-process step), and a leaf that one rank holds
alone, such as inversion's rows of z, takes `local_gradient`.

On a group whose backend is gloo, a CUDA tensor goes through the host for
its collective (gloo stages there anyway), so ranks that share one card
run the same code as ranks on their own cards.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Dict, Optional

import torch
import torch.distributed as dist

from gifgan_tpu_torch.core.tree import flatten, unflatten

Tensor = torch.Tensor


class DataGroup:
    """The ranks of one data axis: `group` (None: the default group),
    this rank's block `index` and the `size`. `bytes` counts what each
    kind of collective sent from this rank (its input's bytes)."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size
        self.bytes = collections.Counter()

    def _run(self, kind: str, op, *tensors: Tensor) -> None:
        """op(*tensors) on the group: through the host for gloo + CUDA."""
        self.bytes[kind] += tensors[-1].numel() * tensors[-1].element_size()
        if tensors[0].is_cuda and dist.get_backend(self.group) == "gloo":
            host = [t.cpu() for t in tensors]
            op(*host)
            tensors[0].copy_(host[0])
        else:
            op(*tensors)

    def all_reduce_(self, t: Tensor) -> Tensor:
        """Sum over the group, in place."""
        if self.size > 1:
            self._run("all_reduce",
                      lambda x: dist.all_reduce(x, group=self.group), t)
        return t

    def all_max_(self, t: Tensor) -> Tensor:
        """Max over the group, in place."""
        if self.size > 1:
            self._run("all_reduce", lambda x: dist.all_reduce(
                x, op=dist.ReduceOp.MAX, group=self.group), t)
        return t

    def broadcast(self, t: Tensor) -> Tensor:
        """The group's first rank's `t`, on every rank (a copy)."""
        t = t.clone()
        if self.size > 1:
            src = (dist.get_global_rank(self.group, 0)
                   if self.group is not None else 0)
            self._run("broadcast", lambda x: dist.broadcast(
                x, src=src, group=self.group), t)
        return t

    def rows(self, x: Tensor, dim: int = 0) -> Tensor:
        """This rank's block of `dim` (the whole of it on one rank)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(
                f"the mesh data axis ({self.size}) must divide the batch "
                f"({n}) of dim {dim}")
        b = n // self.size
        return x.narrow(dim, self.index * b, b)

    def all_gather(self, x: Tensor, dim: int) -> Tensor:
        """Every rank's block concatenated along `dim`, in rank order."""
        if self.size == 1:
            return x
        shape = tuple(x.shape) if x.ndim else (1,)
        out = x.new_empty((self.size * shape[0],) + shape[1:])
        self._run("all_gather", lambda o, i: dist.all_gather_into_tensor(
            o, i, group=self.group), out, x.contiguous().reshape(shape))
        return torch.cat(out.view((self.size,) + shape).unbind(0), dim=dim)

    def reduce_scatter_mean(self, x: Tensor, dim: int) -> Tensor:
        """This rank's block of `dim` of the mean of `x` over the ranks."""
        if self.size == 1:
            return x
        blocks = torch.stack(x.chunk(self.size, dim))   # (size, *block)
        out = blocks.new_empty(blocks.shape[1:])
        self._run("reduce_scatter", lambda o, i: dist.reduce_scatter_tensor(
            o, i, group=self.group), out,
            blocks.reshape((-1,) + tuple(blocks.shape[2:])))
        return out / self.size

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


class _Active:
    """A step's group and, under FSDP, its leaves' shard dims by path."""

    def __init__(self, group: DataGroup, dims: Optional[Dict[str, int]]):
        self.group, self.dims = group, dims or {}


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "gifgan_data_group", default=None)


@contextlib.contextmanager
def use(group: DataGroup, dims: Optional[Dict[str, int]] = None):
    """Run the body's batch reductions over `group`; `dims` maps the state
    paths of FSDP-sharded leaves (`params/...`, `opt_d/mu/...`) to their
    shard dim. A group of one rank is no group: its step is the
    one-process step, operation for operation (a one-rank block is the
    whole leaf)."""
    token = _ACTIVE.set(_Active(group, dims) if group.size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[DataGroup]:
    """The data group of the running step, or None outside a mesh step."""
    a = _ACTIVE.get()
    return None if a is None else a.group


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.clone()), None


def all_sum(x: Tensor) -> Tensor:
    """x summed over the running step's group (x itself outside one)."""
    g = active()
    return x if g is None else _AllSum.apply(x, g)


def mean(x: Tensor) -> Tensor:
    """The mean over every element of the logical batch: torch.mean
    outside a group, else the group's sum over its element count."""
    g = active()
    if g is None:
        return torch.mean(x)
    return all_sum(x.sum()) / (x.numel() * g.size)


def batch_max(x: Tensor) -> Tensor:
    """A max already taken over this rank's rows, taken over the group too
    (not differentiated: int8 serving's dynamic scales)."""
    g = active()
    return x if g is None else g.all_max_(x.clone())


def moments(x: Tensor, dims) -> tuple:
    """(mean, biased variance) over `dims` of the logical batch, as
    jnp.mean and jnp.var: the mean from the summed values, then the
    variance from the summed squared deviations."""
    g = active()
    if g is None:
        var, m = torch.var_mean(x, dim=dims, correction=0)
        return m, var
    count = g.size
    for d in dims:
        count *= x.shape[d]
    m = all_sum(x.sum(dims)) / count
    var = all_sum(torch.square(x - m).sum(dims)) / count
    return m, var


def randn_like_rows(gen: torch.Generator, x: Tensor) -> Tensor:
    """Standard normal noise shaped like x: in a group, drawn at the
    global shape (rows of every rank) from the shared generator and this
    rank's rows kept, so the ranks' noise is the one-process draw."""
    g = active()
    if g is None:
        return torch.randn(x.shape, generator=gen, dtype=x.dtype,
                           device=x.device)
    full = torch.randn((x.shape[0] * g.size,) + tuple(x.shape[1:]),
                       generator=gen, dtype=x.dtype, device=x.device)
    return g.rows(full)


def local_gradient(grad: Tensor) -> Tensor:
    """The gradient of a leaf this rank holds alone (see the module
    docstring)."""
    g = active()
    return grad if g is None else grad / g.size


def reduce_gradients(grads, slot: str):
    """The seam between a step's gradients and its optimizer update:
    replicated leaves take the mean over the ranks (one all-reduce of
    them all); under FSDP a sharded leaf takes this rank's block of the
    mean (reduce-scatter). `slot` names the optimizer state (`opt_d`) whose
    `mu` mirrors the gradient tree."""
    a = _ACTIVE.get()
    if a is None:
        return grads
    g, flat = a.group, flatten(grads)
    out, bucket = {}, []
    for k, v in flat.items():
        d = a.dims.get(f"{slot}/mu/{k}")
        if d is None:
            bucket.append(k)
        else:
            out[k] = g.reduce_scatter_mean(v, d)
    if bucket:
        buf = torch.cat([flat[k].reshape(-1) for k in bucket])
        g.all_reduce_(buf)
        buf /= g.size
        for k, piece in zip(bucket, buf.split(
                [flat[k].numel() for k in bucket])):
            out[k] = piece.view_as(flat[k])
    return unflatten(out)


def gather(tree, prefix: str):
    """Under FSDP, `tree` (the state's subtree at `prefix`) with every
    sharded leaf all-gathered to its full shape; else `tree` itself."""
    a = _ACTIVE.get()
    if a is None or not a.dims:
        return tree
    flat = flatten(tree)
    return unflatten({k: a.group.all_gather(v, a.dims[f"{prefix}/{k}"])
                      if f"{prefix}/{k}" in a.dims else v
                      for k, v in flat.items()})


def shard(tree, prefix: str):
    """The inverse of `gather`: this rank's block of each sharded leaf."""
    a = _ACTIVE.get()
    if a is None or not a.dims:
        return tree
    flat = flatten(tree)
    return unflatten({k: a.group.rows(v, a.dims[f"{prefix}/{k}"]).clone()
                      if f"{prefix}/{k}" in a.dims else v
                      for k, v in flat.items()})
