"""The groups of a mesh step and the collectives over them.

Under jit the JAX package's batch reductions (the BN moments, the loss
means, the collapse diagnostics) cover the whole logical batch, and its
tensor- and sequence-parallel layouts are completed with collectives,
because XLA's partitioner sees the whole program (gifgan_tpu/ops/nn.py:
281-283, sync-BN; gifgan_tpu/parallel/tp.py, sp.py). Here each rank holds
its block of the batch and of the sharded weights, and the step's code
names each collective. The code that reduces over a batch axis (ops/nn.py,
the losses, inversion) and the layers' tensor-parallel forms ask this
module for the groups of the step they run in: parallel/dp.py
make_sharded_step and parallel/sp.py make_sp_step enter that context
(`use`) around the step, and inversion around its loss. Outside it every
function here is the one-process arithmetic, unchanged.

A step has up to four groups (core/mesh.py makes them):

- `frames`, the composite (data, seq) axis: the rows of time-folded
  frames (the image nets, the vid-G MLP) and their reductions: folded BN
  moments, get_std, the noise draws, the first-frame loss;
- `data`: the clips, which the video discriminator sees whole in time
  (gathered over `seq`, the JAX package's vid_d_sharding wall); inside
  `per_clip()` the batch reductions run over it (the vid-D BN, its loss);
- `seq`: the gather of that wall;
- `model`: the layers' tensor-parallel collectives (`to_model`,
  `reduce_model`, `gather_model`, `split_model`; ops/nn.py).

Autograd. Every rank holds the whole gradient of each tensor it holds:
the same on every rank for a tensor that several ranks compute alike, its
own part for a block. Each collective's backward keeps that so:
`all_sum` (the BN moments, read again by this rank's rows) all-reduces
the cotangents; `mean` and `reduce_model` (whose result every rank
consumes alike) pass them through; `to_model` (a column-parallel layer's
input) all-reduces them; `gather_model` takes this rank's block of them,
or reduce-scatters them where the gathered tensor feeds a column-parallel
layer; `split_model` all-gathers them. So a rank's gradient of a
parameter is the sum of its own uses, and `reduce_gradients` sums it
over the ranks whose uses differ: `frames` for the nets that run on
frames, `data` alone for the vid-D, which every seq rank runs alike; a
model-sharded leaf's gradient is its block, and no leaf is reduced over
`model`.

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
    """The ranks of one mesh axis (or composite): `group` (None: the
    default group), this rank's block `index`, the `size` and the axis
    `name`. `bytes` counts what each kind of collective sent from this
    rank (its input's bytes); `shapes` counts the calls by (kind, input
    shape)."""

    def __init__(self, group, index: int, size: int, name: str = "data"):
        self.group, self.index, self.size = group, index, size
        self.name = name
        self.bytes = collections.Counter()
        self.shapes = collections.Counter()

    def _run(self, kind: str, op, *tensors: Tensor) -> None:
        """op(*tensors) on the group: through the host for gloo + CUDA."""
        self.bytes[kind] += tensors[-1].numel() * tensors[-1].element_size()
        self.shapes[(kind, tuple(tensors[-1].shape))] += 1
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
                f"the mesh {self.name} axis ({self.size}) must divide the "
                f"batch ({n}) of dim {dim}")
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

    def reduce_scatter(self, x: Tensor, dim: int) -> Tensor:
        """This rank's block of `dim` of the sum of `x` over the ranks."""
        if self.size == 1:
            return x
        blocks = torch.stack(x.chunk(self.size, dim))   # (size, *block)
        out = blocks.new_empty(blocks.shape[1:])
        self._run("reduce_scatter", lambda o, i: dist.reduce_scatter_tensor(
            o, i, group=self.group), out,
            blocks.reshape((-1,) + tuple(blocks.shape[2:])))
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


class _Active:
    """A step's groups (None where an axis has one rank), the group its
    batch reductions run over now (`rows`), and under FSDP its leaves'
    shard dims by path."""

    def __init__(self, data, frames, seq, model, dims, rows):
        self.data, self.frames, self.seq, self.model = (data, frames, seq,
                                                        model)
        self.dims, self.rows = dims or {}, rows


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "gifgan_mesh_groups", default=None)


def _one(g: Optional[DataGroup]) -> Optional[DataGroup]:
    return g if g is not None and g.size > 1 else None


@contextlib.contextmanager
def use(group: DataGroup, dims: Optional[Dict[str, int]] = None,
        frames: Optional[DataGroup] = None, seq: Optional[DataGroup] = None,
        model: Optional[DataGroup] = None):
    """Run the body in a mesh step: `group` is the data axis, `frames` the
    (data, seq) composite (default: the data axis), `seq` and `model` the
    other axes. `dims` maps the state paths of FSDP-sharded leaves
    (`params/...`, `opt_d/mu/...`) to their shard dim. A group of one rank
    is no group, and a step with none is the one-process step, operation
    for operation."""
    rows = _one(frames if frames is not None else group)
    a = _Active(_one(group), rows, _one(seq), _one(model), dims, rows)
    on = any(g is not None for g in (a.data, a.frames, a.seq, a.model))
    token = _ACTIVE.set(a if on else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def use_mesh(mesh, dims: Optional[Dict[str, int]] = None,
             seq: bool = False):
    """`use` with the groups of `mesh` (core/mesh.py): its data and model
    axes, and with seq=True (parallel/sp.py) its seq axis, the frames'
    rows then split over (data, seq); else the seq ranks run alike on the
    data axis's rows, as JAX replicates over an axis a layout leaves
    out."""
    from gifgan_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

    data = mesh.group(DATA_AXIS)
    return use(data, dims,
               frames=mesh.group((DATA_AXIS, SEQ_AXIS)) if seq else data,
               seq=mesh.group(SEQ_AXIS) if seq else None,
               model=mesh.group(MODEL_AXIS))


@contextlib.contextmanager
def per_clip():
    """Run the body's batch reductions over the data axis: the video
    discriminator's batch is the clips, whole in time on every seq rank."""
    a = _ACTIVE.get()
    token = _ACTIVE.set(None if a is None else _Active(
        a.data, a.frames, a.seq, a.model, a.dims, rows=a.data))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[DataGroup]:
    """The group the running step's batch reductions run over (the
    frames', or inside `per_clip` the clips'), or None."""
    a = _ACTIVE.get()
    return None if a is None else a.rows


def model_group() -> Optional[DataGroup]:
    """The running step's model axis, or None (no tensor parallelism)."""
    a = _ACTIVE.get()
    return None if a is None else a.model


def seq_group() -> Optional[DataGroup]:
    """The running step's seq axis, or None."""
    a = _ACTIVE.get()
    return None if a is None else a.seq


# ---------------------------------------------------------------------------
# autograd: each forward with the backward that keeps every rank's
# gradient whole (module docstring)
# ---------------------------------------------------------------------------

class _AllSum(torch.autograd.Function):
    """Sum forward; all-reduced cotangents backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.clone()), None


class _Reduce(torch.autograd.Function):
    """Sum forward; the cotangent passed through backward."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity forward; all-reduced cotangents backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.clone()), None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` forward; backward this rank's block of the
    cotangent, or of its sum over the ranks (`summed`)."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return ctx.group.reduce_scatter(g, ctx.dim), None, None, None
        return ctx.group.rows(g, ctx.dim).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    """This rank's block along `dim` forward; all-gathered cotangents
    backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.rows(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g.contiguous(), ctx.dim), None, None


def all_sum(x: Tensor) -> Tensor:
    """x summed over the running step's rows (x itself outside a step)."""
    g = active()
    return x if g is None else _AllSum.apply(x, g)


def sum_rows(x: Tensor) -> Tensor:
    """A loss term's sum over the running step's rows: every rank consumes
    the result alike, so the cotangent passes through."""
    g = active()
    return x if g is None else _Reduce.apply(x, g)


def rows_size() -> int:
    """How many ranks the running step's rows are split over (1 outside
    a step)."""
    g = active()
    return 1 if g is None else g.size


def mean(x: Tensor) -> Tensor:
    """The mean over every element of the logical batch: torch.mean
    outside a step, else the sum over the rows' ranks over the count."""
    g = active()
    if g is None:
        return torch.mean(x)
    return sum_rows(x.sum()) / (x.numel() * g.size)


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
    """Standard normal noise shaped like x: in a step, drawn at the global
    shape (rows of every rank) from the shared generator and this rank's
    rows kept, so the ranks' noise is the one-process draw."""
    g = active()
    if g is None:
        return torch.randn(x.shape, generator=gen, dtype=x.dtype,
                           device=x.device)
    full = torch.randn((x.shape[0] * g.size,) + tuple(x.shape[1:]),
                       generator=gen, dtype=x.dtype, device=x.device)
    return g.rows(full)


def seq_offset(n_rows: int) -> int:
    """Where this rank's `n_rows` frames start among its clips' frames:
    its seq block's first row (0 without a seq axis)."""
    g = seq_group()
    return 0 if g is None else g.index * n_rows


def seq_rows(x: Tensor) -> Tensor:
    """This rank's seq block of its clips' time-folded rows (no
    gradient flows back: an input's)."""
    g = seq_group()
    return x if g is None else g.rows(x)


def gather_seq(x: Tensor) -> Tensor:
    """Time-folded rows gathered over the seq axis: every seq rank then
    holds its clips' frames whole and computes alike from them, so the
    backward keeps this rank's block."""
    g = seq_group()
    return x if g is None else _Gather.apply(x, g, 0, False)


# ---------------------------------------------------------------------------
# tensor parallelism over the model axis (the layers' forms: ops/nn.py)
# ---------------------------------------------------------------------------

def to_model(x: Tensor) -> Tensor:
    """A replicated input of a column-parallel layer: identity forward,
    the ranks' partial cotangents summed backward."""
    g = model_group()
    return x if g is None else _Copy.apply(x, g)


def reduce_model(x: Tensor) -> Tensor:
    """A row-parallel layer's partial sums, summed over the model axis."""
    g = model_group()
    return x if g is None else _Reduce.apply(x, g)


def gather_model(x: Tensor, dim: int = -1, summed: bool = False) -> Tensor:
    """A model-sharded activation whole on every rank. summed=True where
    the result feeds a column-parallel layer (each rank's cotangent is
    then its own part: reduce-scatter); else every rank computes alike
    from it and keeps its block of the cotangent."""
    g = model_group()
    return x if g is None else _Gather.apply(x, g, dim % x.ndim, summed)


def split_model(x: Tensor, dim: int = -1) -> Tensor:
    """This rank's model block of a replicated tensor."""
    g = model_group()
    return x if g is None else _Split.apply(x, g, dim % x.ndim)


def model_block(x: Tensor, dim: int = -1) -> Tensor:
    """This rank's model block of a replicated tensor that no gradient
    reaches (running BN moments)."""
    g = model_group()
    return x if g is None else g.rows(x, dim % x.ndim)


def model_whole(x: Tensor, dim: int = -1) -> Tensor:
    """A model-sharded tensor that no gradient reaches, whole."""
    g = model_group()
    return x if g is None else g.all_gather(x, dim % x.ndim)


# ---------------------------------------------------------------------------
# the gradient seam and FSDP's state
# ---------------------------------------------------------------------------

def reduce_gradients(grads, slot: str, per_clip: tuple = ()):
    """The seam between a step's gradients and its optimizer update: each
    leaf's gradient summed over the ranks whose uses of it differ (the
    module docstring): over `frames`, or over `data` alone for the
    top-level subtrees named in `per_clip` (the vid-D's). Replicated
    leaves go in one all-reduce a group; under FSDP a sharded leaf takes
    this rank's block of the sum (reduce-scatter over the data axis).
    `slot` names the optimizer state (`opt_d`) whose `mu` mirrors the
    gradient tree."""
    a = _ACTIVE.get()
    if a is None:
        return grads
    flat, out = flatten(grads), {}
    buckets = {}
    for k, v in flat.items():
        clip = k.split("/", 1)[0] in per_clip
        d = a.dims.get(f"{slot}/mu/{k}")
        if d is None:
            buckets.setdefault(clip, []).append(k)
            continue
        if not clip and a.seq is not None:
            v = a.seq.all_reduce_(v.clone())
        out[k] = v if a.data is None else a.data.reduce_scatter(v, d)
    for clip, keys in buckets.items():
        g = a.data if clip else a.frames
        if g is None:
            out.update({k: flat[k] for k in keys})
            continue
        buf = g.all_reduce_(torch.cat([flat[k].reshape(-1) for k in keys]))
        for k, piece in zip(keys, buf.split([flat[k].numel()
                                             for k in keys])):
            out[k] = piece.view_as(flat[k])
    return unflatten(out)


def gather(tree, prefix: str):
    """Under FSDP, `tree` (the state's subtree at `prefix`) with every
    sharded leaf all-gathered to its full shape; else `tree` itself."""
    a = _ACTIVE.get()
    if a is None or not a.dims:
        return tree
    flat = flatten(tree)
    return unflatten({k: a.data.all_gather(v, a.dims[f"{prefix}/{k}"])
                      if f"{prefix}/{k}" in a.dims else v
                      for k, v in flat.items()})


def shard(tree, prefix: str):
    """The inverse of `gather`: this rank's block of each sharded leaf."""
    a = _ACTIVE.get()
    if a is None or not a.dims:
        return tree
    flat = flatten(tree)
    return unflatten({k: a.data.rows(v, a.dims[f"{prefix}/{k}"]).clone()
                      if f"{prefix}/{k}" in a.dims else v
                      for k, v in flat.items()})
