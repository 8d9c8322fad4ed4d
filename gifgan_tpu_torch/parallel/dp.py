"""Data-parallel training and sampling over the mesh's data axis
(gifgan_tpu/parallel/dp.py).

As in the JAX package, the train state is replicated (or, with
`state_shardings` from parallel/fsdp.py, sharded) and the batch is split
over the data axis; the step functions are the one-process ones. What
XLA's partitioner inserts there is explicit here:

- the wrapped call takes the GLOBAL batch arrays (every rank passes the
  same) and hands the step this rank's rows along `batch_axis`, as jit's
  in_shardings place a host array;
- it runs the step inside parallel/collectives.py `use`, so the step's
  batch reductions (BN moments, loss means, diagnostics) cover the whole
  logical batch, its noise is the global draw's rows, and its gradients
  are reduced over the ranks between the gradient and the optimizer
  update (train/vid.py and train/gan.py call `reduce_gradients` there);
- metrics come back equal on every rank.

The state is passed as a value and a new one is returned, so there is no
buffer to donate: `donate_state` is accepted for the JAX signature.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from gifgan_tpu_torch.core.mesh import (DATA_AXIS, Mesh, data_sharding,
                                        replicate)
from gifgan_tpu_torch.core.tree import flatten
from gifgan_tpu_torch.parallel import collectives


def shard_train_state(mesh: Mesh, ts):
    """Replicate the whole train state over the mesh (rank 0's values)."""
    return replicate(mesh, ts)


def shard_batch_arrays(mesh: Mesh, *arrays):
    """This rank's rows (axis 0) of each global batch array."""
    out = tuple(data_sharding(mesh).place(torch.as_tensor(a))
                for a in arrays)
    return out if len(out) > 1 else out[0]


def make_sharded_sampler(sample_fn: Callable, mesh: Mesh, *,
                         static_args: dict) -> Callable:
    """Data-parallel inference: each rank samples its rows of z with the
    replicated tree, and the rows are gathered so every rank returns the
    whole batch (a writer on rank 0 has it all).

    sample_fn signature: (tree, z, **static_args) -> tensor whose axis 0 is
    the batch (train/vid.py sample_videos or sample_videos_q). BN uses its
    running moments, and the one batch-wide reduction, int8's dynamic
    activation scale, runs over the group (parallel/collectives.py), so
    the output equals one process's."""
    group = mesh.data_group
    n_data = mesh.shape[DATA_AXIS]

    def call(tree, z):
        if z.shape[0] % n_data:
            raise ValueError(
                f"the mesh data axis ({n_data}) must divide the sampler "
                f"batch ({z.shape[0]}); grow --batch-size to a multiple "
                f"of {n_data} or shrink the mesh")
        with collectives.use(group):
            rows = sample_fn(tree, group.rows(z), **static_args)
        return group.all_gather(rows, 0)

    return call


def state_dims(state_shardings) -> dict:
    """{state path: shard dim} of the leaves a sharding tree splits over
    the data axis (parallel/fsdp.py fsdp_state_shardings); {} for None.
    Leaves split over `model` (parallel/tp.py) are never gathered: the
    layers work on their blocks."""
    if state_shardings is None:
        return {}
    return {k: s.dim for k, s in flatten(state_shardings).items()
            if s.dim is not None and s.axis == DATA_AXIS}


def make_sharded_step(step_fn: Callable, mesh: Mesh, *, static_args: dict,
                      donate_state: bool = True, batch_axis: int = 0,
                      state_shardings: Any = None,
                      pass_knobs: bool = False) -> Callable:
    """Wrap a (ts, *batch_arrays, gen, **static) step for the mesh.

    step_fn signature: (ts, *arrays, gen, **static_args) -> (ts, metrics),
    gen the step's torch.Generator (the same on every rank).
    batch_axis: which array axis is the batch: 0 for (B, ...) batches, 1
    for chunked (K, B, ...) stacks (train_chunk, train_chunk_ids' ids).
    state_shardings: a sharding tree of ts (parallel/fsdp.py
    fsdp_state_shardings, parallel/tp.py vid_state_tp_shardings): ts then
    holds this rank's blocks of the sharded leaves, and so does the
    returned state. Default: replicated. The step runs in every group of
    the mesh (parallel/collectives.py use_mesh): on a model axis its
    layers take their tensor-parallel forms.
    pass_knobs: the call takes a trailing Knobs (train/vid.py), forwarded
    as step_fn(..., knobs=knobs); equal on every rank."""
    group = mesh.data_group
    dims = state_dims(state_shardings)
    n_tail = 2 if pass_knobs else 1

    def call(ts, *args):
        arrays, tail = args[:len(args) - n_tail], args[len(args) - n_tail:]
        local = tuple(group.rows(a, batch_axis) for a in arrays)
        kw = dict(static_args)
        if pass_knobs:
            kw["knobs"] = tail[1]
        with collectives.use_mesh(mesh, dims):
            return step_fn(ts, *local, tail[0], **kw)

    return call
