"""Device mesh and sharding helpers (gifgan_tpu/core/mesh.py), over the
ranks of torch.distributed.

The JAX package lays its devices out as a (data, seq, model) Mesh and
places arrays with NamedShardings; XLA inserts the collectives. Here a
device is a rank of the default process group (one process a card, set up
by parallel/distributed.py initialize), the mesh is the same (data, seq,
model) grid of ranks, and a sharding says what a rank holds:

- `data_sharding`: this rank's contiguous rows of the global batch (jax's
  P("data", None, ...) on one device);
- `replicated_sharding`: the whole array, equal on every rank (broadcast
  from the first rank of the data axis).

The data axis carries the work (parallel/dp.py, parallel/fsdp.py). The
seq and model axes are accepted here and refused by the train loops: the
layers' own collectives of tensor and sequence parallelism are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gifgan_tpu_torch.core.tree import flatten, like, unflatten

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """A (data, seq, model) grid of ranks. `shape` maps each axis name to
    its size, as jax's Mesh.shape does."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.axis_names = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self._data_group = None
        # the data axis of this rank: the ranks that share its seq and model
        # coordinates. new_group is collective, so every rank makes every
        # column's group, in one order, here.
        self._group = None
        if dist.is_initialized() and 1 < self.size <= _world() and (
                self.size != _world() or devices.shape[0] != self.size):
            cols = devices.reshape(devices.shape[0], -1)
            for c in range(cols.shape[1]):
                g = dist.new_group([int(r) for r in cols[:, c]])
                if _rank() in cols[:, c]:
                    self._group = g

    @property
    def data_group(self):
        """This rank's parallel/collectives.DataGroup on the data axis, made
        once a mesh."""
        if self._data_group is None:
            from gifgan_tpu_torch.parallel.collectives import DataGroup

            n = self.shape[DATA_AXIS]
            if n > 1 and not dist.is_initialized():
                raise RuntimeError(
                    f"a mesh with {n} ranks on its data axis needs an "
                    "initialized process group (parallel/distributed.py "
                    "initialize)")
            if n > 1 and (self.size > _world()
                          or _rank() not in self.devices):
                raise RuntimeError(f"rank {_rank()} of {_world()} is not on "
                                   f"the mesh {self.devices.tolist()}")
            # a block's index is the rank's place in its group, the order
            # of all_gather and reduce_scatter
            index = (dist.get_rank(self._group) if self._group is not None
                     else _rank() if n > 1 else 0)
            self._data_group = DataGroup(self._group, index, n)
        return self._data_group

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(devices: Optional[Sequence[int]] = None,
              data_parallel: int = 0, model_parallel: int = 1,
              seq_parallel: int = 1) -> Mesh:
    """Build a (data, seq, model) mesh of ranks (default: every rank of
    the process group, or one rank without a group).

    data_parallel == 0 means "all remaining ranks on the data axis". The
    seq and model axes are size 1 unless asked for."""
    if devices is None:
        devices = range(_world())
    n = len(devices)
    if model_parallel <= 0:
        model_parallel = 1
    if seq_parallel <= 0:
        seq_parallel = 1
    if data_parallel <= 0:
        data_parallel = n // (model_parallel * seq_parallel)
    if data_parallel * model_parallel * seq_parallel != n:
        raise ValueError(
            f"mesh {data_parallel}x{seq_parallel}x{model_parallel} "
            f"!= {n} devices")
    arr = np.asarray(list(devices)).reshape(data_parallel, seq_parallel,
                                            model_parallel)
    return Mesh(arr)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """What a rank holds of an array: `dim` None is the whole array (equal
    on every rank); else this rank's contiguous block of that dim, one of
    `mesh.shape["data"]` equal blocks. (Not a NamedTuple: a tree of them
    flattens to one leaf each.)"""
    mesh: Mesh
    dim: Optional[int]

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """The counterpart of jax.device_put(x, sharding) on this rank."""
        dg = self.mesh.data_group
        if self.dim is None:
            return dg.broadcast(x)
        return dg.rows(x, self.dim)


def data_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Shard the leading (batch) dim over the data axis."""
    return Sharding(mesh, 0)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def _map(tree, fn):
    """fn over the array leaves (tensors, numpy arrays) of a tree of dicts
    and NamedTuples."""
    flat = {k: fn(torch.as_tensor(v))
            if isinstance(v, (torch.Tensor, np.ndarray)) else v
            for k, v in flatten(tree).items()}
    if hasattr(tree, "_fields") or isinstance(tree, dict):
        return like(tree, unflatten(flat))
    return flat[""]


def shard_batch(mesh: Mesh, batch):
    """A tree of global batches -> this rank's rows of each."""
    return _map(batch, data_sharding(mesh).place)


def replicate(mesh: Mesh, tree):
    """A tree equal on every rank of the data axis (its first rank's)."""
    return _map(tree, replicated_sharding(mesh).place)
