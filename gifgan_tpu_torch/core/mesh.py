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
  from the mesh's first rank);
- `Sharding(mesh, dim, axis)`: this rank's block of `dim` over one axis or
  a composite of axes, such as a weight's out-channels over `model`
  (parallel/tp.py) or time-folded frames over `(data, seq)`
  (parallel/sp.py, rows b-major/t-minor: the composite index is
  data-major).

`Mesh` makes the process groups of every axis and of the composites
`(data, seq)` and `(data, seq, model)` when it is built (new_group is
collective: every rank makes every group, in one order), and
`mesh.group(axes)` is this rank's parallel/collectives.DataGroup over one
of them. The steps reduce over them explicitly (parallel/collectives.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

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


# the axis sets a mesh makes groups for: each axis, the frames' composite
# (data, seq) and the whole mesh
AXIS_SETS = ((DATA_AXIS,), (SEQ_AXIS,), (MODEL_AXIS,), (DATA_AXIS, SEQ_AXIS),
             (DATA_AXIS, SEQ_AXIS, MODEL_AXIS))


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """A (data, seq, model) grid of ranks. `shape` maps each axis name to
    its size, as jax's Mesh.shape does."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.axis_names = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        # per axis set: the member ranks of this rank's group, in block
        # order, and the group's handle (None: the default group, or one
        # rank)
        self._members, self._handles, self._groups = {}, {}, {}
        on = dist.is_initialized() and 1 < self.size <= _world()
        made = {}
        for axes in AXIS_SETS:
            keep = [self.axis_names.index(a) for a in axes]
            other = [d for d in range(3) if d not in keep]
            n = int(np.prod([devices.shape[d] for d in keep]))
            rows = devices.transpose(other + keep).reshape(-1, n)
            for row in rows:
                members = tuple(int(r) for r in row)
                if on and n > 1 and members != tuple(range(_world())) \
                        and members not in made:
                    made[members] = dist.new_group(list(members))
                if _rank() in members:
                    self._members[axes] = members
                    self._handles[axes] = made.get(members)

    def group(self, axis=DATA_AXIS):
        """This rank's parallel/collectives.DataGroup over `axis` (a name
        or a tuple of names: a composite, blocks data-major), made once a
        mesh; axis sets with the same ranks share one."""
        axes = _axes(axis)
        members = self._members.get(axes, (_rank(),))
        if members not in self._groups:
            from gifgan_tpu_torch.parallel.collectives import DataGroup

            n = int(np.prod([self.shape[a] for a in axes]))
            if n > 1 and not dist.is_initialized():
                raise RuntimeError(
                    f"a mesh with {n} ranks on its {'x'.join(axes)} axis "
                    "needs an initialized process group "
                    "(parallel/distributed.py initialize)")
            if n > 1 and (self.size > _world()
                          or _rank() not in self.devices):
                raise RuntimeError(f"rank {_rank()} of {_world()} is not on "
                                   f"the mesh {self.devices.tolist()}")
            # a block's index is the rank's place in its group, the order
            # of all_gather and reduce_scatter
            index = members.index(_rank()) if n > 1 else 0
            self._groups[members] = DataGroup(self._handles.get(axes),
                                              index, n, "+".join(axes))
        return self._groups[members]

    @property
    def data_group(self):
        """This rank's DataGroup on the data axis."""
        return self.group(DATA_AXIS)

    def collective_bytes(self) -> dict:
        """What each collective kind sent from this rank, by axis set
        ("data", "seq", "model", "data+seq", "data+seq+model"; an axis set
        whose group is another's is counted under the first)."""
        out, seen = {}, set()
        for axes in AXIS_SETS:
            g = self.group(axes)
            if g.size > 1 and id(g) not in seen:
                seen.add(id(g))
                out["+".join(axes)] = dict(g.bytes)
        return out

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
    as many equal blocks as `axis` (a name or a composite tuple) has
    ranks. (Not a NamedTuple: a tree of them flattens to one leaf each.)"""
    mesh: Mesh
    dim: Optional[int]
    axis: Union[str, Tuple[str, ...]] = DATA_AXIS

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """The counterpart of jax.device_put(x, sharding) on this rank, for
        an `x` equal on every rank (a global batch): its block."""
        if self.dim is None:
            return self.mesh.group(AXIS_SETS[-1]).broadcast(x)
        return self.mesh.group(self.axis).rows(x, self.dim)


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
    """A tree equal on every rank of the mesh (its first rank's)."""
    return _map(tree, replicated_sharding(mesh).place)
