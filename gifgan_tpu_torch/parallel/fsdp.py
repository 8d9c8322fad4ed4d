"""ZeRO-3 sharding of the train state over the mesh's data axis
(gifgan_tpu/parallel/fsdp.py), written with torch.distributed collectives.

Every state leaf of at least `min_size` elements (params, the Adam slots,
BN moments where they are that large, the frozen image nets too) is split
over the data axis along one dim; each rank keeps its block. The JAX
package leaves the schedule to XLA; here it is explicit in the steps
(train/vid.py, train/gan.py, through parallel/collectives.py):

- each pass all-gathers the sharded params and state it reads;
- the gradients of sharded leaves are reduce-scattered (summed), those
  of replicated leaves all-reduced (summed; parallel/collectives.py);
- Adam updates this rank's blocks of params, mu and nu.

The shard dim follows the JAX rule: the largest dim that the axis size
divides, ties to the lower dim (Python's stable sort), decided in the JAX
package's layout. A port weight is that layout permuted
(core/interop.py), so the rule is applied to the JAX shape and mapped back:
the vid-D conv3d weight, (256, 256, 3, 3, 3) here and [3, 3, 3, 256, 256]
in JAX, shards its in-channels (JAX dim 3, port dim 1) in both packages.

Numerically a layout change: the losses match the replicated run up to
float32 rounding (tests/test_torch_parallel.py). `place_state` and its
inverse `gather_state` serve any sharding tree (FSDP's, and parallel/tp.py's
over the model axis); `gather_state` rebuilds the full state, which
checkpoints and sample grids read.
"""

from __future__ import annotations

import math
from typing import Optional

from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.mesh import AXIS_SETS, DATA_AXIS, Mesh, Sharding
from gifgan_tpu_torch.core.tree import flatten, like, unflatten


def shard_dim(key: str, shape, n: int, min_size: int) -> Optional[int]:
    """The port dim that the JAX rule shards a leaf at state path `key`
    of this (port) shape over n ranks on, or None (replicated)."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_size:
        return None
    jax_shape, port_dim = interop.jax_shape(key, shape)
    for d in sorted(range(len(jax_shape)), key=lambda d: jax_shape[d],
                    reverse=True):
        if jax_shape[d] % n == 0:
            return port_dim[d]
    return None


def fsdp_state_shardings(mesh: Mesh, ts, axis: str = DATA_AXIS,
                         min_size: int = 2048):
    """A Sharding per leaf of ANY train state (VidTrainState, the image
    GAN's TrainState, ...): every leaf of >= min_size elements is split
    over `axis` along the dim of the JAX rule; everything else is
    replicated. The Adam slots mirror their params' shapes and keys, so
    they take the same dims and their update stays local."""
    n = mesh.shape[axis]
    flat = {k: Sharding(mesh, shard_dim(k, getattr(v, "shape", ()), n,
                                        min_size))
            for k, v in flatten(ts).items()}
    return like(ts, unflatten(flat))


def _apply(ts, shardings, fn):
    sh = flatten(shardings)
    return like(ts, unflatten({k: fn(v, sh[k])
                               for k, v in flatten(ts).items()}))


def place_state(ts, shardings):
    """ts with the mesh's first rank's values and this rank's block of
    each sharded leaf (the counterpart of device_put with the shardings:
    FSDP's, or parallel/tp.py's over the model axis)."""
    def put(v, s):
        whole = s.mesh.group(AXIS_SETS[-1]).broadcast(v)
        return whole if s.dim is None else s.mesh.group(s.axis).rows(
            whole, s.dim).clone()

    return _apply(ts, shardings, put)


def place_fsdp(mesh: Mesh, ts, axis: str = DATA_AXIS, min_size: int = 2048):
    """ts placed per fsdp_state_shardings."""
    return place_state(ts, fsdp_state_shardings(mesh, ts, axis, min_size))


def place_and_shardings(mesh: Mesh, ts, min_size: int = 2048):
    """(placed train state, matching sharding tree): the pair
    dp.make_sharded_step's state_shardings wants; shared by both train
    loops."""
    if mesh is None:
        raise ValueError("--fsdp requires a device mesh; it shards state "
                         "over the `data` axis (use --data-parallel 0/N)")
    shardings = fsdp_state_shardings(mesh, ts, min_size=min_size)
    ts = place_fsdp(mesh, ts, min_size=min_size)
    return ts, shardings


def gather_state(ts, shardings):
    """The full train state on every rank: each sharded leaf all-gathered
    over its sharding's axis (FSDP's data axis, tensor parallelism's
    model axis; collective: every rank of the mesh calls it)."""
    if shardings is None:
        return ts
    return _apply(ts, shardings, lambda v, s: v if s.dim is None
                  else s.mesh.group(s.axis).all_gather(v, s.dim))
