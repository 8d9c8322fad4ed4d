"""Sequence parallelism: the time axis of video clips over the mesh
(gifgan_tpu/parallel/sp.py).

Folded frame stacks are (B*T, ...) with rows b-major/t-minor. Over the
composite (data, seq) axis each rank holds one contiguous row range: with
the data axis as large as the batch, T/seq frames of one clip. The JAX
package states that layout and XLA's partitioner does the rest; here the
step's code does it explicitly, through parallel/collectives.py:

- per-frame work (the vid-G MLP rows, the image G and D) stays on the
  rank's rows; their BN moments, get_std, the noise draws and the
  first-frame loss reduce over (data, seq), the first-frame loss picking
  frame 0 by its global row (models/vid_dcgan.py);
- the video discriminator gathers its clips' frames over `seq` (the
  vid_d_sharding wall) and runs alike on every seq rank, its BN and its
  loss over the clips (data);
- the gradients of the frame nets are summed over (data, seq), the
  vid-D's over data alone (collectives.reduce_gradients).

Numerically a layout change: the steps match the one-process step up to
float32 summation order (tests/test_torch_tp_sp.py).
"""

from __future__ import annotations

from typing import Any, Callable

from gifgan_tpu_torch.core.mesh import DATA_AXIS, SEQ_AXIS, Mesh, Sharding
from gifgan_tpu_torch.parallel import collectives
from gifgan_tpu_torch.parallel.dp import state_dims


def folded_seq_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0,
                        ) -> Sharding:
    """A time-folded (B*T, ...) stack: the folded axis over the (data,
    seq) composite, data-major as the rows are b-major. (`ndim` is the
    JAX signature's; a port Sharding names only the split dim.)"""
    return Sharding(mesh, batch_axis, (DATA_AXIS, SEQ_AXIS))


def clip_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0) -> Sharding:
    """Per-clip arrays (B, ...): clips over `data` only, whole over seq."""
    return Sharding(mesh, batch_axis, DATA_AXIS)


def shard_vid_batch(mesh: Mesh, frames, z, batch_axis: int = 0):
    """(this rank's rows of the global frames over (data, seq), its clips
    of the global z over data)."""
    return (folded_seq_sharding(mesh, frames.ndim, batch_axis).place(frames),
            clip_sharding(mesh, z.ndim, batch_axis).place(z))


def vid_d_sharding(mesh: Mesh, ndim: int = 4) -> Sharding:
    """Where the video discriminator's folded activations live: the clips
    over `data` only, whole in time (models/vid_dcgan.py
    vid_discriminator gathers its rows over `seq` to it)."""
    return Sharding(mesh, 0, DATA_AXIS)


def make_sp_step(step_fn: Callable, mesh: Mesh, *, static_args: dict,
                 donate_state: bool = True, batch_axis: int = 0,
                 state_shardings: Any = None, pass_knobs: bool = False,
                 folded: bool = True) -> Callable:
    """Wrap a (ts, frames, z, gen, **static) step for sequence
    parallelism, with the calling contract of dp.make_sharded_step: the
    global arrays in, this rank's rows to the step, which runs in every
    group of the mesh (collectives.use_mesh), so it composes with tensor
    parallelism (state_shardings from parallel/tp.py) and FSDP.

    batch_axis: 0 for train_step's (B*T, ...) frames / (B, ...) z, 1 for
    train_chunk's (K, B*T, ...) / (K, B, ...) stacks.
    pass_knobs: the call takes a trailing Knobs, forwarded as knobs=.
    folded=False: the first array holds clip ids, (K, B) for
    train_chunk_ids, split over data like z; the corpus gather of the step
    (data/device.py fold_sample_fn) keeps this rank's seq block of their
    frames. `donate_state` is accepted for the JAX signature."""
    frames_sh = (folded_seq_sharding(mesh, 0, batch_axis) if folded
                 else clip_sharding(mesh, 0, batch_axis))
    z_sh = clip_sharding(mesh, 0, batch_axis)
    dims = state_dims(state_shardings)

    def call(ts, frames, z, *tail):
        kw = dict(static_args)
        if pass_knobs:
            kw["knobs"] = tail[1]
        with collectives.use_mesh(mesh, dims, seq=True):
            return step_fn(ts, frames_sh.place(frames), z_sh.place(z),
                           tail[0], **kw)

    return call
