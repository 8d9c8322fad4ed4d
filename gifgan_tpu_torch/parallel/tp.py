"""Tensor-parallel layout of the DCGAN nets' weights
(gifgan_tpu/parallel/tp.py), over the mesh's `model` axis.

The JAX package's rule, decided on the JAX shapes: every conv, deconv and
linear weight (`w` of rank 2, 4 or 5) is split along its last JAX axis,
HWIO's O for a conv and a conv3d, a linear's out, and a deconv's in
(TF's `[h, w, out, in]`); a weight whose dim the axis does not divide stays
replicated, as do the biases, the BN vectors and state and the Adam
`count`. The full layout also splits the Adam `mu`/`nu` of each split
weight alike, so Adam's update stays local. A JAX axis maps to the port's
dim through core/interop.py's permutation: a conv's O is port dim 0 of
`(out, in, k, k)`, a conv3d's too, a linear's out is port dim 1 of
`(in, out)`, and a deconv's in is port dim 0 of `(in, out, k, k)`, which
makes it row-parallel.

XLA completes that layout with collectives in the JAX package. Here each
rank keeps its block of a split leaf, and the layers use the blocks as
they are (ops/nn.py: column-parallel convs, conv3ds and linears,
row-parallel deconvs, BN on channel-sharded activations), their
collectives over the step's model group (parallel/collectives.py). No
step gathers a weight. Numerically a layout change: the steps match the
replicated run up to float32 summation order (tests/test_torch_tp_sp.py).
`parallel/fsdp.py place_state` places a state per these shardings and
`gather_state` rebuilds the whole one (checkpoints, sample grids).
"""

from __future__ import annotations

from typing import Dict

from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.mesh import MODEL_AXIS, Mesh, Sharding
from gifgan_tpu_torch.core.tree import flatten, like, unflatten
from gifgan_tpu_torch.parallel.fsdp import place_state


def _spec_for(path_key: str, shape) -> tuple:
    """The JAX PartitionSpec of a leaf named `path_key` of JAX shape
    `shape`, as a tuple of axis names (() is replicated): a weight's last
    axis over `model`."""
    nd = len(shape)
    if path_key == "w" and nd in (2, 4, 5):
        return (None,) * (nd - 1) + (MODEL_AXIS,)
    return ()


def _leaf_sharding(mesh: Mesh, path: str, leaf) -> Sharding:
    """The Sharding of the leaf at state path `path` (port shape): split
    per _spec_for on the port dim of that JAX axis, replicated when the
    `model` axis does not divide it."""
    jax_shape, port_dim = interop.jax_shape(path, getattr(leaf, "shape", ()))
    spec = _spec_for(path.rsplit("/", 1)[-1], jax_shape)
    for d, name in enumerate(spec):
        if name == MODEL_AXIS and jax_shape[d] % mesh.shape[MODEL_AXIS] == 0:
            return Sharding(mesh, port_dim[d], MODEL_AXIS)
    return Sharding(mesh, None)


def _tree_shardings(mesh: Mesh, tree, prefix: str = ""):
    return unflatten({k: _leaf_sharding(mesh, prefix + k, v)
                      for k, v in flatten(tree).items()})


def shard_dcgan_params_tp(mesh: Mesh, params: Dict) -> Dict:
    """A DCGAN generator's or discriminator's params with this rank's
    block of each split weight (BN state is passed separately and stays
    whole)."""
    return place_state(params, _tree_shardings(mesh, params))


def opt_state_tp_shardings(mesh: Mesh, opt_state):
    """Shardings of an AdamState (train/gan.py) whose `mu`/`nu` mirror the
    trainable params: each slot as its param, `count` replicated."""
    rep = Sharding(mesh, None)
    return like(opt_state, unflatten({
        k: _leaf_sharding(mesh, k, v) if k.split("/", 1)[0] in ("mu", "nu")
        else rep for k, v in flatten(opt_state).items()}))


def vid_state_tp_shardings(mesh: Mesh, ts, full: bool = False):
    """Shardings of a whole train/vid.py VidTrainState (the shapes decide,
    so pass the whole state, not a placed one).

    full=False: the nested image nets' weights split; the vid nets, BN
    state and Adam slots replicated. The slots must then hold no split
    weight: a trainable image net (tcfg.train_img_gen/_disc) needs
    full=True. full=True: also the vid-G's linears, the vid-D's conv3ds
    (the 1-wide h4_lin stays whole) and the Adam slots alike."""
    nets = ("img_generator", "img_discriminator") + (
        ("vid_generator", "vid_discriminator") if full else ())
    flat = {k: Sharding(mesh, None) for k in flatten(ts)}
    for net in nets:
        flat.update(flatten(_tree_shardings(mesh, ts.params[net],
                                            f"params/{net}/"),
                            f"params/{net}"))
    for slot in ("opt_g", "opt_d"):
        if full:
            flat.update(flatten(opt_state_tp_shardings(
                mesh, getattr(ts, slot)), slot))
        elif any(k.startswith(f"{slot}/mu/img") for k in flat):
            raise ValueError("full=False keeps the Adam slots whole; a "
                             "trainable image net needs full=True")
    return like(ts, unflatten(flat))


def place_vid_state_tp(mesh: Mesh, ts, full: bool = False):
    """A whole VidTrainState placed per vid_state_tp_shardings."""
    return place_state(ts, vid_state_tp_shardings(mesh, ts, full))
