"""Weights across the package boundary: gifgan_tpu's flat checkpoint keys
<-> this package's tensors.

Both directions work on the flat `{path: array}` scheme of
core/checkpoint.py (`params/img_generator/h1_deconv/w`,
`opt_g/0/mu/vid/lin0/w`, ...), so one function serves a live JAX tree
flattened in a test and a run directory's `arrays.npz`.

What changes on the way in (`from_jax_flat`); `to_jax_flat` undoes it:

- every 4-D weight by its rank, whatever its layer's name (the recurrent
  GAN's `enc*`/`dec*` and PredNet's `lstm*`/`ahat*`/`up*` too; their 2-D
  LSTM namesakes stay `(in, out)`): conv2d weights HWIO -> OIHW
  (F.conv2d), deconv weights, TF conv2d_transpose `[h, w, out, in]` ->
  `(in, out, h, w)` (F.conv_transpose2d) — one axis order; a deconv's is
  the kernel of the forward conv being transposed, so no spatial flip;
- conv3d weights  DHWIO -> OIDHW (F.conv3d);
- linear weights stay `(in, out)`: the port's layers take NHWC / NDHWC
  activations at their boundaries, so every flatten before a linear
  (dcgan h3_lin, vid-D h4_lin) and the h0_lin -> (s16, s16, 8gf) reshape
  run in the JAX package's element order and the rows need no permutation;
- optax's `adam` state is the tuple `(ScaleByAdamState, EmptyState)`; its
  leaves `opt_x/0/{count,mu,nu}` become the port's `opt_x/{count,mu,nu}`
  (train/gan.py AdamState).

An int8 serving tree's `wq` leaves (ops/quant.py) take the layouts of the
float `w` they quantize, and keep their int8 dtype. Every other leaf
(biases, BN scale/bias/mean/var, scales, counts, `step`) crosses
unchanged. Conversion is a pure permutation, so a round trip is bit-exact.

The detection path has no weights; its model data is the cascade file, and
`cascade_tables` carries a parsed cascade of either package into the stage
kernel's tables.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.core.tree import flatten, unflatten

# rank of a weight leaf -> its permutation from the JAX layout to the
# port's: HWIO -> OIHW (F.conv2d) and TF's [h, w, out, in] -> (in, out, h,
# w) (F.conv_transpose2d) are the same axis order; DHWIO -> OIDHW
_TO_PORT = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_OPT_JAX = re.compile(r"^(opt_[^/]+)/0/")
_OPT_PORT = re.compile(r"^(opt_[^/]+)/")


def _perm(key: str, ndim: int):
    """The permutation a leaf takes on the way in, None for none: every
    4-D weight (`w`, or an int8 `wq`) is a conv or a transpose conv, a
    5-D one a conv3d; 2-D linear and LSTM weights and every other leaf
    cross as they are. The rank decides, not the layer's name."""
    parts = key.split("/")
    if parts[-1] not in ("w", "wq") or len(parts) < 2:
        return None
    return _TO_PORT.get(ndim)


def jax_shape(key: str, shape) -> tuple:
    """(the JAX package's shape of the leaf at state path `key` whose port
    shape is `shape`, the port dim of each JAX dim)."""
    shape = tuple(shape)
    perm = _perm(key, len(shape))
    if perm is None:
        return shape, list(range(len(shape)))
    return (tuple(shape[list(perm).index(i)] for i in range(len(shape))),
            [list(perm).index(i) for i in range(len(shape))])


def from_jax_flat(flat: Dict[str, np.ndarray], device=None) -> Dict[str, Any]:
    """JAX flat checkpoint dict -> nested dict of port tensors on `device`."""
    device = resolve_device(device)
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        perm = _perm(key, arr.ndim)
        if perm is not None:
            arr = arr.transpose(perm)
        # np.array, not ascontiguousarray: that one makes 0-d arrays 1-d
        out[_OPT_JAX.sub(r"\1/", key)] = torch.tensor(
            np.array(arr, order="C"), device=device)
    return unflatten(out)


def to_jax_flat(tree: Any) -> Dict[str, np.ndarray]:
    """Port tree (nested dicts / NamedTuples of tensors) -> JAX flat dict of
    numpy arrays, ready for either package's checkpoint.save."""
    out = {}
    for key, leaf in flatten(tree).items():
        arr = leaf.detach().cpu().numpy() if isinstance(
            leaf, torch.Tensor) else np.asarray(leaf)
        perm = _perm(key, arr.ndim)
        if perm is not None:
            arr = arr.transpose(np.argsort(perm))
        out[_OPT_PORT.sub(r"\1/0/", key)] = np.array(arr, order="C")
    return out


def cascade_tables(cas: Any, n_stages: int = None, dtype=np.float32):
    """A parsed Haar cascade -> the stage kernel's per-tree tables
    (kernels/haar_stages.py cascade_tables_rolled).

    `cas` is either package's `HaarCascade` (gifgan_tpu/track/haar.py or
    track/haar.py here): only its fields are read, as numpy arrays, so a
    test can parse one XML with the JAX package and hand both sides the
    same cascade. There are no learned weights on the detection path; the
    cascade file is its model data. n_stages=None takes every stage."""
    import dataclasses

    from gifgan_tpu_torch.kernels.haar_stages import cascade_tables_rolled
    from gifgan_tpu_torch.track.haar import HaarCascade, _scaled_rects

    own = HaarCascade(**{
        f.name: (int(getattr(cas, f.name)) if f.name.startswith("window_")
                 else np.array(getattr(cas, f.name)))
        for f in dataclasses.fields(HaarCascade)})
    if n_stages is None:
        n_stages = len(own.stage_thr)
    return cascade_tables_rolled(own, _scaled_rects(own, 1.0), n_stages,
                                 dtype)
