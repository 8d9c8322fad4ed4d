"""Checkpoints in gifgan_tpu's on-disk format.

A step lives in `ckpt_dir/step_NNNNNNNNNN/` as `arrays.npz` (one array per
leaf, keyed by its slash-joined tree path) plus `tree.json` (the step, the
sorted keys and their dtypes) — the layout of gifgan_tpu/core/checkpoint.py
`save`, so either package lists, loads and writes the other's steps.

The path scheme is the JAX one: dict keys and NamedTuple field names joined
by "/" (core/tree.py). On disk the weights are always in the JAX package's
layouts and key names, so a step written by either package loads into
either:

- `save` stores the arrays as given: pass it `interop.to_jax_flat(state)`;
- `AsyncCheckpointer.save` takes a port state and converts it itself;
- `restore` and `graft` read into a port state through
  `interop.from_jax_flat`, matching leaves by their JAX keys.

`restore`/`graft` are the reference's pytree surgery (gifgan_tpu/core/
checkpoint.py:108, :146): restore all but some paths, or load a smaller
tree's checkpoint into a subtree (the image GAN into the video GAN). A
restore or graft that matches no key raises.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gifgan_tpu_torch.core import interop
from gifgan_tpu_torch.core.tree import SEP, flatten, like


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, max_to_keep: int = 0) -> str:
    """Write `tree` as ckpt_dir/step_N/{arrays.npz, tree.json}, atomically
    through a tmp dir rename; keep the newest `max_to_keep` steps (0 = all)."""
    flat = {k: _to_numpy(v) for k, v in flatten(tree).items()}
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {
        "step": step,
        "keys": sorted(flat.keys()),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if max_to_keep > 0:
        for s in all_steps(ckpt_dir)[:-max_to_keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"))
    return final


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_flat(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """{key: array} of one step (the latest when `step` is None)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _device(tree: Any) -> torch.device:
    for leaf in flatten(tree).values():
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _load_into(op: str, ckpt_dir: str, target: Any, step: Optional[int],
               ckpt_key: Callable[[str], Optional[str]],
               warn_unconsumed: bool = False) -> Any:
    """`target` with each leaf whose JAX key k has ckpt_key(k) in the
    checkpoint replaced by that array (cast to the leaf's dtype and shape);
    ckpt_key(k) None keeps the leaf. Same structure and device as target."""
    flat_ckpt = load_flat(ckpt_dir, step)
    new, matched, missing = {}, [], []
    for key, leaf in interop.to_jax_flat(target).items():
        ck = ckpt_key(key)
        if ck is not None and ck in flat_ckpt:
            leaf = np.asarray(flat_ckpt[ck], dtype=leaf.dtype).reshape(
                leaf.shape)
            matched.append(ck)
        elif ck is not None:
            missing.append(ck)
        new[key] = leaf
    _check_match(op, ckpt_dir, matched, missing, flat_ckpt, warn_unconsumed)
    return like(target, interop.from_jax_flat(new, _device(target)))


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            exclude: Sequence[str] = (), prefix: str = "") -> Any:
    """Restore a port state from a step (the latest when `step` is None).

    exclude: JAX-key path prefixes to keep at target's values. prefix: a
    target leaf with JAX key k is read from checkpoint key prefix + k."""
    def ckpt_key(key):
        if any(key == e or key.startswith(e + SEP) for e in exclude):
            return None
        return prefix + key

    return _load_into("restore", ckpt_dir, target, step, ckpt_key,
                      warn_unconsumed=not exclude and not prefix)


def graft(ckpt_dir: str, target: Any, subpath: str, ckpt_prefix: str = "",
          step: Optional[int] = None) -> Any:
    """Load a checkpoint of a smaller tree into the subtree `subpath` (a JAX
    key prefix) of a port state: the leaf at `subpath/REST` is read from
    checkpoint key `ckpt_prefix + REST`; every other leaf is kept. E.g. an
    image-GAN checkpoint into a video-GAN state: subpath
    "params/img_generator", ckpt_prefix "params/generator/"."""
    sp = subpath.rstrip(SEP) + SEP
    return _load_into(
        "graft", ckpt_dir, target, step,
        lambda key: ckpt_prefix + key[len(sp):] if key.startswith(sp)
        else None)


def _check_match(op: str, ckpt_dir: str, matched: List[str],
                 missing: List[str], flat_ckpt: Dict[str, np.ndarray],
                 warn_unconsumed: bool = False) -> None:
    """Raise when no key matched (a no-op restore would leave random
    weights in place); warn on target leaves without a key and, for a
    plain full restore, on checkpoint keys nothing consumed."""
    if not matched:
        raise KeyError(
            f"{op}: 0 of {len(missing)} target leaves matched any checkpoint "
            f"key in {ckpt_dir} — wrong prefix/subpath or architecture? "
            f"wanted e.g. {missing[:5]}, checkpoint has e.g. "
            f"{sorted(flat_ckpt)[:5]}")
    if missing:
        warnings.warn(f"{op}: {len(missing)} target leaves had no checkpoint "
                      f"key (kept current values), e.g. {missing[:5]}",
                      stacklevel=3)
    if warn_unconsumed:
        unconsumed = sorted(set(flat_ckpt) - set(matched))
        if unconsumed:
            warnings.warn(f"{op}: {len(unconsumed)} checkpoint keys were not "
                          f"consumed by any target leaf (layout mismatch?), "
                          f"e.g. {unconsumed[:5]}", stacklevel=3)


class AsyncCheckpointer:
    """Checkpoint writes on a worker thread.

    `save` snapshots the port state to host numpy arrays in the JAX layout
    (`interop.to_jax_flat`, fresh copies) on the caller's thread, so the
    training loop may go on updating its tensors; the npz write and the
    old-step removal run on the worker. One write is in flight at a time: a
    second `save` first waits for the previous one. A write's error is
    raised by the next `save`, `wait` or `close`.

    multihost=True (a run on a mesh): `save` goes through `save_multihost`
    on the caller's thread, every rank calling it with the same (full)
    state; rank 0 writes between two barriers."""

    def __init__(self, multihost: bool = False):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self.multihost = multihost

    def save(self, ckpt_dir: str, step: int, tree: Any,
             max_to_keep: int = 0):
        self.wait()
        if self.multihost:
            primary = _process_index() == 0
            return save_multihost(
                ckpt_dir, step, interop.to_jax_flat(tree) if primary else {},
                max_to_keep=max_to_keep)
        host = interop.to_jax_flat(tree)
        self._pending = self._pool.submit(save, ckpt_dir, step, host,
                                          max_to_keep)
        return self._pending

    def wait(self) -> None:
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def save_multihost(ckpt_dir: str, step: int, tree: Any, max_to_keep: int = 0,
                   process_index: Optional[int] = None,
                   barrier=None) -> Optional[str]:
    """A replicated state's save from every process of a run: process 0
    writes (one copy suffices on a shared filesystem) and every process
    joins a barrier before AND after, so none races ahead into a restore of
    a half-written step. Returns the step's path on process 0, else None.

    process_index and barrier(name) are injectable for tests; the defaults
    use the process group (no barrier in a single process)."""
    if process_index is None:
        process_index = _process_index()
    if barrier is None:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            barrier = lambda name: None
        else:
            barrier = lambda name: dist.barrier()
    barrier(f"ckpt_pre_{step}")
    path = None
    if process_index == 0:
        path = save(ckpt_dir, step, tree, max_to_keep=max_to_keep)
    barrier(f"ckpt_post_{step}")
    return path
