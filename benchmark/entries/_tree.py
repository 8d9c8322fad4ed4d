"""What the entries share: nested dicts of tensors (the program's trees)
and flat "a/b/c" keys, their norms, and a watch on the gradients that
the program's optimizer is handed."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's 2-norm, taken in float64, as a float."""
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}



@contextlib.contextmanager
def optimizer_inputs():
    """Inside the block, the norms of every gradient tree that the
    program's Adam is handed, in the order of its updates: a list of
    {"a/b": norm}. The update itself runs unchanged."""
    from gifgan_tpu_torch.train.gan import Adam

    seen: List[Dict[str, float]] = []
    update = Adam.update

    def watched(self, grads, state):
        seen.append(norms(flat(grads)))
        return update(self, grads, state)

    Adam.update = watched
    try:
        yield seen
    finally:
        Adam.update = update
