"""Paths over nested trees: the key scheme of the checkpoint format.

Dict keys and NamedTuple field names joined by "/", as gifgan_tpu's
core/checkpoint.py names its leaves. core/checkpoint.py, core/interop.py and
the optimizer all walk trees this way; it sits in its own module so that
checkpoint.py can use interop.py's layout conversion without an import
cycle.
"""

from __future__ import annotations

from typing import Any, Dict

SEP = "/"


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} over nested dicts and NamedTuples (fields by name);
    anything else is a leaf. Dict keys are visited in sorted order."""
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of `flatten` into nested plain dicts."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *parents, last = key.split(SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def like(target: Any, tree: Any) -> Any:
    """`tree` (nested plain dicts, e.g. from `unflatten`) rebuilt with the
    NamedTuple types of `target` wherever `target` has one."""
    if hasattr(target, "_fields"):
        return type(target)(**{f: like(getattr(target, f), tree[f])
                               for f in target._fields})
    if isinstance(target, dict):
        return {k: like(v, tree[k]) for k, v in target.items()}
    return tree
