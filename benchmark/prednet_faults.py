"""Faults planted in the PredNet program underneath a run, for the tests
and the calibration (benchmark/calibrate_prednet.py) that show the
prednet_kitti cell's check failing them. Never used by benchmark/run.py.

What parts the published model from the JAX package's minimal one:

- sigmoid_gates: the published hard_sigmoid gates run as the minimal
  model's sigmoids with +1 on the forget gate;
- stale_top_down: each level's update takes R_{l+1}(t-1) from the level
  above, not the R_{l+1}(t) that the time step has just updated;

and the training step's own, as benchmark/faults.py plants them in the
video GAN's:

- unchanged: each training step returns the state it was given;
- half_batch: each training step gathers the first half of its clips
  only, its loss the mean over that half.
"""

from __future__ import annotations

import contextlib

FAULTS = ("sigmoid_gates", "stale_top_down", "unchanged", "half_batch")


@contextlib.contextmanager
def planted(name: str):
    """Plant the named fault in the program for the duration of the
    block."""
    from gifgan_tpu_torch.models import prednet
    from gifgan_tpu_torch.train import prednet as ptrain

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    gates, above = dict(prednet.GATES), prednet._from_above
    step = ptrain.train_step_ids

    def unchanged(ts, *args, **kw):
        return ts, step(ts, *args, **kw)[1]

    def half_batch(ts, ids, *args, **kw):
        return step(ts, ids[: ids.shape[0] // 2], *args, **kw)

    try:
        if name == "sigmoid_gates":
            prednet.GATES["hard_sigmoid"] = prednet.GATES["sigmoid"]
        elif name == "stale_top_down":
            prednet._from_above = lambda state, new, l: state[l + 1]["r"]
        elif name == "unchanged":
            ptrain.train_step_ids = unchanged
        else:
            ptrain.train_step_ids = half_batch
        yield
    finally:
        prednet.GATES.update(gates)
        prednet._from_above = above
        ptrain.train_step_ids = step
