"""Whether a training cell's program computes what its plain reference
does.

In set-up the program's own state, built from the benchmark's weights,
takes its first CHECKED steps through the window's own call and feed,
each on clips that no other of them holds (an epoch's permutation). The
program's readings are taken then: each step's D and G loss; the norm of
each leaf of the first gradient that the D's optimizer and the G's
optimizer are handed in step 1 (the D update's, and the first of the G
updates'); and the norm of each trained leaf's change after the last
step. The same state goes on into the window. After the window, with the
program's state freed, the reference runs the same steps from the same
weights on the same clips and z, and these numbers compare the readings
(the workload file's `limits` say which of them a run is held to):

- first_loss_gap: |program - reference| of the first loss the step
  computes, step 1's D loss, before any update: every layer's forward
  pass, the gather's rows included. The later losses are not compared:
  from fresh Adam slots each first update moves every weight by a whole
  learning rate times the sign of its gradient, so a sign that rounding
  flips moves the next losses far more than the rounding itself;
- <net>_grad_gap, for each net of the workload file's `nets` (the D and
  the G): over the leaves of that net's first gradient, the largest gap
  between the program's and the reference's norm of a leaf, over the
  larger of the reference's norm of that leaf and of the median leaf.
  The G's is the gradient of its whole backward pass (in the video GAN:
  the vid-D, the frozen image nets and the vid-G). It is read as the
  optimizer gets it, not from Adam's state after the step, which blends
  it with the second G update's gradient, taken after a first update
  that rounding has already moved;
- <net>_grad_median_gap: the median of those leaves' gaps, steadier from
  seed to seed than the largest;
- change_gap: as the gradient gaps, of the norms of each trained leaf's
  change.

The gradient numbers take the leaves whose reference norm is at least
NOUGHT times the median leaf's (of the net's first gradient, or of both
nets' for the change): a bias that a batch norm follows has a gradient
of rounding alone, which Adam turns into a whole step all the same.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

CHECKED = 3
NOUGHT = 1e-3


def during_setup(cell, traffic) -> Dict:
    """Run the first CHECKED steps; the program's readings."""
    traffic.record = CHECKED
    readings = {"loss": []}
    for i in range(CHECKED):
        float(cell.call_watched() if i == 0 else cell.call())
        readings["loss"] += cell.losses()
    readings["grad"] = cell.first_grads
    readings["change"] = cell.change_norms()
    return readings


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> list:
    if set(prog) != set(ref):
        return [math.inf]               # the trees differ: not the model
    floor = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys]


def _moved(grad: Dict[str, float], keys) -> list:
    floor = statistics.median(grad[k] for k in keys)
    return [k for k in keys if grad[k] >= NOUGHT * floor]


def numbers(prog: Dict, ref: Dict, nets: Dict[str, str]
            ) -> Dict[str, float]:
    """The numbers of the module docstring; `nets` maps each net's short
    name to the prefix of its leaves."""
    grad = ref["grad"]
    out = {"first_loss_gap": abs(prog["loss"][0] - ref["loss"][0])}
    for net, prefix in nets.items():
        gaps = _gaps(prog["grad"], grad, _moved(
            grad, [k for k in grad if k.startswith(prefix)]))
        out[f"{net}_grad_gap"] = max(gaps)
        out[f"{net}_grad_median_gap"] = statistics.median(gaps)
    out["change_gap"] = max(_gaps(prog["change"], ref["change"],
                                  _moved(grad, list(grad))))
    return out


def after_window(cell, traffic, weights, reference, cfg, prog: Dict,
                 workload: Dict) -> Dict[str, float]:
    """Free the program's state, run the reference, compare."""
    cell.free()
    ref = reference.train_readings(weights, traffic.device_corpus(),
                                   traffic.recorded, cfg)
    return numbers(prog, ref, workload["nets"])
