"""The check of benchmark/checks/train_steps.py, and step 1's predicted
frames beside it.

The numbers of train_steps.py (its docstring), and:

- pred_gap: the predictions A_hat_0 that step 1's forward pass makes of
  its clips at t >= 1, at the positions that the reference's `pred_sample`
  draws: mean |program - reference| over mean |reference|. Every value of
  the forward pass at every time step feeds them, so they part a lower
  precision from the program's by the ratio of the two roundings, on
  every seed alike, where a gradient norm of one seed can stand near a
  kink of the recurrence.

The entry keeps its side of them in `first_preds` (a `pred_sample` of
the predictions that its watched call's forward pass returned).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.checks import train_steps


def during_setup(cell, traffic) -> Dict:
    """train_steps's readings, with the program's predictions."""
    readings = train_steps.during_setup(cell, traffic)
    readings["pred"] = cell.first_preds
    return readings


def numbers(prog: Dict, ref: Dict, nets: Dict[str, str]
            ) -> Dict[str, float]:
    out = train_steps.numbers(prog, ref, nets)
    got = torch.tensor(prog["pred"], dtype=torch.float64)
    want = torch.tensor(ref["pred"], dtype=torch.float64)
    out["pred_gap"] = float((got - want).abs().mean() / want.abs().mean())
    return out


def after_window(cell, traffic, weights, reference, cfg, prog: Dict,
                 workload: Dict) -> Dict[str, float]:
    """Free the program's state, run the reference, compare."""
    cell.free()
    ref = reference.train_readings(weights, traffic.device_corpus(),
                                   traffic.recorded, cfg)
    return numbers(prog, ref, workload["nets"])
