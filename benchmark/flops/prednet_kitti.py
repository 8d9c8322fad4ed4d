"""Model FLOPs of one prednet_kitti training step
(benchmark/reference/prednet_kitti.py says what it computes): every 3x3
convolution of every level at every time step, forward, input gradient
and weight gradient, the usual three times the forward. Counted from the
configuration's widths and the traffic's clips alone.

Per level l at (h / 2^l) x (w / 2^l): the gate conv from
2 a_l + r_{l+1} + r_l channels to 4 r_l, A_hat's from r_l to a_l, and
below the top A_{l+1}'s from 2 a_l to a_{l+1}.
"""

from __future__ import annotations

from typing import Dict

from benchmark.flops._count import conv, passes


def frame_step_flops(cfg: Dict) -> float:
    """Forward FLOPs of one time step of one clip."""
    a, r = cfg["stack_sizes"], cfg["r_stack_sizes"]
    h, w = cfg["frame"]
    n, total = len(a), 0.0
    for l in range(n):
        pos = (h >> l) * (w >> l)
        top = r[l + 1] if l + 1 < n else 0
        total += conv(pos, 3, 2 * a[l] + top + r[l], 4 * r[l])
        total += conv(pos, 3, r[l], a[l])
        if l + 1 < n:
            total += conv(pos, 3, 2 * a[l], a[l + 1])
    return total


def step_flops(cfg: Dict, batch: int, frames: int) -> float:
    return passes(frame_step_flops(cfg), True, True) * batch * frames


def window_flops(cfg: Dict, traffic, run: Dict) -> float:
    """Model FLOPs of a closed-loop window: its steps at the traffic's
    batch and clip length."""
    return step_flops(cfg, traffic.batch, traffic.clip_shape[0]) * run[
        "steps"]
