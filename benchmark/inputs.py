"""What the benchmark makes from --seed and hands to the program and to
the reference alike: the generators of a run and the weights. The
traffic's generator (benchmark/traffic/<generator>.py) makes the rest.

Everything is drawn on the device from torch generators seeded from the
run's seed, in a few large calls, so the same seed gives the same inputs
and set-up moves no bulk data from the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

Tensor = torch.Tensor
STD = 0.02          # the init std of every weight of both configurations


def generators(seed: int, n: int, device) -> List[torch.Generator]:
    """`n` independent generators on `device` from one run seed (any
    non-negative integer, 64-bit ones too)."""
    words = np.random.SeedSequence(seed).generate_state(2 * n, np.uint32)
    return [torch.Generator(device=device).manual_seed(
        int(words[2 * i]) << 32 | int(words[2 * i + 1])) for i in range(n)]


def make_weights(specs: Dict[str, tuple], gen: torch.Generator,
                 device) -> Dict[str, Tensor]:
    """float32 leaves for {key: (shape, init)}: one draw for all the
    "normal" leaves, one for all the "trunc" leaves (normal cut at 2 std),
    then views of each block."""
    out: Dict[str, Tensor] = {}
    for init in ("normal", "trunc"):
        keys = sorted(k for k, (_, i) in specs.items() if i == init)
        sizes = [int(np.prod(specs[k][0])) for k in keys]
        flat = torch.empty(sum(sizes), device=device)
        if init == "normal":
            flat.normal_(0.0, STD, generator=gen)
        else:
            torch.nn.init.trunc_normal_(flat, 0.0, STD, -2 * STD, 2 * STD,
                                        generator=gen)
        for k, part in zip(keys, flat.split(sizes)):
            out[k] = part.view(specs[k][0])
    for k, (shape, init) in specs.items():
        if init in ("zeros", "ones"):
            out[k] = (torch.zeros if init == "zeros" else torch.ones)(
                shape, device=device)
        elif init not in ("normal", "trunc"):
            raise ValueError(f"unknown init {init!r} of {k}")
    return out

