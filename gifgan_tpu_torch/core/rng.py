"""Random streams (gifgan_tpu/core/rng.py).

The JAX package splits threefry keys; torch cannot reproduce threefry, so
here a numpy SeedSequence fans one seed out into a stream of 63-bit seeds,
and each draw is a fresh torch.Generator seeded from it on a given device.
A whole run's z and noise therefore differ from the JAX package's for the
same seed; parity with it is held step by step, with z passed in.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device


class PRNGSequence:
    """An endless stream of torch.Generators on `device`.

    seed: an int, or a numpy SeedSequence (e.g. SeedSequence([seed, step])
    for a resumed run, so the stream does not replay the first run's)."""

    def __init__(self, seed: Union[int, np.random.SeedSequence],
                 device=None):
        self._rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def next_seed(self) -> int:
        return int(self._rng.integers(0, 2 ** 63 - 1))

    def __next__(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.next_seed())

    def next(self) -> torch.Generator:
        return next(self)


def uniform_z(gen: torch.Generator, shape, dtype=torch.float32
              ) -> torch.Tensor:
    """z ~ U[-1, 1) on the generator's device, the latent prior."""
    return torch.rand(shape, generator=gen, dtype=dtype,
                      device=gen.device) * 2.0 - 1.0
