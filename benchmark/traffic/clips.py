"""The generator of clip traffic for training cells: a resident uint8
corpus and the ids (and z) of each step, from the run's seed.

Keys of a traffic file with "generator": "clips": `corpus_clips` clips
of `clip_frames` frames of `frame` (h, w, c), uniform bytes; each step
takes the next `batch_size` ids of an epoch permutation (a new
permutation each epoch, full batches only) and, when `z_dim` > 0, a z
uniform in [-1, 1].
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

Tensor = torch.Tensor
GENERATORS = 3          # the corpus's, the ids' and the z's


class Traffic:
    """`gens`: GENERATORS generators on `device`."""

    def __init__(self, spec: Dict, gens: List[torch.Generator], device):
        self.batch = int(spec["batch_size"])
        self.z_dim = int(spec.get("z_dim", 0))
        self.n = int(spec["corpus_clips"])
        self.clip_shape = (int(spec["clip_frames"]),
                           *(int(v) for v in spec["frame"]))
        if self.n < self.batch:
            raise ValueError(f"{self.n} clips < batch {self.batch}")
        g_corpus, self._g_ids, self._g_z = gens
        self.corpus = torch.randint(
            0, 256, (self.n, int(np.prod(self.clip_shape))),
            dtype=torch.uint8, generator=g_corpus, device=device)
        self.device = device
        self._perm: Optional[Tensor] = None
        self._pos = 0
        self.recorded: List[Dict[str, Tensor]] = []
        self.record = 0         # how many of the next steps to keep

    def host_corpus(self) -> np.ndarray:
        """The corpus as a (n, *clip_shape) host array, for a program that
        uploads its own copy. The traffic's copy stays on the host from
        then on, so the card holds the corpus once."""
        self.corpus = self.corpus.cpu()
        return self.corpus.numpy().reshape(self.n, *self.clip_shape)

    def device_corpus(self) -> Tensor:
        """The (n, clip bytes) corpus on the traffic's device."""
        return self.corpus.to(self.device)

    def next(self) -> Dict[str, Tensor]:
        """The next step's {"ids": (B,) int64[, "z": (B, z_dim) float32]},
        on the device."""
        per_epoch = self.n // self.batch
        if self._perm is None or self._pos == per_epoch:
            self._perm = torch.randperm(self.n, generator=self._g_ids,
                                        device=self.device)
            self._pos = 0
        b = self.batch
        step = {"ids": self._perm[self._pos * b:(self._pos + 1) * b]}
        self._pos += 1
        if self.z_dim:
            step["z"] = torch.empty((b, self.z_dim),
                                    device=self.device).uniform_(
                -1.0, 1.0, generator=self._g_z)
        if self.record:
            self.recorded.append({k: v.clone() for k, v in step.items()})
            self.record -= 1
        return step
