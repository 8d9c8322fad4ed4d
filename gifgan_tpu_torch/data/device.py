"""Device-resident corpus sampling (gifgan_tpu/data/device.py DeviceCorpus).

The uint8 corpus is uploaded once as an (N, D) tensor and sampled on the
device, so the training loop ships only clip ids. Methods:

- "kernel": the hand-written CUDA gather K1 (kernels/gather.py), which
  widens and scales to [-1, 1] in one pass — the counterpart of the JAX
  package's "pallas". On a CPU corpus its wrapper runs the plain version.
- "take": index_select of the clamped rows, then the scale in PyTorch (the
  plain formulation; it also serves out_range="unit").

Both clamp out-of-range ids to [0, N-1], as the kernel does. The JAX
package's "matmul" method and "frames" layout are workarounds for the TPU's
slow gathers and are not ported; nor is the TPU's padding of D to 4096.

With a mesh (core/mesh.py) the corpus is uploaded whole to every rank's
card, as the JAX package replicates it, and `sample(idx)` takes the global
ids and gathers this rank's block of the last idx axis ((B,) ids -> its
rows of the batch, (K, B) -> its columns), the counterpart of the JAX
sample's output sharded over `data` along that axis. `sample_fn` and
`fold_sample_fn` gather the ids they are given: a mesh step hands them the
rank's ids (parallel/dp.py make_sharded_step). In a sequence-parallel step
(parallel/sp.py make_sp_step(folded=False)) `fold_sample_fn` gathers only
this rank's seq block of its clips' time-folded frames: the corpus viewed
as (N*T, frame) rows, one gather of those rows (K1 once a step on every
rank; the ranks that share a data index share ids).
"""

from __future__ import annotations

import numpy as np
import torch

from gifgan_tpu_torch import resolve_device
from gifgan_tpu_torch.kernels.gather import gather_rows_scaled
from gifgan_tpu_torch.parallel import collectives


class DeviceCorpus:
    """Upload an (N, ...) uint8 corpus once; sample batches on the device.

    sample(idx) returns float32 of shape idx.shape + item_shape, in [-1, 1]
    (out_range="tanh") or [0, 1] ("unit", method "take" only: the kernel
    bakes the [-1, 1] scale)."""

    def __init__(self, corpus_u8: np.ndarray, method: str = "kernel",
                 out_range: str = "tanh", layout: str = "clips",
                 device=None, mesh=None):
        if corpus_u8.dtype != np.uint8:
            raise ValueError(f"corpus must be uint8, got {corpus_u8.dtype}")
        if method not in ("kernel", "take"):
            raise ValueError(f"unknown method {method!r}")
        if layout != "clips":
            raise ValueError(f"layout must be 'clips', got {layout!r}")
        if out_range not in ("tanh", "unit"):
            raise ValueError(f"out_range must be 'tanh' ([-1,1]) or "
                             f"'unit' ([0,1]), got {out_range!r}")
        if out_range == "unit" and method == "kernel":
            raise ValueError("the gather kernel bakes the [-1,1] scale; use "
                             "method='take' for out_range='unit'")
        self.method, self.out_range, self.layout = method, out_range, layout
        self.mesh = mesh
        self.device = resolve_device(device)
        self.item_shape = tuple(corpus_u8.shape[1:])
        self.n = corpus_u8.shape[0]
        d = int(np.prod(self.item_shape))
        self._data = torch.from_numpy(np.ascontiguousarray(
            corpus_u8.reshape(self.n, d))).to(self.device)
        self.sample_fn = self._sample
        self.fold_sample_fn = self._fold_sample

    @property
    def data(self) -> torch.Tensor:
        """The resident (N, D) uint8 corpus, for `sample_fn` and
        `fold_sample_fn` inside a caller's loop."""
        return self._data

    def _rows(self, data: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
        """(M, D) float32 of the clamped rows, scaled."""
        if self.method == "kernel":
            return gather_rows_scaled(data, flat)
        rows = torch.index_select(data, 0,
                                  flat.long().clamp(0, data.shape[0] - 1))
        g = rows.to(torch.float32)
        return g / 255.0 if self.out_range == "unit" else g / 127.5 - 1.0

    def _sample(self, data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(data, idx of any shape) -> idx.shape + item_shape float32."""
        return self._rows(data, idx.reshape(-1)).reshape(
            tuple(idx.shape) + self.item_shape)

    def _fold_sample(self, data: torch.Tensor, idx: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
        """(data, (B,) idx) -> (B*T, *frame_shape), time folded into batch
        (train_chunk_ids' layout; a reshape of the contiguous rows, no
        copy). out_dtype: None keeps float32; else one rounding of the f32
        values. In a sequence-parallel step: this rank's seq block of the
        (B*T) rows."""
        seq = collectives.seq_group()
        if seq is None:
            g = self._rows(data, idx.reshape(-1))
        else:
            t = self.item_shape[0]
            r = seq.rows(torch.arange(idx.numel() * t, device=idx.device))
            clips = idx.reshape(-1).long().clamp(0, self.n - 1)
            g = self._rows(data.view(self.n * t, -1), clips[r // t] * t
                           + r % t)
        g = g.reshape((-1,) + self.item_shape[1:])
        return g.to(out_dtype) if out_dtype is not None else g

    def sample(self, idx) -> torch.Tensor:
        """idx: integer array or tensor of corpus ids, any shape. With a
        mesh: this rank's block of the last idx axis, which the mesh's
        data axis must divide."""
        idx = torch.as_tensor(np.asarray(idx) if not isinstance(
            idx, torch.Tensor) else idx).to(self.device, torch.int64)
        if self.mesh is not None:
            n = self.mesh.shape["data"]
            if idx.shape[-1] % n:
                raise ValueError(
                    f"the mesh data axis ({n}) must divide the id batch "
                    f"({idx.shape[-1]})")
            idx = self.mesh.data_group.rows(idx, idx.ndim - 1)
        return self._sample(self._data, idx)
