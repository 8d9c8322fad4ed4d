"""Faults planted in the program underneath a run, for the tests and the
calibration that show the correctness check failing them. Never used by
benchmark/run.py.

- unchanged: each training step returns the state it was given;
- half_batch: each training step sees the first half of its batch only,
  its losses the means over that half;
- wrong_range: the corpus gather hands its rows back in [0, 1], not in
  tanh's [-1, 1];
- g_backward: a wrong backward pass in the G's path alone, every forward
  value as it was: the frozen image D's leaky ReLUs (the tap) pass the
  gradient of a negative input at slope 1, not 0.2.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "wrong_range", "g_backward")


class _SlopeOneBackward(torch.autograd.Function):
    """lrelu(x) forward, the identity's gradient backward."""

    @staticmethod
    def forward(ctx, x, leak):
        return torch.maximum(x, leak * x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Proxy:
    """A module as one caller sees it, with some names replaced."""

    def __init__(self, module, **names):
        self._module, self._names = module, names

    def __getattr__(self, name):
        return self._names.get(name, getattr(self._module, name))


@contextlib.contextmanager
def planted(name: str):
    """Plant the named fault in the program for the duration of the
    block."""
    from gifgan_tpu_torch.data.device import DeviceCorpus
    from gifgan_tpu_torch.models import dcgan
    from gifgan_tpu_torch.train import vid

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    step, rows, nn = vid.train_step, DeviceCorpus._rows, dcgan.nn

    def unchanged(ts, *args, **kw):
        return ts, step(ts, *args, **kw)[1]

    def half_batch(ts, frames, z, *args, **kw):
        return step(ts, frames[: frames.shape[0] // 2],
                    z[: z.shape[0] // 2], *args, **kw)

    def unit_range(self, data, flat):
        return (rows(self, data, flat) + 1.0) / 2.0

    try:
        if name == "unchanged":
            vid.train_step = unchanged
        elif name == "half_batch":
            vid.train_step = half_batch
        elif name == "wrong_range":
            DeviceCorpus._rows = unit_range
        else:
            dcgan.nn = _Proxy(nn, lrelu=lambda x, leak=0.2:
                              _SlopeOneBackward.apply(x, leak))
        yield
    finally:
        vid.train_step, DeviceCorpus._rows, dcgan.nn = step, rows, nn
