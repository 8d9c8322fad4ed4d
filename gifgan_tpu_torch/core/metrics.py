"""Run metrics (gifgan_tpu/core/metrics.py): one JSON line per logged step
in `<run_dir>/<name>_metrics.jsonl`, mirrored to stdout, with steps/sec
between logs.

Tensor values are read with one device-to-host copy per `log` call (a
stack of the scalars), not one synchronisation per metric.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    def __init__(self, run_dir: Optional[str] = None, name: str = "train",
                 print_every: int = 1):
        self.run_dir = run_dir
        self.print_every = print_every
        self._file = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._file = open(os.path.join(run_dir, f"{name}_metrics.jsonl"),
                              "a", buffering=1)
        self._t0 = time.time()
        self._last_time = self._t0
        self._last_step = 0

    def log(self, step: int, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Write one record; returns it (tensors as floats)."""
        scalars = dict(metrics)
        tensors = [k for k, v in metrics.items()
                   if isinstance(v, torch.Tensor)]
        if tensors:
            values = torch.stack([metrics[k].detach().reshape(()).float()
                                  for k in tensors]).tolist()
            scalars.update(zip(tensors, values))
        for k, v in scalars.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                scalars[k] = float(v)
        now = time.time()
        dt, dsteps = now - self._last_time, step - self._last_step
        if dsteps > 0 and dt > 0:
            scalars["steps_per_sec"] = dsteps / dt
        scalars["step"] = step
        scalars["wall_time"] = now - self._t0
        self._last_time, self._last_step = now, step
        if self._file:
            self._file.write(json.dumps(scalars) + "\n")
        if self.print_every and step % self.print_every == 0:
            parts = [f"step {step}"] + [
                f"{k}: {v:.4f}" for k, v in scalars.items()
                if isinstance(v, float) and k not in ("step", "wall_time")]
            print("  ".join(parts), flush=True)
        return scalars

    def close(self):
        if self._file:
            self._file.close()
