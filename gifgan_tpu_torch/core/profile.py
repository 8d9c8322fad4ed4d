"""Profiling and step timing (gifgan_tpu/core/profile.py).

  - `trace(...)`: a context manager around torch.profiler that writes a
    TensorBoard-loadable `*.pt.trace.json.gz` of CPU and (when CUDA is
    available) device activity,
  - `sync(...)` and `StepTimes`: per-step wall timing that ends in a fetch
    of one scalar, so the host clock covers the device's work,
  - `estimate_epoch_hours`: the reference's time_script.py extrapolation,
  - `summarize_trace(...)`: device time by operation and category from the
    newest capture, with the JAX version's keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable

import numpy as np

# The port's hand-written kernels, each listed under its own name, by the
# kernel symbols of gifgan_tpu_torch/csrc/ its trace rows carry.
KERNELS = {"gather_rows_scaled": ("gather_rows_scaled",),
           "resize_normalize": ("resize_rows",),
           "haar_stages": ("haar_stages",),
           "lk_refine": ("lk_refine",)}
# The JAX version's HLO categories where PyTorch has a counterpart, plus
# "elementwise" for PyTorch's unfused pointwise kernels; a name takes the
# first category that one of its keys (lower case) is part of. Device rows
# are kernel names (cuDNN's conv kernels also say gemm, so convolution goes
# first; a dtype cast runs as an elementwise kernel over a copy functor, so
# copy goes before elementwise); CPU rows are aten op names.
CATEGORIES = (
    ("convolution", ("convolution", "conv2d", "conv3d", "conv_",
                     "convolve", "fprop", "dgrad", "wgrad")),
    ("dot", ("gemm", "gemv", "xmma", "cutlass", "cublas", "aten::mm",
             "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
             "aten::linear", "aten::_int_mm")),
    ("copy", ("copy", "memcpy", "nchwtonhwc", "nhwctonchw", "aten::to",
              "aten::cat", "aten::clone", "aten::contiguous")),
    ("reduce", ("reduce", "welford", "aten::sum", "aten::mean",
                "aten::var", "aten::std", "aten::amax", "aten::norm")),
    ("gather", ("gather", "index", "embedding", "aten::take")),
    ("elementwise", ("elementwise", "foreach", "multi_tensor_apply",
                     "aten::add", "aten::sub", "aten::mul", "aten::div",
                     "aten::tanh", "aten::sigmoid", "aten::relu",
                     "aten::leaky_relu", "aten::exp", "aten::log",
                     "aten::neg", "aten::sqrt", "aten::rsqrt",
                     "aten::clamp", "aten::where", "aten::pow",
                     "aten::abs", "aten::lerp", "aten::fill_",
                     "aten::zero_")),
)
# trace rows that ran on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: `with profile.trace("runs/x/trace") as p: step(...)`.
    View with TensorBoard; `p` is the torch.profiler.profile object (its
    `key_averages()` reads the same capture). The device is synchronized
    before the capture stops, so it holds every kernel the block launched."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities, on_trace_ready=
                 tensorboard_trace_handler(log_dir, use_gzip=True)) as p:
        try:
            yield p
        finally:
            if cuda:
                torch.cuda.synchronize()


def _leaves(tree):
    """The leaves of nested dicts (keys sorted, as jax.tree_util orders
    them), lists, tuples and NamedTuples, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def sync(tree) -> None:
    """Wait for the device by fetching one scalar of the first tensor leaf
    (nothing to do on an empty tree)."""
    import torch

    leaves = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    if leaves and leaves[0].numel():
        leaves[0].reshape(-1)[:1].cpu()


class StepTimes:
    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, result_getter=None):
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            sync(out["result"])
        self.times.append(time.perf_counter() - t0)

    def summary(self, skip: int = 1) -> Dict[str, float]:
        ts = np.asarray(self.times[skip:] or self.times)
        return {"mean_s": float(ts.mean()),
                "p50_s": float(np.percentile(ts, 50)),
                "steps_per_sec": float(1.0 / ts.mean()),
                "n": int(len(ts))}


def estimate_epoch_hours(step_seconds: Iterable[float],
                         batches_per_epoch: int) -> float:
    """Average step time -> epoch hours (reference time_script.py:14-18,
    which assumed 3165 batches/epoch)."""
    ts = np.asarray(list(step_seconds), np.float64)
    return float(ts.mean() * batches_per_epoch / 3600.0)


def category(name: str) -> str:
    """The category of a trace row's name: a hand-written kernel's own
    name, else the first of CATEGORIES that matches, else "other"."""
    low = name.lower()
    for cat, keys in (*KERNELS.items(), *CATEGORIES):
        if any(k in low for k in keys):
            return cat
    return "other"


def _outermost(events):
    """The events that no other event of the list on the same thread
    encloses (a container op and the ops it calls are not both counted)."""
    by_thread: Dict = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    keep = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        end = -float("inf")          # end of the open outermost event
        for e in evs:
            if float(e["ts"]) >= end:
                keep.append(e)
                end = float(e["ts"]) + float(e["dur"])
    return keep


def newest_events(log_dir: str) -> list:
    """The trace events of the newest `*.trace.json.gz` under `log_dir`."""
    import glob
    import gzip
    import json

    paths = sorted(glob.glob(os.path.join(
        log_dir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    with gzip.open(paths[-1]) as f:
        return json.load(f)["traceEvents"]


def summarize_trace(log_dir: str, top: int = 25) -> Dict:
    """Aggregate operation time from the newest capture under `log_dir`
    (the `*.trace.json.gz` every `trace` writes).

    Returns {"total_us", "ops": [(name, us, pct), ...], "op_details",
    "by_category": {category: us}}. The rows counted are the device's
    (kernels, memcpys, memsets), so `total_us` is device-execution time;
    a trace without device rows (a CPU run) counts its outermost aten ops
    instead. A hand-written kernel's rows go under its own name (KERNELS).
    `tflops`/`gbps` are 0 where a row carries no flop or byte counts, and
    `source` is "" (a kernel row names no Python source line)."""
    timed = [e for e in newest_events(log_dir)
             if e.get("ph") == "X" and "dur" in e]
    rows = [e for e in timed if e.get("cat") in DEVICE_CATS]
    if not rows:
        rows = _outermost([e for e in timed if e.get("cat") == "cpu_op"])

    durs: Dict[str, Dict] = {}
    for e in rows:
        name = e.get("name", "")
        cat = category(name)
        if cat in KERNELS:
            name = cat
        args = e.get("args", {})
        rec = durs.setdefault(name, {"us": 0.0, "flops": 0.0, "bytes": 0.0,
                                     "category": cat})
        rec["us"] += float(e["dur"])
        rec["flops"] += float(args.get("flops", 0) or 0)
        rec["bytes"] += float(args.get("bytes", 0) or 0)

    total = sum(r["us"] for r in durs.values())
    by_cat: Dict[str, float] = {}
    for r in durs.values():
        by_cat[r["category"]] = by_cat.get(r["category"], 0.0) + r["us"]
    ops = sorted(durs.items(), key=lambda kv: -kv[1]["us"])[:top]
    return {"total_us": total,
            "ops": [(n, r["us"], 100.0 * r["us"] / total if total else 0.0)
                    for n, r in ops],
            "op_details": [
                {"name": n, "us": r["us"],
                 "pct": 100.0 * r["us"] / total if total else 0.0,
                 "category": r["category"],
                 "tflops": (r["flops"] / r["us"] / 1e6
                            if r["us"] and r["flops"] else 0.0),
                 "gbps": (r["bytes"] / r["us"] / 1e3
                          if r["us"] and r["bytes"] else 0.0),
                 "source": ""}
                for n, r in ops],
            "by_category": dict(sorted(by_cat.items(),
                                       key=lambda kv: -kv[1]))}
