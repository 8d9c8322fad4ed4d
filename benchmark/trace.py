"""One profiler capture of whole steady steps, and what the per-layer
metrics read from it.

The categories are a frozen copy of gifgan_tpu_torch/core/profile.py
(`KERNELS`, `CATEGORIES`, `category`), so that a later change of the
program cannot move the yardstick. The reduction reads the capture's own
Chrome trace: device rows (kernels, copies, sets) inside the window that
the benchmark's "bench.step" ranges span, their union as busy time, and
each idle gap named by the innermost host event that covers its middle.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import tempfile
from typing import Dict, List

KERNELS = {"gather_rows_scaled": ("gather_rows_scaled",),
           "resize_normalize": ("resize_rows",),
           "haar_stages": ("haar_stages",),
           "lk_refine": ("lk_refine",)}
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
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
STEP = "bench.step"
TOP = 10
NAME_CHARS = 64


def category(name: str) -> str:
    """A hand-written kernel's own name, else the first of CATEGORIES that
    matches, else "other"."""
    low = name.lower()
    for cat, keys in (*KERNELS.items(), *CATEGORIES):
        if any(k in low for k in keys):
            return cat
    return "other"


def capture(cell, steps: int) -> Dict:
    """Profile `steps` calls of the cell, each with its scalar fetch, in
    "bench.step" ranges; the reduction of the capture. The cell's
    `history` keeps the calls' inputs for its `work()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    cell.history = []
    with profile(activities=acts) as prof:
        for _ in range(steps):
            with record_function(STEP):
                float(cell.call())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json.gz")
        prof.export_chrome_trace(path)
        with gzip.open(path) as f:
            events = json.load(f)["traceEvents"]
    out = reduce(events)
    out["work"] = cell.work()
    cell.history = None
    return out


def _union(spans: List[tuple]) -> List[list]:
    merged: List[list] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_at(t: float, host: List[tuple], starts: List[float],
             look: int = 256) -> str:
    """The innermost host event that covers time t: of the last `look`
    events to start by t, the latest that has not ended."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - look, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return STEP


def reduce(events: List[Dict]) -> Dict:
    """The capture's numbers, in seconds: {"window_s", "busy_s", "steps",
    "kernel_rows", "by_category_s", "device_ops", "idle_gaps"}."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in timed if e.get("name") == STEP
             and e.get("cat") == "user_annotation"]    # not the device's copy
    if not steps:
        raise ValueError("the capture holds no step")
    lo = min(float(e["ts"]) for e in steps)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    rows = [e for e in timed if e.get("cat") in DEVICE_CATS
            and lo <= float(e["ts"]) < hi]
    busy = _union([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                        hi)) for e in rows])
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for e in rows:
        s = float(e["dur"]) * 1e-6
        cat = category(e["name"])
        by_cat[cat] = by_cat.get(cat, 0.0) + s
        name = cat if cat in KERNELS else e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + s
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in timed
                   if e.get("cat") in HOST_CATS and e.get("name") != STEP))
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for span in busy for x in span] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = _host_at((a + b) / 2, host, starts)[:NAME_CHARS]
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "steps": len(steps),
            "kernel_rows": sum(1 for e in rows if e.get("cat") == "kernel"),
            "by_category_s": by_cat,
            "kernel_s": {k: v for k, v in by_name.items() if k in KERNELS},
            "device_ops": top(by_name),
            "idle_gaps": top(gaps)}
