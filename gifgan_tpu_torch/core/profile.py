"""Profiling and step timing (gifgan_tpu/core/profile.py).

  - `trace(...)`: a context manager around torch.profiler that writes a
    TensorBoard-loadable `*.pt.trace.json.gz` of CPU and (when CUDA is
    available) device activity,
  - `sync(...)` and `StepTimes`: per-step wall timing that ends in a fetch
    of one scalar, so the host clock covers the device's work,
  - `estimate_epoch_hours`: the reference's time_script.py extrapolation,
  - `summarize_trace(...)`: device time by operation and category from the
    newest capture, with the JAX version's keys,
  - `span(...)` and `span_summary()`: named spans inside the program,
    recorded only while a torch.profiler session records, each timed on
    the device's clock and shown in the capture as a `user_annotation`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

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
    before the capture stops, so it holds every kernel the block launched.
    Its spans (`span`) start a new list."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    _SPANS.live = False
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


# ---------------------------------------------------------------------------
# spans inside the program
# ---------------------------------------------------------------------------

def _instant(cuda: bool):
    """Now, on the clock of the span's work: a CUDA event recorded on the
    current stream, else the host's perf_counter_ns."""
    if not cuda:
        return time.perf_counter_ns()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _seconds(start, end) -> float:
    if isinstance(start, int):
        return (end - start) * 1e-9
    return start.elapsed_time(end) * 1e-3


class _Record:
    """One span: its name, the record it ran inside (None for a root),
    the ordinal of its root in the session, and its [start, end] on the
    host (perf_counter_ns) and on the device (`_instant`)."""

    __slots__ = ("name", "parent", "step", "cuda", "host", "device",
                 "bounds")

    def __init__(self, name: str, parent: Optional["_Record"], step: int,
                 cuda: bool):
        self.name, self.parent, self.step, self.cuda = (name, parent, step,
                                                        cuda)
        self.host, self.device = [0, 0], [None, None]
        # (net, device instant, host ns, its range) of each net whose
        # backward began inside this span, in the order they began
        self.bounds: List[tuple] = []

    def boundary(self, net: str) -> None:
        """A backward hook of `net` fired inside this span: the first of
        each net ends the range before it and opens `<net>.bwd`."""
        if any(b[0] == net for b in self.bounds):
            return
        if self.bounds:
            self.bounds[-1][3].__exit__(None, None, None)
        rng = torch.profiler.record_function(f"{net}.bwd")
        rng.__enter__()
        self.bounds.append((net, _instant(self.cuda), time.perf_counter_ns(),
                            rng))

    def tiles(self) -> List["_Record"]:
        """The `<net>.bwd` records that tile this span from its first
        boundary to its end."""
        out = []
        for i, (net, dev, host, _) in enumerate(self.bounds):
            nxt = self.bounds[i + 1] if i + 1 < len(self.bounds) else None
            tile = _Record(f"{net}.bwd", self, self.step, self.cuda)
            tile.device = [dev, nxt[1] if nxt else self.device[1]]
            tile.host = [host, nxt[2] if nxt else self.host[1]]
            out.append(tile)
        return out


class _Open(threading.local):
    """A thread's open spans, innermost last."""

    def __init__(self):
        self.stack: List[_Record] = []


class _Spans:
    """The records of the newest profiler session in which a span ran,
    and each thread's open spans. The profiler is one per process, so
    this is too (`_SPANS`)."""

    def __init__(self):
        self.records: List[_Record] = []
        self.steps = 0
        self.live = False       # a span has run in the session now recording
        self.open = _Open()

    def begin(self) -> None:
        """The first span of a session starts a new list."""
        if not self.live:
            self.live, self.records, self.steps = True, [], 0


_SPANS = _Spans()


class _Off:
    """The span when no profiler records: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mark(self, tensor) -> None:
        pass


_OFF = _Off()


class _Span:
    """A span while a profiler session records (see `span`)."""

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        _SPANS.begin()
        self.stack = _SPANS.open.stack
        parent = self.stack[-1] if self.stack else None
        if parent is None:
            _SPANS.steps += 1
            cuda = (self.device is not None
                    and torch.device(self.device).type == "cuda")
            rec = _Record(self.name, None, _SPANS.steps, cuda)
        else:
            rec = _Record(self.name, parent, parent.step, parent.cuda)
        self.rec = rec
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        rec.host[0] = time.perf_counter_ns()
        rec.device[0] = _instant(rec.cuda)
        self.stack.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.device[1] = _instant(rec.cuda)
        rec.host[1] = time.perf_counter_ns()
        self.stack.pop()
        if rec.bounds:
            rec.bounds[-1][3].__exit__(None, None, None)
        self.range.__exit__(*exc)
        _SPANS.records.append(rec)
        _SPANS.records.extend(rec.tiles())
        return False

    def mark(self, tensor: torch.Tensor) -> None:
        """`tensor` is this span's net's output: where its gradient
        arrives, that net's backward begins. A hook on it (only if it
        requires grad) marks that instant in the span open on this
        thread when it fires, and returns None: no gradient changes."""
        if not tensor.requires_grad:
            return
        stack, net = self.stack, self.name

        def hook(grad):
            if stack:
                stack[-1].boundary(net)

        tensor.register_hook(hook)


def span(name: str, device=None, inner: bool = False):
    """`with profile.span("vid.img_g") as s: ...`: a named span of the
    program, recorded only while a torch.profiler session records.

    Off (no profiler), one read of torch's profiler flag and a shared
    no-op: no record_function, no event, no hook, no allocation, no
    synchronisation. On, a `record_function(name)` range (a
    `user_annotation` in the capture), an instant at entry and at exit
    on the host and on the device (CUDA events on the current stream
    when `device`, or the enclosing span's, is a CUDA device; else the
    host clock), and a record in memory. A span with no span open on its
    thread is a root: the session counts its roots as its steps.

    `s.mark(t)` in a net's forward span makes the arrival of t's
    gradient a boundary: the first boundary of each net inside a later
    span (the backward pass) opens `<net>.bwd` there, which runs to the
    next net's boundary or to that span's end. What runs before the
    first boundary is that span's self time.

    An `inner` span records only inside an open span on its thread, so
    it never becomes a root: a layer's span, counted where a step's span
    encloses it and nowhere else."""
    if not _autograd_profiler._is_profiler_enabled:
        if _SPANS.live:
            _SPANS.live = False     # the session that recorded has ended
        return _OFF
    if inner and not _SPANS.open.stack:
        return _OFF
    return _Span(name, device)


def span_summary() -> Dict:
    """The spans of the newest profiler session in which any ran:
    {"steps": its roots, "spans": {name: {"count", "device_s", "host_s",
    "self_device_s"}}}, each time summed over the name's records;
    self_device_s leaves out the device time of each record's children.
    Synchronises the device once. A session that `trace` opens starts a
    new list; one opened elsewhere starts one if a span or this summary
    has seen the profiler off since the last session's spans."""
    records = list(_SPANS.records)
    if not _autograd_profiler._is_profiler_enabled:
        _SPANS.live = False
    if any(r.cuda for r in records):
        torch.cuda.synchronize()
    device = {id(r): _seconds(*r.device) for r in records}
    children: Dict[int, float] = {}
    for r in records:
        if r.parent is not None:
            key = id(r.parent)
            children[key] = children.get(key, 0.0) + device[id(r)]
    spans: Dict[str, Dict] = {}
    for r in records:
        s = spans.setdefault(r.name, {"count": 0, "device_s": 0.0,
                                      "host_s": 0.0, "self_device_s": 0.0})
        s["count"] += 1
        s["device_s"] += device[id(r)]
        s["host_s"] += (r.host[1] - r.host[0]) * 1e-9
        s["self_device_s"] += device[id(r)] - children.get(id(r), 0.0)
    return {"steps": _SPANS.steps, "spans": spans}
