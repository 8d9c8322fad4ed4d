"""Run one benchmark cell of gifgan_tpu_torch once, on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Everything about a cell is found by name:
BENCHMARK.json gives a cell its configuration
(benchmark/configs/<config>.json, its plain reference
benchmark/reference/<config>.py and its FLOP count
benchmark/flops/<config>.py) and its traffic mix
(benchmark/traffic/<traffic>.json); benchmark/workloads/<cell>.json names
the program entry that drives it (benchmark/entries/<entry>.py), its
correctness check (benchmark/checks/<check>.py) with the limits of that
check, and its warm-up and traced steps; each metric of BENCHMARK.json is
read by benchmark/metrics/<metric>.py.

A traffic file names its generator (benchmark/traffic/<generator>.py),
and a workload file its measured window (benchmark/windows/<window>.py).

A run: make the weights and the traffic from the seed on the card, build
the program's state, drive its first steps through the window's own call
(the check's readings), warm up, then measure for --seconds as the
window says (a closed loop: one step after another, each followed by a
fetch of one scalar). With --trace 1, one profiler capture of whole
steps follows. Then the program is freed, the
reference checks the first steps, and one JSON line is printed last:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}; the checks' numbers beside their limits are also the last
lines on standard error. Without a card, or with fewer cards than the
cell asks for, or with JAX loaded, it exits non-zero and prints no
result.
"""

import os
import sys
import time

T0 = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches of the program and of torch: fixed paths inside
# the checkout, so that only a checkout's first run builds
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
CACHE_ROOT = os.path.join(ROOT, ".bench_cache")
# the Python bytecode of the program and its libraries, there too: where
# the environment writes none (PYTHONDONTWRITEBYTECODE), every process
# would compile torch's modules anew, some 6 s of set-up on the card's host
if __name__ == "__main__":
    sys.pycache_prefix = os.path.join(CACHE_ROOT, "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from typing import Dict, Optional  # noqa: E402
FORBIDDEN = ("jax", "jaxlib", "flax", "gifgan_tpu")


def _json(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots), once
    a process: as `benchmark.<kind>.<name>` with its dots made `_`."""
    modname = f"benchmark.{kind}.{name.replace('.', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str) -> Dict:
    """The cell's entry of BENCHMARK.json with its workload file,
    configuration and traffic, and the metrics that this cell reports,
    each with its unit."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    layer = {m["name"]: m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in e2e
                              else [])}
    return {"name": name, "chips": cell["chips"],
            "workload": _json("workloads", f"{name}.json"),
            "config": _json("configs", f"{cell['config']}.json"),
            "config_name": cell["config"],
            "traffic": _json("traffic", f"{cell['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_inputs(spec: Dict, seed: int, device):
    """The cell's traffic and weights, made from the seed on `device` by
    the traffic's generator and the configuration's reference."""
    from benchmark import inputs

    generator = load("traffic", spec["traffic"]["generator"])
    reference = load("reference", spec["config_name"])
    g_weights, *g_traffic = inputs.generators(
        seed, 1 + generator.GENERATORS, device)
    traffic = generator.Traffic(spec["traffic"], g_traffic, device)
    weights = inputs.make_weights(reference.param_specs(spec["config"]),
                                  g_weights, device)
    return traffic, weights


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, phases: Optional[list] = None) -> Dict:
    """One run of the cell on `device`; the result line as a dict, with
    the set-up's phases in "setup_phases_s" (after `phases`, the
    (name, end time) of what the caller did since t0)."""
    import torch

    from benchmark import trace as tracing
    from benchmark.peaks import H100

    wl, cfg = spec["workload"], spec["config"]
    entry = load("entries", wl["entry"])
    reference = load("reference", spec["config_name"])
    check = load("checks", wl["check"])
    window = load("windows", wl["window"])
    flops = load("flops", spec["config_name"])
    cuda = torch.device(device).type == "cuda"
    phases = list(phases or []) + [("modules", time.perf_counter())]

    traffic, weights = cell_inputs(spec, seed, device)
    float(weights[next(iter(weights))].sum())    # the device has made them
    phases.append(("inputs", time.perf_counter()))
    cell = entry.Cell(cfg, traffic, weights, device)
    phases.append(("program", time.perf_counter()))
    readings = check.during_setup(cell, traffic)
    phases.append(("checked_steps", time.perf_counter()))
    for _ in range(wl["warm_steps"]):
        float(cell.call())
    phases.append(("warm_steps", time.perf_counter()))

    run = window.measure(cell, seconds)
    run.update(setup_s=phases[-1][1] - t0,
               flops=flops.window_flops(cfg, traffic, run),
               peak_flops_per_s=H100[cfg["peak"]], trace=None)
    if trace:
        run["trace"] = tracing.capture(cell, wl["trace_steps"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    numbers = check.after_window(cell, traffic, weights, reference, cfg,
                                 readings, wl)
    # the numbers that the workload file gives a limit are compared
    checks = {}
    for k, limit in wl["limits"].items():
        v = numbers.get(k, math.nan)
        checks[k] = {"value": v if math.isfinite(v) else None,
                     "limit": limit}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]).values():
        value = load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run["steps"],
              "failed": run["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device,
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else device),
                         "count": spec["chips"], "memory_peak_bytes": peak}}
    if trace:
        tr = run["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    starts = [t0] + [t for _, t in phases]
    result["setup_phases_s"] = {name: t - a for (name, t), a in
                                zip(phases, starts)}
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(CACHE_ROOT, sub)
    spec = cell_spec(args.workload)

    import torch

    phases = [("torch_import", time.perf_counter())]
    chips = spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    phases.append(("cuda_context", time.perf_counter()))
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda", phases=phases)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k}={v:.3f}s" for k, v in
                               result.pop("setup_phases_s").items()),
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} value={c['value']} limit={c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
