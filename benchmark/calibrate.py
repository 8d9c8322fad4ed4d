"""Readings for setting a training cell's correctness limits, on the card
at the cell's own size: for each seed, the program's readings of its
first steps (benchmark/checks/train_steps.py), the plain reference's, the
control's (the reference in the configuration's `control` precision, in
the program's place), and the program's under each planted fault
(benchmark/faults.py), all in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 11 12 ... \
        --out calib_<cell>.json [--faults half_batch ...]

Writes every reading and prints each run's numbers as the check
computes them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from benchmark import faults
from benchmark.run import CACHE_ROOT, CACHES, cell_inputs, cell_spec, load


def readings(spec, seed: int, device, fault=None):
    """(program readings, weights, traffic) of one seeded set-up."""
    wl, cfg = spec["workload"], spec["config"]
    entry = load("entries", wl["entry"])
    check = load("checks", wl["check"])
    traffic, weights = cell_inputs(spec, seed, device)
    cell = entry.Cell(cfg, traffic, weights, device)
    if fault is None:
        prog = check.during_setup(cell, traffic)
    else:
        with faults.planted(fault):
            prog = check.during_setup(cell, traffic)
    cell.free()
    return prog, weights, traffic


def control_readings(spec, weights, corpus, traffic):
    """The control's readings: the plain reference computed in the
    configuration's `control` precision (a format of
    benchmark/reference/_plain.py round_to), in the program's place."""
    reference = load("reference", spec["config_name"])
    return reference.train_readings(weights, corpus, traffic.recorded,
                                    spec["config"], spec["config"]["control"])


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="run the control and the faults on this many of "
                         "the seeds (the first ones)")
    ap.add_argument("--faults", nargs="*", default=list(faults.FAULTS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(CACHE_ROOT, sub)
    spec = cell_spec(args.workload)
    cfg = spec["config"]
    check = load("checks", spec["workload"]["check"])
    reference = load("reference", spec["config_name"])
    nets = spec["workload"]["nets"]
    out = {"workload": args.workload, "control": cfg["control"],
           "device": (torch.cuda.get_device_name(0)
                      if args.device == "cuda" else args.device),
           "runs": []}
    for i, seed in enumerate(args.seeds):
        prog, weights, traffic = readings(spec, seed, args.device)
        corpus = traffic.device_corpus()
        ref = reference.train_readings(weights, corpus, traffic.recorded,
                                       cfg)
        run = {"seed": seed, "program": prog, "reference": ref}
        print(json.dumps({"seed": seed, "program":
                          check.numbers(prog, ref, nets)}), flush=True)
        if i < args.control_seeds:
            run["control"] = control_readings(spec, weights, corpus,
                                              traffic)
            nums = {"control": check.numbers(run["control"], ref, nets)}
            run["faults"] = {}
            for fault in args.faults:
                f_prog = readings(spec, seed, args.device, fault)[0]
                run["faults"][fault] = f_prog
                nums[fault] = check.numbers(f_prog, ref, nets)
            print(json.dumps({"seed": seed, **nums}), flush=True)
        out["runs"].append(run)
        del weights, traffic, corpus
        if args.device == "cuda":
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
