"""Benchmark: VID_DCGAN G/D train steps/sec at the reference's flagship
shape, on the card (the measuring core of the repo-root bench.py).

    python -m gifgan_tpu_torch bench [--device D]
    python -m gifgan_tpu_torch.bench [--cpu-reference] [--device D]

Reference config (z_model.py:27-29,64-65; z_model_lib.py:70-76): vid_batch 64
-> inner image batch 1024 (64 clips x 16 frames) at 64x64x3, vid_z 120,
img_z 100, 1 D + 2 G updates per step (model.py:226-239), bfloat16
activations and K = 80 steps a `train/vid.py train_chunk` call (a Python
loop of eager steps here). The frames and z are made on the card from a
seeded torch.Generator: the 4 GB frames buffer never exists on the host.

Prints ONE JSON line: {"metric", "value", "unit", "compile_cache"}.
`compile_cache` is "none": eager PyTorch compiles no program.

Not ported, by design: the JAX bench's TPU compile-relay and
persistent-cache machinery, which has no counterpart in eager PyTorch (as
gifgan_tpu/core/cache.py has none): the parent watchdog and its retry loop
(`_watch_verdict`, `_run_child_attempt`, the stage deadlines,
`_write_postmortem`), the stage marks and cache probe (`_mark`,
`_install_cache_probe`), the cache snapshots and seed export
(`_flagship_cache_mtime`, `_snapshot_cache_baseline`,
`_seed_cache_export`) and the zero-input prewarm dispatch.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace

METRIC = "vid_dcgan_train_steps_per_sec_b64_64x64x16"


def _flagship(dtype="bfloat16"):
    from gifgan_tpu_torch.core.config import (DCGANConfig, TrainConfig,
                                              VidGANConfig)

    # packed_c3: phase-packed execution of the c=3 end layers. The env
    # override is for A/B measurement only.
    packed = os.environ.get("GIFGAN_PACKED_C3", "1") != "0"
    img = DCGANConfig(output_size=64, c_dim=3, z_dim=100,
                      compute_dtype=dtype, packed_c3=packed)
    cfg = VidGANConfig(z_input_size=120, z_output_size=100, vid_length=16,
                       image_gan=img, first_frame_loss_scalar=1.0,
                       compute_dtype=dtype)
    tcfg = TrainConfig(batch_size=64, disc_updates=1, gen_updates=2)
    return cfg, tcfg


def run_bench(steps: int = 3, warmup: int = 1, batch_size: int = None,
              chunk: int = 80, dtype: str = "bfloat16", device=None):
    """Steps/sec over `steps` calls of train_chunk (`chunk` steps each)
    after `warmup` calls, each synchronized by fetching one scalar of
    d_loss. `device=None` is the card (raises without CUDA)."""
    import torch

    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.core.rng import PRNGSequence
    from gifgan_tpu_torch.train import vid as vid_train

    device = resolve_device(device)
    cfg, tcfg = _flagship(dtype)
    if batch_size:
        tcfg = replace(tcfg, batch_size=batch_size)
    b, img = tcfg.batch_size, cfg.image_gan

    rngs = PRNGSequence(0, device)
    ts = vid_train.init_train_state(
        torch.Generator().manual_seed(rngs.next_seed()), cfg, tcfg,
        device=device)
    g = torch.Generator(device=device).manual_seed(7)
    frames = torch.randn(
        (chunk, b * cfg.vid_length, img.output_size, img.output_size,
         img.c_dim), generator=g, device=device)
    z = torch.rand((chunk, b, cfg.z_input_size), generator=g,
                   device=device) * 2.0 - 1.0

    for _ in range(warmup):
        ts, metrics = vid_train.train_chunk(ts, frames, z, next(rngs), cfg,
                                            tcfg)
        float(metrics["d_loss"][-1])

    t0 = time.perf_counter()
    for _ in range(steps):
        ts, metrics = vid_train.train_chunk(ts, frames, z, next(rngs), cfg,
                                            tcfg)
        float(metrics["d_loss"][-1])
    dt = time.perf_counter() - t0
    return steps * chunk / dt


def run_cpu_reference(steps: int = 3):
    """The same math, float32, one step a call, on the CPU (by request)."""
    return run_bench(steps=steps, warmup=1, chunk=1, dtype="float32",
                     device="cpu")


def _emit(value):
    print(json.dumps({
        "metric": METRIC,
        "value": round(value, 4),
        "unit": "steps/sec",
        "compile_cache": "none",
    }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gifgan_tpu_torch.bench")
    ap.add_argument("--cpu-reference", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        val = run_cpu_reference()
        print(json.dumps({"cpu_reference_steps_per_sec": val}))
        return
    _emit(run_bench(device=args.device))


if __name__ == "__main__":
    main()
