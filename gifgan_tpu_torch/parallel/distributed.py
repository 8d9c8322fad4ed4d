"""Process setup and process-level sharding helpers
(gifgan_tpu/parallel/distributed.py), over torch.distributed.

One process a rank, as torchrun starts them:

    torchrun --nproc-per-node N -m gifgan_tpu_torch train-vid \\
        --data-parallel N [--fsdp] ...

`initialize` reads torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR/MASTER_PORT) or explicit arguments, and is inert in a single
process, as the JAX function is.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _backend(device) -> str:
    """NCCL when every local rank has a card of its own; gloo on the CPU
    or when ranks share a card (NCCL refuses two ranks on one GPU)."""
    if (device is not None and torch.device(device).type == "cpu") \
            or not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> bool:
    """Join the process group; False (and nothing done) in a single
    process, True when a group is up (also when it already was).

    coordinator_address: "host:port" or an init_method URL
    ("tcp://localhost:29500"); default torchrun's MASTER_ADDR/MASTER_PORT.
    backend: as torch.distributed.init_process_group's; default NCCL on
    the card, gloo on the CPU or where ranks share a card. device: the
    caller's device ("cpu" picks gloo). With a card, a rank runs on
    cuda:LOCAL_RANK % device_count."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None and coordinator_address is None:
        if int(env.get("WORLD_SIZE", "1")) <= 1:
            return False
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize needs num_processes and process_id "
                             "with a coordinator_address")
        addr = coordinator_address or (
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}")
        init_method = addr if "://" in addr else f"tcp://{addr}"
    backend = backend or _backend(device)
    cpu = device is not None and torch.device(device).type == "cpu"
    if torch.cuda.is_available() and not cpu:
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def _index_count(process_index, process_count):
    i = process_index if process_index is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    n = process_count if process_count is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    return i, n


def process_shard(items: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> list:
    """Deterministically shard a work list (files, clips) across processes:
    process i takes items[i::n]."""
    i, n = _index_count(process_index, process_count)
    return list(items)[i::n]


def global_batch_to_local(global_batch: int,
                          process_count: Optional[int] = None) -> int:
    _, n = _index_count(None, process_count)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n
