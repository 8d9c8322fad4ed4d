"""Data parallelism over torch.distributed (gifgan_tpu/parallel/): the
mesh's data axis (dp.py), ZeRO-3 sharding of the train state (fsdp.py),
process setup (distributed.py) and the collectives of a mesh step
(collectives.py). Tensor and sequence parallelism (the JAX package's tp.py
and sp.py) are not ported."""

from gifgan_tpu_torch.parallel.dp import make_sharded_step, shard_train_state

__all__ = ["shard_train_state", "make_sharded_step"]
