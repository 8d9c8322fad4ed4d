"""The mesh's parallelism over torch.distributed (gifgan_tpu/parallel/):
the data axis (dp.py), ZeRO-3 sharding of the train state (fsdp.py),
tensor parallelism over the model axis (tp.py), sequence parallelism over
the seq axis (sp.py), process setup (distributed.py) and the collectives
of a mesh step (collectives.py)."""

from gifgan_tpu_torch.parallel.dp import make_sharded_step, shard_train_state
from gifgan_tpu_torch.parallel.sp import make_sp_step, shard_vid_batch
from gifgan_tpu_torch.parallel.tp import (place_vid_state_tp,
                                          vid_state_tp_shardings)

__all__ = ["shard_train_state", "make_sharded_step", "make_sp_step",
           "shard_vid_batch", "place_vid_state_tp", "vid_state_tp_shardings"]
