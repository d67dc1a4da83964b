"""The sharded fit: a lattice (any p) cut along axis 0 into slabs
over the ranks of a torch.distributed process group (NCCL on the card,
gloo on the CPU), every collective written out.  Counterpart of
``multivartv_tpu/parallel``."""

from multivartv_tpu_torch.parallel.sharding import (RowGroup, RowSlab, make_device_mesh,
                                                    shard_problem, shard_state)
from multivartv_tpu_torch.parallel.fit import mvtv_sharded

__all__ = ["RowGroup", "RowSlab", "make_device_mesh", "shard_problem", "shard_state",
           "mvtv_sharded"]
