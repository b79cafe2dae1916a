"""Several cards: process groups, the (bag, dp, tp) mesh, sharded weights
and sharded separation, on `torch.distributed` with one process per card.

The port of `demucs_tpu/parallel/`. The JAX package expresses sharding as
PartitionSpecs and lets its compiler insert the collectives; here each
rank holds its share and the collectives are explicit: none inside a
model call over dp or bag (the batch slices are gathered after it), two
all-reduces a transformer layer over tp (`ops/attention.py`), and the
gradient average over dp in training (`train.ShardedTrainStep`).
"""

from .mesh import (  # noqa: F401
    AXES,
    axis_group,
    axis_rank,
    axis_size,
    free_port,
    init_distributed,
    make_mesh,
    mesh_shape_for,
    rank_device,
)
from .sharding import gather_state_dict, shard_state_dict, tp_dim  # noqa: F401
from .separator import (  # noqa: F401
    ShardedSeparator,
    bag_share,
    make_bag_fn,
    make_sharded_fn,
)
