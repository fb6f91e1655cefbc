"""Multi-process training, sharding and evaluation: the twin of
``colddiff/parallel`` (one process per card; see ``distributed`` and
``mesh``)."""

from .distributed import init_multihost, local_device, process_count, process_index  # noqa: F401
from .mesh import (  # noqa: F401
    all_reduce_mean,
    batch_rows,
    data_sharding,
    draw_rows,
    fsdp_sharding,
    full_state_dict,
    gather_rows,
    image_sharding,
    is_sharded,
    local_rows,
    make_mesh,
    make_mesh_2d,
    put_like,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_images,
    shard_like,
    shard_state,
)
