"""Data-parallel runs of the port over ``torch.distributed``, counterpart
of ``jcfszxc_unet_tpu/parallel/`` (``mesh.py``; the row-sharded whole-image
forward of ``spatial.py`` is not ported yet)."""

from jcfszxc_unet_tpu_torch.parallel.launch import spawn
from jcfszxc_unet_tpu_torch.parallel.mesh import (
    World,
    all_reduce_sum,
    average_gradients,
    barrier,
    broadcast_module,
    gather_rows,
    global_batch_norm,
    initialize_distributed,
    is_main,
    make_2d_mesh,
    make_mesh,
    mean_over_ranks,
    row_bounds,
    shard_rows,
)

__all__ = [
    "World", "all_reduce_sum", "average_gradients", "barrier",
    "broadcast_module", "gather_rows", "global_batch_norm",
    "initialize_distributed", "is_main", "make_2d_mesh", "make_mesh",
    "mean_over_ranks", "row_bounds", "shard_rows", "spawn",
]
