"""Multi-device runs of the port over ``torch.distributed``, counterpart
of ``jcfszxc_unet_tpu/parallel/``: data-parallel training and evaluation
(``mesh.py``, ``launch.py``, ``jobs.py``) and the whole-image forward with
the image's rows sharded over the ranks (``spatial.py``)."""

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
