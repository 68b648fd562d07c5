"""Data parallelism over ``torch.distributed`` (``edrl_tpu/parallel/``): the
mesh, the batch-coupled collectives and ZeRO-1 (see ``parallel.mesh``)."""

from edrl_tpu_torch.parallel.mesh import (
    all_reduce_mean_,
    all_reduce_sum,
    draw_rows,
    gather_batches,
    gather_rows,
    init_distributed,
    is_writer,
    make_mesh,
    shard_batch,
    use_mesh,
    zero1_optimizer,
)

__all__ = [
    "all_reduce_mean_",
    "all_reduce_sum",
    "draw_rows",
    "gather_batches",
    "gather_rows",
    "init_distributed",
    "is_writer",
    "make_mesh",
    "shard_batch",
    "use_mesh",
    "zero1_optimizer",
]
