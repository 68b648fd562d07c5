"""Data and tensor parallelism over ``torch.distributed`` (``edrl_tpu/parallel/``):
the ``(data, model)`` mesh, the batch-coupled collectives, ZeRO-1 and the
tensor-parallel rules (see ``parallel.mesh``), and the column- and
row-parallel Dense layers and their collectives (``parallel.tensor``)."""

from edrl_tpu_torch.parallel.mesh import (
    all_reduce_mean_,
    all_reduce_sum,
    draw_rows,
    gather_batches,
    gather_rows,
    init_distributed,
    is_writer,
    make_mesh,
    param_shardings,
    shard_batch,
    sharded_byte_fraction,
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
    "param_shardings",
    "shard_batch",
    "sharded_byte_fraction",
    "use_mesh",
    "zero1_optimizer",
]
