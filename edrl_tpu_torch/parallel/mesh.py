"""Data and tensor parallelism on ``torch.distributed`` (``edrl_tpu/parallel/mesh.py``).

One process per card, started by ``torchrun`` (``python -m
torch.distributed.run``): NCCL on ``cuda:LOCAL_RANK``, or gloo when the
caller asks for the CPU.  On the data axis each rank holds the whole model
(or its model-axis shards, below) and its rows of every global batch.  The JAX package jits its step over a ``(data, model)``
mesh and XLA makes every batch-coupled quantity global; here the modules
that couple a batch ask for it by name:

- :func:`gather_rows`: the global batch's rows on every rank (the MK-MMD's
  ``[2B, 3072]`` features, DILR's Barlow correlation);
- :func:`all_reduce_sum`: a sum over the ranks (the BatchNorms' statistics);
- :func:`draw_rows`: a draw of the global batch's shape from the step's
  generator, of which each rank keeps its rows, so that world N trains on
  the draws of world 1.

They read the data axis that :func:`use_mesh` makes current, as the JAX
package's ``batch_constraint`` reads the mesh that ``jax.set_mesh`` makes
current, and are identities where none is.  The train step enters it;
gradients are then averaged over the ranks (:func:`all_reduce_mean_`), so a
rank's rows, which take the sum of every rank's gradient of the global
terms, contribute once: world N at global batch B trains on the numbers of
one card at batch B, to within the order of the sums.

ZeRO-1 (:func:`zero1_optimizer`) shards Adam's moments over the data ranks,
whole tensors to a rank, with ``ZeroRedundancyOptimizer``.

Tensor parallelism: :func:`make_mesh` lays the world out as ``(WORLD //
M, M)`` with rank = d * M + m, as the JAX package's ``make_mesh`` lays out
its devices, so the M ranks of a data row are consecutive.  The ``model``
axis (:class:`ModelAxis`) splits the kernels that :data:`TP_RULES` names
(the port's copy of ``edrl_tpu/parallel/mesh.py``'s ``_TP_RULES``, matched
on the converter's flax names; :func:`param_shardings`), and
``parallel.tensor`` turns them into column- and row-parallel Dense layers.
Everything above stays on the data axis: the M ranks of a data row draw
alike and hold the same rows, each model rank averages its local
parameters (its shards and the replicas) over its own data group, and
ZeRO-1 shards them over that group.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import re
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """This rank's place on the mesh's data axis."""

    group: object
    rank: int
    size: int

    def __deepcopy__(self, memo):
        return self  # a process group is shared, never copied


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the mesh's model axis (tensor parallelism)."""

    group: object
    rank: int
    size: int

    def __deepcopy__(self, memo):
        return self


_AXIS: contextvars.ContextVar = contextvars.ContextVar("edrl_tpu_torch_data_axis", default=None)


def init_distributed(device="cuda", *, store=None) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``), or
    ``store``, and return this rank's device: NCCL on ``cuda:LOCAL_RANK``
    for ``device="cuda"``, gloo for ``device="cpu"``.  With no launcher and
    no store the world is this process alone.  A missing card or a failing
    NCCL raises; nothing falls back to gloo."""
    env = os.environ
    rank, world = int(env.get("RANK", "0")), int(env.get("WORLD_SIZE", "1"))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device}: torch finds no CUDA device")
        device = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"data parallelism runs on cuda or cpu, not {device}")
    if dist.is_initialized():
        return device
    if store is None and "MASTER_ADDR" not in env:
        if world != 1:
            raise RuntimeError(f"WORLD_SIZE={world} but no MASTER_ADDR: start the ranks with torchrun")
        store = dist.HashStore()
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, **kwargs)
    return device


def make_mesh(num_model: int = 1, *, device="cuda"):
    """The ``(data, model)`` ``DeviceMesh`` over the default process group
    (:func:`init_distributed` first): ``(WORLD_SIZE // num_model,
    num_model)``, rank = d * num_model + m (the JAX package's layout).  A
    model axis that does not divide the world raises ``ValueError``."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if num_model < 1 or world % num_model:
        raise ValueError(f"a model axis of {num_model} does not divide the world of {world} ranks")
    ranks = torch.arange(world).reshape(-1, num_model)
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=AXES)


def data_axis_of(mesh) -> DataAxis:
    """The mesh's data axis as this rank sees it."""
    return DataAxis(mesh.get_group("data"), mesh.get_local_rank("data"), mesh.size(0))


def model_axis_of(mesh) -> Optional[ModelAxis]:
    """The mesh's model axis as this rank sees it, or None where it is 1
    (or there is no mesh)."""
    if mesh is None or mesh.size(1) == 1:
        return None
    return ModelAxis(mesh.get_group("model"), mesh.get_local_rank("model"), mesh.size(1))


def is_writer(mesh) -> bool:
    """True on the rank that prints and writes files: rank (0, 0) of the
    mesh, or the only process when there is no mesh."""
    return mesh is None or (mesh.get_local_rank("data") == 0 and mesh.get_local_rank("model") == 0)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Make ``mesh``'s data axis current (nothing when ``mesh`` is None);
    the tensor-parallel layers keep the model axis they were sharded over
    (``parallel.tensor``)."""
    if mesh is None:
        yield
        return
    token = _AXIS.set(data_axis_of(mesh))
    try:
        yield
    finally:
        _AXIS.reset(token)


def current_axis() -> Optional[DataAxis]:
    """The data axis that :func:`use_mesh` made current, or None."""
    return _AXIS.get()


def global_rows(n: int) -> int:
    """The global batch's rows when this rank holds ``n`` of them (``n`` with
    no current data axis)."""
    axis = _AXIS.get()
    return n if axis is None else n * axis.size


def rows_of(n: int, axis: DataAxis) -> slice:
    """This rank's rows of a global batch of ``n`` (a multiple of the axis)."""
    if n % axis.size:
        raise ValueError(f"a batch of {n} does not split over {axis.size} data ranks")
    per = n // axis.size
    return slice(axis.rank * per, (axis.rank + 1) * per)


def shard_batch(batch: Mapping, mesh) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors, leading
    axis the batch)."""
    axis = data_axis_of(mesh)
    return {k: v[rows_of(v.shape[0], axis)] for k, v in batch.items()}


def draw_rows(fn, shape: Sequence[int], generator, device) -> torch.Tensor:
    """``fn(shape, generator=, device=)`` (``torch.rand``, ``torch.randn``),
    the leading axis the batch: under a current data axis, drawn at the
    global batch and this rank's rows kept.

    World N then draws what world 1 draws where the two draw the same global
    shape: a train step, and an eval batch that needs no padding.  Two
    limits.  Every rank draws the whole global batch, so its generator work
    and transient memory grow with the world (at global batch 128, a
    device-noise view of the shipped sizes is about 0.68 GB a rank).  And a
    padded eval remainder draws at the padded shape: the CPU generator gives
    world 1's values on the real rows all the same, but CUDA's Philox
    offsets depend on the whole draw's size, so on the card those rows'
    draws (the guided uniforms) differ from world 1's."""
    axis = _AXIS.get()
    shape = tuple(shape)
    if axis is None:
        return fn(shape, generator=generator, device=device)
    full = fn((shape[0] * axis.size, *shape[1:]), generator=generator, device=device)
    return full[rows_of(full.shape[0], axis)]


def _all_gather_cat(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward sums the incoming gradient over
    the ranks and returns this rank's rows."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        return _all_gather_cat(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, grad):
        grad = sum_over(grad, ctx.axis)
        r = ctx.axis.rank
        return grad[r * ctx.rows:(r + 1) * ctx.rows], None


def sum_over(x: torch.Tensor, axis: Optional[DataAxis]) -> torch.Tensor:
    """``x`` summed over ``axis``'s ranks into a new tensor (``x`` itself when
    ``axis`` is None); no gradient."""
    if axis is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; the backward sums the incoming gradient too."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return sum_over(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return sum_over(grad, ctx.axis), None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``x``, rank after rank (``x`` itself with no
    current data axis).  Every rank then computes the same global term; its
    rows take the sum of every rank's gradient of it, which the average of
    the parameter gradients (:func:`all_reduce_mean_`) divides back."""
    axis = _AXIS.get()
    return x if axis is None else _GatherRows.apply(x, axis)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks, differentiably (``x`` itself with no
    current data axis)."""
    axis = _AXIS.get()
    return x if axis is None else _AllReduceSum.apply(x, axis)


def gather_batches(local: torch.Tensor, per_batch: int, mesh) -> torch.Tensor:
    """Consecutive batches' local rows, ``per_batch`` of each on every rank
    -> every rank's rows, each batch's in rank order (no gradient)."""
    axis = data_axis_of(mesh)
    full = _all_gather_cat(local.contiguous(), axis)  # rank-major
    tail = local.shape[1:]
    return full.reshape(axis.size, -1, per_batch, *tail).transpose(0, 1).reshape(-1, *tail)


def all_reduce_mean_(tensors: List[torch.Tensor], mesh) -> None:
    """Average ``tensors`` (same dtype and device) over the data ranks in
    place, in one flat all-reduce."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    axis = data_axis_of(mesh)
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=axis.group)
    flat.div_(axis.size)
    for t, reduced in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(reduced)


def zero1_optimizer(params, mesh, **adam_kwargs):
    """Adam (``adam_kwargs``) with its moments sharded over the data ranks
    (ZeRO-1): ``ZeroRedundancyOptimizer`` gives each rank whole parameters
    to update, which it then broadcasts.  Adam is elementwise, so the update
    equals the replicated one."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(list(params), optimizer_class=torch.optim.Adam,
                                   process_group=mesh.get_group("data"), **adam_kwargs)


def is_zero1(optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(optimizer, ZeroRedundancyOptimizer)


def load_optimizer_state(optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict(state_dict)``, then, under ZeRO-1, each
    moment back on its parameter's device: ``ZeroRedundancyOptimizer`` moves
    every 0-d state tensor to the host to keep Adam's step there, and with it
    the moments of a 0-d parameter (EPRL's ``alpha``), which Adam's step on
    the card then refuses."""
    optimizer.load_state_dict(state_dict)
    if not is_zero1(optimizer):
        return
    for param, state in optimizer.optim.state.items():
        for key, value in state.items():
            if key != "step" and torch.is_tensor(value):
                state[key] = value.to(param.device)


def barrier(mesh) -> None:
    """Every rank of the mesh (the whole world) waits for the others."""
    dist.barrier()


# ---------------------------------------------------------------------------
# The tensor-parallel rules (``edrl_tpu/parallel/mesh.py``'s ``_TP_RULES``).
# ---------------------------------------------------------------------------

COLUMN, ROW = 1, 0  # the split axis of a flax [in, out] kernel
# (flax path regex, the split axis of the flax kernel), first match wins: up-
# projections split their outputs (column-parallel), down-projections their
# inputs (row-parallel).
TP_RULES = (
    (re.compile(r"Mlp_\d+/Dense_0/kernel"), COLUMN),
    (re.compile(r"Mlp_\d+/Dense_1/kernel"), ROW),
    (re.compile(r"Mlp_\d+/w1"), COLUMN),
    (re.compile(r"Mlp_\d+/w2"), ROW),
    (re.compile(r"qkv/kernel"), COLUMN),
    (re.compile(r"/(q|k|v)/kernel"), COLUMN),
    (re.compile(r"proj/kernel"), ROW),
    (re.compile(r"patch_embed/kernel"), COLUMN),
    (re.compile(r"enc[12]/kernel"), COLUMN),
    (re.compile(r"enc3/kernel"), ROW),
    (re.compile(r"(shared_|guided_)?projector\d?/kernel"), COLUMN),
    (re.compile(r"(self|cross)_attn\d/Dense_0/kernel"), COLUMN),
    (re.compile(r"(self|cross)_attn\d/Dense_1/kernel"), ROW),
    (re.compile(r"fc_fundus/kernel"), COLUMN),
)


def flax_path(name: str) -> str:
    """The flax path (``/``-joined, without ``params/``) of the port's
    parameter ``name``, as ``convert`` maps them: a Dense's ``weight`` is its
    ``kernel``.  (Only the 2-D leaves the rules can match need it: a
    LayerNorm's 1-D ``weight`` is flax's ``scale``.)"""
    parts = name.split(".")
    return "/".join(parts[:-1] + [{"weight": "kernel"}.get(parts[-1], parts[-1])])


def param_shardings(model: torch.nn.Module, mesh: Union[int, object]) -> Dict[str, Optional[int]]:
    """Each parameter of ``model`` (full shapes) -> the dimension of its torch
    tensor that the model axis splits, or None (replicated), by
    :data:`TP_RULES` under JAX's rule: a 2-D leaf that a rule's pattern
    matches is split where that dimension divides the model axis (``mesh``:
    a ``DeviceMesh`` or the axis's size), else the next rule is tried; one
    that no rule splits is replicated, and everything is replicated on a
    model axis of 1.  A Dense ``weight`` is the flax kernel transposed, so a
    column split is its dimension 0 and a row split its dimension 1; a fused
    MLP's ``w1``/``w2`` keep flax's layout."""
    m = mesh if isinstance(mesh, int) else mesh.size(1)
    out: Dict[str, Optional[int]] = {}
    for name, param in model.named_parameters():
        out[name] = None
        if param.dim() != 2 or m <= 1:
            continue
        path = flax_path(name)
        transposed = path.endswith("/kernel")
        for pattern, flax_axis in TP_RULES:
            dim = 1 - flax_axis if transposed else flax_axis
            if pattern.search(path) and param.shape[dim] % m == 0:
                out[name] = dim
                break
    return out


def sharded_byte_fraction(model: torch.nn.Module, shardings: Mapping[str, Optional[int]]) -> float:
    """The share of ``model``'s parameter bytes (full shapes) that
    ``shardings`` splits: the JAX package's ``sharded_byte_fraction``."""
    total = sharded = 0
    for name, param in model.named_parameters():
        nbytes = param.numel() * param.element_size()
        total += nbytes
        if shardings.get(name) is not None:
            sharded += nbytes
    return sharded / max(total, 1)
