"""Tensor parallelism over the mesh's ``model`` axis (the JAX package's
``infer_param_shardings`` and its callers, ``edrl_tpu/parallel/mesh.py``).

The JAX package places the parameters with the TP rules' shardings and lets
XLA partition the jitted step.  The port has no partitioner: each Dense that
``mesh.param_shardings`` splits becomes a :class:`ColumnParallelDense` (its
output features split over the M model ranks) or a
:class:`RowParallelDense` (its input features split), holding only its
slice, with the collectives written out as four autograd functions over the
model group:

- :func:`copy_to_model`: identity forward, all-reduce (sum) backward; at
  the input of every column-parallel product and of every replicated
  parameter used on a rank's slice, so that a replicated parameter ends a
  step with the same gradient on every model rank;
- :func:`reduce_from_model`: all-reduce (sum) forward, identity backward;
  after a row-parallel product (its bias added once, after the sum);
- :func:`gather_from_model`: all-gather of the last dimension forward, this
  rank's slice backward; after a column-parallel product whose consumer
  needs the full width;
- :func:`scatter_to_model`: this rank's slice forward, all-gather backward;
  before a row-parallel product fed at full width.

After the backward, :func:`broadcast_replicated_grads_` sends the replicated
parameters' gradients from model rank 0 to the other ranks of its data row,
so that replicas stay bit-equal where the card's backward sums in no fixed
order (a CNN model's convolutions and pools); it records the largest
difference it overwrote (:func:`replica_drift`), which the checks read.

:func:`shard_model_` turns a model with full-shape parameters (a seeded init
or ``convert.load_flax_variables``' output) into this rank's shards: the
modules that pair a column- with a row-parallel product (``Mlp``, DILR's
``AttentionModel``, EPRL's ``enc2``/``enc3``) keep the activation between
them split (:func:`shard_pair_`); the attention modules split their heads
(below); every other split Dense is gathered after its product (the patch
embeddings, EPRL's ``enc1``, DILR's projectors, ``fc_fundus``).  The
parameters keep their names and their order, so an optimizer and a state
dict line up with one card's.

Attention under the model axis (``layers.MultiHeadAttention``,
``swin2d.WindowAttention``), on one of two routes:

- **head-local**, where the heads divide M and q/k/v (or qkv) and ``proj``
  are all split: each rank attends over its H/M heads on its column block
  and ``proj`` takes that block row-parallel.  Swin's packed ``qkv`` lays
  its outputs out ``[3, H, D]``, so its rows are permuted when sharded
  (:func:`head_major_permutation`) for rank m to hold q, k and v of its own
  heads; the relative-bias table (replicated) is read at the rank's heads'
  columns through :func:`copy_to_model`, which sums its gradient over the
  model ranks.
- **gathered**, where the heads do not divide M (Swin's stage 0 of 1 head
  at M = 2; stages 0 and 1 at M = 4; ViT's 6 heads at M = 4): the
  projections stay column-parallel in JAX's contiguous order and are
  gathered, every rank attends over all heads, and ``proj`` takes its row
  slice of the result (:func:`scatter_to_model`).

**The kernels under TP.**  B1 (``self_attention_fused``) and B2
(``window_attention_fused_v2``), and v1 with B2's code, stay on: on the
head-local route they run with ``num_heads = H / M`` on the rank's columns,
on the gathered route on all heads, and each launch counts under its route
in ``kernels.window_attention.TP_ROUTES``.  B4 runs on replicated
activations and B3 on the features, both unchanged.  B5
(``use_fused_mlp``: whole ``w1``/``w2``) and B6
(``use_fused_block_attention``: the flat ``qkv_kernel``) read whole kernels
and are refused under a model axis above 1 (``trainer.check_tensor_parallel``),
where the JAX package turns every kernel flag off.

Checkpoints hold full shapes in JAX's column order (:func:`gather_full`,
qkv's permutation undone), and load on any mesh by slicing
(:func:`shard_full`).  Int8 serving quantizes the full f32 weight and then
slices it with its per-output-channel scales (``ops.quantization``).
"""

from __future__ import annotations

import weakref
from typing import Dict, FrozenSet, List, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.layers import Dense, compute_dtype
from edrl_tpu_torch.parallel.mesh import ModelAxis, model_axis_of, param_shardings

# ---------------------------------------------------------------------------
# The collectives over the model group.
# ---------------------------------------------------------------------------

# The model-axis collectives the layers and the step's gradient broadcast
# ran since the last reset_collective_counts(), and the bytes this rank put in.
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "bytes": 0}
# The largest |difference| broadcast_replicated_grads_ overwrote on this rank
# since the last reset_collective_counts(): a device scalar, None before the
# first broadcast (read with replica_drift()).
_DRIFT: Dict[str, Optional[torch.Tensor]] = {"max": None}


def reset_collective_counts() -> None:
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0
    _DRIFT["max"] = None


def replica_drift() -> float:
    """The largest |difference| between this rank's replicated gradients and
    model rank 0's that :func:`broadcast_replicated_grads_` overwrote since
    the last :func:`reset_collective_counts` (0 where it overwrote none)."""
    return 0.0 if _DRIFT["max"] is None else float(_DRIFT["max"])


def _count(kind: str, x: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVES["bytes"] += x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, axis: ModelAxis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    _count("all_reduce", out)
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def _all_gather_last(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    _count("all_gather", x)
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=-1)


def _slice_last(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    width = x.shape[-1] // axis.size
    return x[..., axis.rank * width:(axis.rank + 1) * width].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather_last(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _slice_last(grad, ctx.axis), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _slice_last(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_last(grad, ctx.axis), None


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """``x``; its gradient summed over the model ranks."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """``x`` summed over the model ranks; its gradient passed through."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The model ranks' last-dimension slices, concatenated in rank order;
    the gradient's slice of this rank."""
    return x if axis is None else _GatherFromModel.apply(x, axis)


def scatter_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """This rank's contiguous slice of the last dimension; the gradient
    all-gathered."""
    return x if axis is None else _ScatterToModel.apply(x, axis)


def max_over_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The elementwise max over the model ranks (no gradient)."""
    return x if axis is None else _all_reduce(x, axis, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# The parallel Dense layers.
# ---------------------------------------------------------------------------


def _rows(n: int, axis: ModelAxis) -> slice:
    per = n // axis.size
    return slice(axis.rank * per, (axis.rank + 1) * per)


def head_major_permutation(dim: int, num_heads: int, parts: int) -> torch.Tensor:
    """The order of a packed ``[3, H, D]`` projection's ``3 * dim`` outputs
    in which each of ``parts`` contiguous blocks holds q, k and v of its own
    H / parts heads (``[parts, 3, H / parts, D]``)."""
    d, local = dim // num_heads, num_heads // parts
    return torch.arange(3 * dim).reshape(3, parts, local, d).transpose(0, 1).reshape(-1)


class ColumnParallelDense(Dense):
    """This rank's output features of a :class:`Dense` (rows of its ``[out,
    in]`` weight, after ``permutation`` where one is given), the bias
    sliced alike.  The input arrives whole on every rank; the output stays
    split, or is gathered with ``gather_output``."""

    kind = "column"

    def __init__(self, dense: Dense, axis: ModelAxis, *, gather_output: bool,
                 permutation: Optional[torch.Tensor] = None):
        out_features, in_features = dense.weight.shape
        super().__init__(in_features, out_features // axis.size, use_bias=dense.bias is not None,
                         dtype=dense.dtype, device=dense.weight.device)
        self.axis, self.gather_output = axis, gather_output
        self.full_features = out_features
        self.permutation = None if permutation is None else permutation.to(dense.weight.device)
        with torch.no_grad():
            for mine, full in ((self.weight, dense.weight), (self.bias, dense.bias)):
                if mine is not None:
                    mine.copy_(self.local(full.detach()))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full-shape weight, bias or moment."""
        if self.permutation is not None:
            full = full[self.permutation.to(full.device)]
        return full[_rows(self.full_features, self.axis)]

    def forward(self, x):
        y = super().forward(copy_to_model(x, self.axis))
        return gather_from_model(y, self.axis) if self.gather_output else y


class RowParallelDense(Dense):
    """This rank's input features of a :class:`Dense` (columns of its
    ``[out, in]`` weight) and the whole bias.  The input arrives split
    (``input_split``) or whole, then sliced here; the partial products are
    summed over the model ranks in float32 and the bias is added once,
    after the sum."""

    kind = "row"

    def __init__(self, dense: Dense, axis: ModelAxis, *, input_split: bool):
        out_features, in_features = dense.weight.shape
        super().__init__(in_features // axis.size, out_features, use_bias=dense.bias is not None,
                         dtype=dense.dtype, device=dense.weight.device)
        self.axis, self.input_split = axis, input_split
        self.full_features = in_features
        with torch.no_grad():
            self.weight.copy_(self.local(dense.weight.detach()))
            if self.bias is not None:
                self.bias.copy_(dense.bias.detach())

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full-shape weight or moment (a bias is whole)."""
        return full if full.dim() == 1 else full[:, _rows(self.full_features, self.axis)]

    def forward(self, x):
        if not self.input_split:
            x = scatter_to_model(x, self.axis)
        dtype = compute_dtype(self.dtype, self.weight)
        y = reduce_from_model(F.linear(x.to(dtype), self.weight.to(dtype)).float(), self.axis)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(dtype)


PARALLEL_DENSE = (ColumnParallelDense, RowParallelDense)


def shard_pair_(module: nn.Module, column: str, row: str, axis: ModelAxis, dims: Dict[nn.Module, int]) -> bool:
    """``module.<column>`` then ``module.<row>``, an elementwise function
    between them: each split as ``dims`` says (and taken out of it), the
    activation between them left split where both are.  True where it is."""
    col_dense, row_dense = getattr(module, column), getattr(module, row)
    col_split, row_split = dims.pop(col_dense, None) == 0, dims.pop(row_dense, None) == 1
    if col_split:
        setattr(module, column, ColumnParallelDense(col_dense, axis, gather_output=not row_split))
    if row_split:
        setattr(module, row, RowParallelDense(row_dense, axis, input_split=col_split))
    return col_split and row_split


@torch.no_grad()
def shard_model_(model: nn.Module, mesh) -> nn.Module:
    """Turn ``model`` (full-shape parameters) into this rank's shards over
    ``mesh``'s model axis, in place (see the module docstring); a mesh with
    a model axis of 1 (or None) leaves it as it is.  Returns ``model``."""
    axis = model_axis_of(mesh)
    if axis is None:
        return model
    if model_axis_of_model(model) is not None:
        raise ValueError("the model is sharded already")
    modules = dict(model.named_modules())
    dims: Dict[nn.Module, int] = {}
    for name, dim in param_shardings(model, axis.size).items():
        owner = modules[name.rpartition(".")[0]]
        if dim is not None:
            if not isinstance(owner, Dense):
                raise TypeError(f"{name}: a split parameter of a {type(owner).__name__}, not of a Dense (a fused "
                                "MLP's w1/w2: B5 does not run on shards, trainer.check_tensor_parallel)")
            dims[owner] = dim
    for module in list(modules.values()):
        shard = getattr(module, "tensor_parallel_", None)
        if shard is not None:
            shard(axis, dims)
    # What no module claimed: a column split gathered after its product, a
    # row split sliced before it.
    for name, module in list(model.named_modules()):
        for child_name, child in list(module.named_children()):
            dim = dims.pop(child, None)
            if dim == 0:
                setattr(module, child_name, ColumnParallelDense(child, axis, gather_output=True))
            elif dim == 1:
                setattr(module, child_name, RowParallelDense(child, axis, input_split=False))
    if dims:
        raise RuntimeError(f"split Dense layers left unsharded: {len(dims)}")
    _SPLIT_IDS.pop(model, None)
    return model


def model_axis_of_model(model: nn.Module) -> Optional[ModelAxis]:
    """The model axis ``model`` is sharded over, or None."""
    for module in model.modules():
        if isinstance(module, PARALLEL_DENSE):
            return module.axis
    return None


# ---------------------------------------------------------------------------
# Full shapes: checkpoints, gradients, tests.
# ---------------------------------------------------------------------------


def _split_owners(model: nn.Module) -> Dict[str, nn.Module]:
    """Each split parameter's name -> its parallel Dense (a row-parallel
    bias is whole and not listed)."""
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, PARALLEL_DENSE):
            prefix = f"{name}." if name else ""
            out[prefix + "weight"] = module
            if module.bias is not None and module.kind == "column":
                out[prefix + "bias"] = module
    return out


# Each sharded model's split parameters, by id, found once a model.
_SPLIT_IDS: "weakref.WeakKeyDictionary[nn.Module, FrozenSet[int]]" = weakref.WeakKeyDictionary()


def _split_ids(model: nn.Module) -> FrozenSet[int]:
    """The ids of ``model``'s split parameters (found on the first call for
    a model; :func:`shard_model_` forgets them)."""
    ids = _SPLIT_IDS.get(model)
    if ids is None:
        ids = _SPLIT_IDS[model] = frozenset(id(model.get_parameter(n)) for n in _split_owners(model))
    return ids


def split_parameter_names(model: nn.Module) -> List[str]:
    """The names of the parameters the model axis splits."""
    return list(_split_owners(model))


def gather_full(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (this rank's, by parameter or state-dict name: weights,
    gradients, moments) at full shape in JAX's order: each split one
    all-gathered over the model axis along its split dimension and qkv's
    permutation undone; the others as they are.  Every rank of the model
    group calls it with the same names.  The gather runs on the layer's
    device and each result returns to its tensor's: ZeRO-1's consolidated
    moments lie on the host, where NCCL cannot gather them."""
    owners = _split_owners(model)
    out = {}
    for name, t in tensors.items():
        module = owners.get(name)
        if module is None:
            out[name] = t
            continue
        home = t.device
        t = t.to(module.weight.device).contiguous()
        parts = [torch.empty_like(t) for _ in range(module.axis.size)]
        dist.all_gather(parts, t, group=module.axis.group)
        full = torch.cat(parts, dim=0 if module.kind == "column" or t.dim() == 1 else 1)
        if module.kind == "column" and module.permutation is not None:
            full = full[torch.argsort(module.permutation).to(full.device)]
        out[name] = full.to(home)
    return out


def shard_full(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` at full shape (by name, as :func:`gather_full` gives them)
    -> this rank's slices; the inverse of :func:`gather_full`."""
    owners = _split_owners(model)
    return {name: t if name not in owners else owners[name].local(t) for name, t in tensors.items()}


def parameter_names(model: nn.Module) -> List[str]:
    """The parameters' names in ``model.parameters()``'s order: an optimizer's
    parameter indices."""
    return [name for name, _ in model.named_parameters()]


def _map_moments(model: nn.Module, optimizer_state: Mapping, fn) -> dict:
    """An optimizer state dict (by parameter index, in ``model.parameters()``'s
    order) with ``fn(model, {name: tensor})`` applied to each split
    parameter's per-parameter tensors (Adam's moments; the 0-d step stays)."""
    names = parameter_names(model)
    owners = _split_owners(model)
    entries = {}
    for index, entry in optimizer_state["state"].items():
        name = names[int(index)]
        if name in owners:
            entry = {k: fn(model, {name: v})[name] if torch.is_tensor(v) and v.dim() > 0 else v
                     for k, v in entry.items()}
        entries[index] = entry
    return dict(optimizer_state, state=entries)


def gather_optimizer_state(model: nn.Module, optimizer_state: Mapping) -> dict:
    """An optimizer state dict with every split parameter's moments at full
    shape (a collective over the model axis, as :func:`gather_full`)."""
    return _map_moments(model, optimizer_state, gather_full)


def shard_optimizer_state(model: nn.Module, optimizer_state: Mapping) -> dict:
    """The inverse of :func:`gather_optimizer_state`: full-shape moments ->
    this rank's slices."""
    return _map_moments(model, optimizer_state, shard_full)


def broadcast_replicated_grads_(model: nn.Module, params, mesh) -> None:
    """Every replicated parameter's gradient in ``params`` sent from model
    rank 0 of this rank's data row to the others, in one flat broadcast over
    the model group (nothing without a model axis above 1).

    The ranks of a data row compute a replicated parameter's gradient from
    the same rows, but on the card a backward whose sums land in an order
    that changes from run to run (cuDNN's convolution weight gradients, the
    pools' backwards) leaves them a rounding apart (Multi_ResNet_cross's by
    up to 1.9e-5 at batch 8 on an NVIDIA H100 80GB HBM3 at 700 W), and
    replicas that step apart drift apart.  Where they are equal, as on the
    CPU, the broadcast changes nothing.  It counts in ``COLLECTIVES`` and
    records the largest |difference| it overwrote (:func:`replica_drift`)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    axis = model_axis_of(mesh)
    if axis is None:
        return
    split = _split_ids(model)
    grads = [p.grad for p in params if id(p) not in split and p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    own = flat.clone() if axis.rank else None
    _count("broadcast", flat)
    dist.broadcast(flat, src=dist.get_global_rank(axis.group, 0), group=axis.group)
    if own is not None:
        drift = (flat - own).abs().max()
        _DRIFT["max"] = drift if _DRIFT["max"] is None else torch.maximum(_DRIFT["max"], drift)
    for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(synced)


def clip_grad_norm_(model: nn.Module, params, max_norm: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` (optax's ``clip_by_global_norm``)
    over a model, sharded or not: the global norm counts each split
    gradient's squares summed over the model ranks and each replicated one
    once; with no model axis it is torch's own, bit for bit.  With no
    gradient it returns 0 and clips nothing."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return torch.zeros(())
    axis = model_axis_of_model(model)
    if axis is None:
        total = torch.nn.utils.get_total_norm([p.grad for p in params])
    else:
        split = _split_ids(model)
        sq = [torch.zeros((), device=params[0].grad.device) for _ in range(2)]
        for is_split in (False, True):
            grads = [p.grad for p in params if (id(p) in split) == is_split]
            if grads:
                sq[is_split] = torch.nn.utils.get_total_norm(grads).square()
        total = torch.sqrt(sq[False] + _all_reduce(sq[True], axis))
    torch.nn.utils.clip_grads_with_norm_(params, max_norm, total)
    return total
