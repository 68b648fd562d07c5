"""Post-training W8A8 int8 quantization of Dense layers for serving
(``edrl_tpu/ops/quantization.py``).

Every large :class:`~edrl_tpu_torch.models.layers.Dense` gets an int8 weight
with a static per-output-channel scale, and its input a *dynamic* per-row
scale (or, after ``calibrate_activation_scales``, a static per-tensor one):
the product is ``int8 x int8 -> int32`` (``torch._int_mm``, cuBLASLt's int8
tensor-core GEMM on the card; the JAX package leaves the same product to
XLA outside any Pallas kernel), rescaled in f32, plus the bias in f32, cast
to the Dense's compute dtype.  Everything around the Dense layers (LayerNorm,
attention, the fused kernels' own weights, losses) stays bf16/f32: the fused
MLP's ``w1``/``w2`` and the fused sublayer's ``qkv_kernel``/``proj_kernel``
are not Dense modules, in the JAX package as here.

What differs from the JAX module, and why:

- Dense ownership comes from forward hooks on the port's ``Dense`` during one
  eval forward (:func:`discover_dense_paths`), where JAX intercepts flax's
  ``nn.Dense`` under ``eval_shape``.  Keys are the port's qualified module
  names (``transformer_3d.blocks_0.Mlp_0.Dense_0``);
  ``convert.flax_key_map`` maps them onto the JAX package's ``/``-joined
  paths.
- Quantization is pure (:func:`quantize_dense_params` returns the int8
  weights and the scales, as JAX returns new params and scales);
  :func:`apply_int8_` then swaps each quantized Dense for an :class:`Int8Dense`
  in place, which is what JAX's interceptor does per call.  Quantize the
  float32 master weights, before ``layers.cast_dense_weights_``: the bf16
  weights round to other int8 values.
- ``torch._int_mm`` on the card takes M > 16 rows and K, N multiples of 8
  (the CPU takes any shape).  :func:`int8_matmul` pads M with zero rows,
  which is exact, and counts the call in :data:`INT8_MATMULS`; K and N are
  padded with zero columns at quantize time where they are not multiples of
  8.  No shape gives way to a float product.
- ``torch.quantile`` refuses more than 2^24 elements, which Swin's first
  stage exceeds at batch 16: :func:`linear_percentile` interpolates linearly
  between the two neighbouring order statistics (``kthvalue``), as
  ``jnp.percentile``'s default does.

Under tensor parallelism (``parallel.tensor``) the full f32 weight is
quantized first, each scale's max running over the whole ``in`` dimension,
and :func:`apply_int8_` then slices the int8 weight and its scales as the
parallel Dense it replaces is sliced.  A row-parallel :class:`Int8Dense`
takes the dynamic per-row activation scale as the max over the model ranks
of their slices' maxima, and sums the int32 partial products over the
ranks, which is exact: its output equals one card's.  A static scale is the
same on every rank.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.layers import Dense, compute_dtype

# A static activation scale for the Dense at key ``k`` lives at ``k + ACT_SUFFIX``
# in the same scales dict (module names never contain "@").
ACT_SUFFIX = "@act"
INT_MM = "int_mm"
INT_MM_PADDED = "int_mm_padded_m"
# int8 products since the last reset_launch_counts(): all of them, and those
# whose rows were padded up to INT_MM_MIN_ROWS.
INT8_MATMULS = {INT_MM: 0, INT_MM_PADDED: 0}
INT_MM_MIN_ROWS = 17  # the card's torch._int_mm takes M > 16
INT_MM_ALIGN = 8      # ... and K, N multiples of 8


def reset_launch_counts() -> None:
    for name in INT8_MATMULS:
        INT8_MATMULS[name] = 0


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def discover_dense_paths(model: nn.Module, *args, **kwargs) -> Tuple[str, ...]:
    """Run one forward under ``no_grad`` and return the names of the
    :class:`Dense` modules it calls, in first-call order."""
    seen: Dict[str, None] = {}
    hooks = [
        module.register_forward_pre_hook(lambda mod, inp, name=name: seen.setdefault(name, None))
        for name, module in model.named_modules() if isinstance(module, Dense)
    ]
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for hook in hooks:
            hook.remove()
    return tuple(seen)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a ``[out, in]`` weight:
    ``(int8 [out, in], f32 scale [out])``, scale = max(|W| over in, 1e-12) / 127."""
    w32 = w.detach().float()
    s = torch.clamp_min(w32.abs().amax(dim=1), 1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def quantize_dense_params(model: nn.Module, dense_paths: Sequence[str], min_dim: int = 128):
    """``(int8 weights, scales)`` of the Dense modules at ``dense_paths``
    whose weight has both sides at least ``min_dim``; ``scales[name]`` is the
    f32 ``[out]`` dequantization scale.  The model is not changed."""
    modules = dict(model.named_modules())
    weights: Dict[str, torch.Tensor] = {}
    scales: Dict[str, torch.Tensor] = {}
    for name in dense_paths:
        w = modules[name].weight
        if w.dim() != 2 or min(w.shape) < min_dim:
            continue
        weights[name], scales[name] = quantize_weight(w)
    return weights, scales


def _dynamic_quantize_rows(x32: torch.Tensor, axis=None):
    """Per-row (last axis) symmetric int8 of f32 activations: ``(q, scale [..., 1])``;
    with ``axis`` (a model axis over which the rows are split), each row's
    max over all the ranks' slices."""
    from edrl_tpu_torch.parallel.tensor import max_over_model

    s = torch.clamp_min(max_over_model(x32.abs().amax(dim=-1, keepdim=True), axis), 1e-12) / 127.0
    return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8), s


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x_q [M, K] @ w_q[N, K]^T`` in int32 through ``torch._int_mm``.

    K and N must be multiples of 8 (the quantized weights are padded so);
    M <= 16 is padded with zero rows to 17 and the result sliced back, on
    every device, so that the CPU runs the card's code path."""
    m, k = x_q.shape
    if k % INT_MM_ALIGN or w_q.shape[0] % INT_MM_ALIGN or w_q.shape[1] != k:
        raise ValueError(f"{INT_MM}: K and N must be multiples of {INT_MM_ALIGN}, got x {tuple(x_q.shape)}, "
                         f"w {tuple(w_q.shape)}")
    counting = not torch.compiler.is_compiling()
    if m < INT_MM_MIN_ROWS:
        x_q = F.pad(x_q, (0, 0, 0, INT_MM_MIN_ROWS - m))
        if counting:
            INT8_MATMULS[INT_MM_PADDED] += 1
    if counting:
        INT8_MATMULS[INT_MM] += 1
    return torch._int_mm(x_q, w_q.t())[:m]


class Int8Dense(nn.Module):
    """A quantized :class:`Dense`: int8 weight ``[out, in]`` (zero-padded to
    multiples of 8), f32 ``w_scale [out]``, the bias as it was, and an optional
    static activation scale (a scalar).  The forward is the JAX interceptor's
    (``make_int8_interceptor``) operation for operation: quantize x (per row,
    or with the static scale, saturating at +-127), the int32 product,
    ``acc * x_scale * w_scale`` in f32, ``+ bias`` in f32, cast to the
    Dense's compute dtype.

    In place of a column- or row-parallel Dense (``parallel.tensor``) it
    takes ``w_q`` and ``w_scale`` at full shape and keeps that Dense's slice
    and collectives (see the module docstring)."""

    def __init__(self, dense: Dense, w_q: torch.Tensor, w_scale: torch.Tensor,
                 act_scale: Optional[torch.Tensor] = None):
        super().__init__()
        self.parallel = getattr(dense, "kind", None)  # "column", "row" or None
        self.axis = getattr(dense, "axis", None)
        self.gather_output = getattr(dense, "gather_output", False)
        self.input_split = getattr(dense, "input_split", True)
        if self.parallel is not None:
            w_q, w_scale = dense.local(w_q), dense.local(w_scale)
        out_features, in_features = dense.weight.shape
        self.in_features, self.out_features = in_features, out_features
        self.dtype = compute_dtype(dense.dtype, dense.weight)
        pad_n = _round_up(out_features, INT_MM_ALIGN) - out_features
        pad_k = _round_up(in_features, INT_MM_ALIGN) - in_features
        device = dense.weight.device
        self.register_buffer("weight", F.pad(w_q.to(device), (0, pad_k, 0, pad_n)))
        self.register_buffer("w_scale", w_scale.to(device=device, dtype=torch.float32))
        self.bias = None if dense.bias is None else nn.Parameter(dense.bias.detach().clone(), requires_grad=False)
        self.register_buffer("act_scale", None if act_scale is None
                             else act_scale.to(device=device, dtype=torch.float32).reshape(()))

    def forward(self, x):
        from edrl_tpu_torch.parallel.tensor import gather_from_model, reduce_from_model, scatter_to_model

        row = self.parallel == "row"
        if row and not self.input_split:
            x = scatter_to_model(x, self.axis)
        x32 = x.float()
        if self.act_scale is None:
            x_q, x_scale = _dynamic_quantize_rows(x32, self.axis if row else None)
        else:
            x_scale = self.act_scale
            x_q = torch.clamp(torch.round(x32 / x_scale), -127, 127).to(torch.int8)
        lead = x_q.shape[:-1]
        x_q = x_q.reshape(-1, self.in_features)
        if self.weight.shape[1] != self.in_features:
            x_q = F.pad(x_q, (0, self.weight.shape[1] - self.in_features))
        acc = int8_matmul(x_q, self.weight)[:, :self.out_features].reshape(*lead, self.out_features)
        if row:
            acc = reduce_from_model(acc, self.axis)
        y = acc.float() * x_scale * self.w_scale
        if self.bias is not None:
            y = y + self.bias.float()
        y = y.to(self.dtype)
        return gather_from_model(y, self.axis) if self.gather_output else y


def apply_int8_(model: nn.Module, weights: Mapping[str, torch.Tensor], scales: Mapping[str, torch.Tensor]):
    """Swap each Dense in ``weights`` for an :class:`Int8Dense` with its
    weight scale and, where ``scales`` has ``name + ACT_SUFFIX``, its static
    activation scale.  In place; returns ``model``."""
    modules = dict(model.named_modules())
    for name, w_q in weights.items():
        parent_name, _, attr = name.rpartition(".")
        parent = modules[parent_name] if parent_name else model
        setattr(parent, attr, Int8Dense(modules[name], w_q, scales[name], scales.get(name + ACT_SUFFIX)))
    return model


def linear_percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of all of ``x``'s elements, as
    ``jnp.percentile``'s default computes it: the rank q / 100 * (n - 1) in
    f32, and linear interpolation ``low * (1 - t) + high * t`` between the two
    neighbouring order statistics.  They come from two ``kthvalue``
    selections, so any element count goes (``torch.quantile`` stops at
    2^24).  Above 2^24 elements the f32 rank is coarser than one element,
    as it is in JAX and in numpy's percentile of a float32 array."""
    flat = x.reshape(-1)
    n = flat.numel()
    rank = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
    lo, hi = min(int(np.floor(rank)), n - 1), min(int(np.ceil(rank)), n - 1)
    t = torch.tensor(rank - np.floor(rank), dtype=torch.float32, device=flat.device)
    low = torch.kthvalue(flat, lo + 1).values.float()
    high = low if hi == lo else torch.kthvalue(flat, hi + 1).values.float()
    return low * (1.0 - t) + high * t


def calibrate_activation_scales(model: nn.Module, scales: Mapping[str, torch.Tensor], *calib_args,
                                percentile: float = 100.0, **calib_kwargs) -> Dict[str, torch.Tensor]:
    """Static per-tensor activation scales from one forward of the
    *unquantized* ``model`` on a calibration batch.

    For every Dense named in ``scales`` it records the abs-max of the
    module's input (or, with ``percentile < 100``, that percentile of |x|),
    combined with max over repeated calls, and returns a copy of ``scales``
    with ``name + ACT_SUFFIX`` = max(a, 1e-12) / 127 (a scalar f32) added.
    """
    target = {k for k in scales if not k.endswith(ACT_SUFFIX)}
    amax: Dict[str, torch.Tensor] = {}

    def record(name):
        def hook(mod, inp):
            absx = inp[0].float().abs()
            a = absx.amax() if percentile >= 100.0 else linear_percentile(absx, percentile)
            amax[name] = a if name not in amax else torch.maximum(amax[name], a)
        return hook

    hooks = [m.register_forward_pre_hook(record(name)) for name, m in model.named_modules() if name in target]
    try:
        with torch.no_grad():
            model(*calib_args, **calib_kwargs)
    finally:
        for hook in hooks:
            hook.remove()
    out = dict(scales)
    for name, a in amax.items():
        out[name + ACT_SUFFIX] = torch.clamp_min(a, 1e-12) / 127.0
    return out


def quantize_for_serving(model: nn.Module, *example_args, min_dim: int = 128, **example_kwargs):
    """One-call PTQ: discover the Dense modules (one forward on the example),
    quantize their weights.  Returns ``(int8 weights, scales, report)``; the
    model is not changed (:func:`apply_int8_` swaps the modules).  ``report``
    has the JAX function's keys: the Dense modules seen and quantized, the
    parameter bytes before and after (int8 weights and scales in place of the
    f32 weights), the quantized names."""
    dense_paths = discover_dense_paths(model, *example_args, **example_kwargs)
    weights, scales = quantize_dense_params(model, dense_paths, min_dim=min_dim)
    modules = dict(model.named_modules())
    before = sum(p.numel() * p.element_size() for p in model.parameters())
    after = before + sum(
        w.numel() * w.element_size() + scales[name].numel() * 4
        - modules[name].weight.numel() * modules[name].weight.element_size()
        for name, w in weights.items()
    )
    report = {
        "dense_modules_seen": len(dense_paths),
        "dense_modules_quantized": len(scales),
        "param_bytes_before": before,
        "param_bytes_after": after,
        "quantized_paths": sorted(scales),
    }
    return weights, scales, report
