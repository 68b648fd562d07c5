"""The dual-view train step and the eval step (``edrl_tpu/train/trainer.py``).

One train step, as ``make_train_step`` builds it in the JAX package:

1. MedFusion in train mode on the low-noise view;
2. MedFusion in train mode on the high-noise view, from the batch
   statistics the first forward updated (its own loss is dropped);
3. ``mmd_weight`` x MK-MMD between the two ``[B, 3072]`` feature batches
   (``ops.mmd.mk_mmd``, or the fused kernel B3 with ``use_pallas_mmd``), plus
   the optional JS logit distillation;
4. the backward (through the B1/B2 backward kernels on the card);
5. Adam with the weight decay folded into the gradient and a linear warmup
   of ``min((step + 1) / warmup_steps, 1)`` (``make_optimizer``).

The −MMD ablation (``mmd_weight == 0``) skips the second forward only when
the JS weight is 0 as well.  The step takes ready-made views; a clean
batch (``fundus``/``oct``, which the JAX step augments and corrupts on the
device) is ROADMAP item A7.

Master weights stay f32; each Dense casts them per call, so a model that
trains must not go through ``layers.cast_dense_weights_`` (a serving-only
measure).  Unlike the JAX step, which returns a new state, ``train_step``
updates the state's model, optimizer and scheduler in place and leaves the
step's gradients in the parameters' ``.grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.convert import load_flax_variables
from edrl_tpu_torch.models.layers import init_parameters
from edrl_tpu_torch.models.medfusion import MedFusion
from edrl_tpu_torch.ops.distributions import js_divergence
from edrl_tpu_torch.ops.mmd import mk_mmd

VIEW_KEYS = ("fundus_low", "fundus_high", "oct_low", "oct_high")


def _normalize_output(out):
    """(logits, loss, features[, aux]) -> (logits, loss, features, aux)."""
    if len(out) == 3:
        return out[0], out[1], out[2], {}
    return out


def _dequantize(x: torch.Tensor) -> torch.Tensor:
    """uint8-transported batches -> float32 in [0, 1] (no-op for floats)."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: torch finds no CUDA device")
    return device


def warmup_factor(step: int, warmup_steps: int) -> float:
    """The lr multiplier of optimizer step ``step`` (0-based)."""
    if warmup_steps <= 0:
        return 1.0
    return min((step + 1.0) / warmup_steps, 1.0)


def make_optimizer(params, cfg: EDRLConfig):
    """``(Adam, LambdaLR)``: Adam(lr, weight_decay) with decay folded into the
    gradient (optax ``add_decayed_weights`` before ``adam``) and the linear
    warmup as a LambdaLR, stepped once per optimizer step."""
    if cfg.model.model_name != "MedFusion":
        raise NotImplementedError(
            f"model {cfg.model.model_name!r}: the port has MedFusion only; the "
            "baseline zoo and its per-member learning rates are ROADMAP item A9"
        )
    if cfg.train.use_plateau_schedule:
        raise NotImplementedError("the plateau schedule is ROADMAP item A8")
    optimizer = torch.optim.Adam(params, lr=cfg.train.lr, weight_decay=cfg.train.weight_decay)
    w = cfg.train.warmup_steps
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: warmup_factor(step, w))
    return optimizer, scheduler


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and warmup schedule, and the step count."""

    model: MedFusion
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def init_state(cfg: EDRLConfig, seed: int = 0, *, device="cuda",
               variables: Optional[Mapping] = None) -> TrainState:
    """A MedFusion and its optimizer on ``device`` (the card unless the caller
    asks for the CPU).

    ``variables``: ``{"params": ..., "batch_stats": ...}`` flax trees of numpy
    arrays (a JAX ``TrainState``'s), loaded with
    ``convert.load_flax_variables``; ``None`` gives the seeded flax-style
    init.
    """
    device = resolve_device(device)
    d = cfg.data
    model = MedFusion(cfg.model, d.fundus_size, d.oct_size, device=device)
    if variables is None:
        init_parameters(model, torch.Generator(device=device).manual_seed(seed))
    else:
        load_flax_variables(model, variables["params"], variables.get("batch_stats"))
    optimizer, scheduler = make_optimizer(model.parameters(), cfg)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _ready_views(batch: Mapping, device, keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    if "fundus" in batch or "oct" in batch:
        raise NotImplementedError(
            "clean fundus/oct batches need the on-device augmentation and "
            "dual-view noise of ROADMAP item A7; pass ready-made views "
            f"({', '.join(VIEW_KEYS)})"
        )
    views = {k: _dequantize(_as_tensor(batch[k], device)) for k in keys}
    views["label"] = _as_tensor(batch["label"], device).long()
    return views


def random_views(cfg: EDRLConfig, seed: int = 0, *, batch_size: Optional[int] = None,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """A train batch of ready-made f32 views, uniform in [0, 1), and 0/1
    labels from numpy seed ``seed``, drawn in the order of the JAX package's
    ``bench.make_batch``; ``batch_size`` defaults to ``cfg.data.batch_size``."""
    b = cfg.data.batch_size if batch_size is None else batch_size
    d, rng = cfg.data, np.random.default_rng(seed)
    batch = {k: rng.uniform(size=(b, d.fundus_size, d.fundus_size, 3)).astype(np.float32)
             for k in ("fundus_low", "fundus_high")}
    batch.update({k: rng.uniform(size=(b, *d.oct_size, 1)).astype(np.float32) for k in ("oct_low", "oct_high")})
    batch["label"] = rng.integers(0, 2, size=b).astype(np.int32)
    device = resolve_device(device)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: EDRLConfig):
    """The dual-view train step for ``cfg``.

    Returns ``train_step(state, batch, generator, *, draws=None)``.
    ``batch`` holds ``fundus_low``, ``fundus_high``, ``oct_low``,
    ``oct_high`` and ``label`` (numpy arrays or tensors; uint8 views are
    dequantized).  The step's noise (guided uniforms, EPRL eps, dropout
    masks) comes from ``generator``, a ``torch.Generator`` on the model's
    device, as the JAX step takes a key; ``draws`` overrides it with given
    tensors, one mapping per forward with the keyword arguments
    ``guided_uniform``, ``eprl_eps`` and ``dropout_masks`` of
    ``MedFusion.forward``.  Returns ``{"loss", "mmd", "probs", **aux}``,
    detached.
    """
    t = cfg.train
    if t.use_pallas_mmd:
        from edrl_tpu_torch.kernels.mmd import mk_mmd_fused as mmd_fn
    else:
        mmd_fn = mk_mmd
    two_views = t.mmd_weight != 0.0 or t.js_distillation_weight != 0.0

    def train_step(state: TrainState, batch: Mapping, generator: torch.Generator, *,
                   draws: Optional[Sequence[Mapping]] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        views = _ready_views(batch, state.device, VIEW_KEYS if two_views else VIEW_KEYS[::2])
        y = views["label"]
        d1, d2 = (*(draws or ()), {}, {})[:2]
        state.optimizer.zero_grad(set_to_none=True)

        logits, loss, feat1, aux = _normalize_output(model(
            views["fundus_low"], views["oct_low"], y, train=True, generator=generator, **d1))
        mmd = torch.zeros((), device=loss.device)
        if two_views:
            logits2, _, feat2, _ = _normalize_output(model(
                views["fundus_high"], views["oct_high"], y, train=True, generator=generator, **d2))
            mmd = t.mmd_weight * mmd_fn(feat1, feat2, t.mmd_kernel_mul, t.mmd_kernel_num)
            loss = loss + mmd
            if t.js_distillation_weight > 0.0:
                js = js_divergence(torch.softmax(logits, dim=-1), torch.softmax(logits2, dim=-1))
                loss = loss + t.js_distillation_weight * js
        loss.backward()
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        for p in params:
            # Parameters the loss does not reach (the train-mode pseudo-label
            # branch) still take Adam's decay, as their zero JAX gradients do.
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if t.grad_clip_norm > 0:
            torch.nn.utils.clip_grad_norm_(params, t.grad_clip_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        out = {"loss": loss.detach(), "mmd": mmd.detach(),
               "probs": torch.softmax(logits.detach().float(), dim=-1)}
        out.update({k: v.detach() for k, v in aux.items()})
        return out

    return train_step


def make_eval_step(cfg: EDRLConfig):
    """Eval on the low-noise view: ``eval_step(state, batch, modality_mask=None,
    *, draws=None)`` -> ``{"loss", "probs"}``.  ``draws``: ``MedFusion.forward``
    keyword arguments (``guided_uniform``, ``eprl_eps``); without them the
    model takes its eval-seed draws."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping, modality_mask=None, *,
                  draws: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
        views = _ready_views(batch, state.device, ("fundus_low", "oct_low"))
        kwargs = dict(draws or {})
        if modality_mask is not None:
            kwargs["modality_mask"] = _as_tensor(modality_mask, state.device)
        logits, loss, _, _ = _normalize_output(state.model(
            views["fundus_low"], views["oct_low"], views["label"], train=False, **kwargs))
        return {"loss": loss, "probs": torch.softmax(logits.float(), dim=-1)}

    return eval_step
