"""The train and eval steps and the fit loop (``edrl_tpu/train/trainer.py``).

One train step, as ``make_train_step`` builds it in the JAX package:

0. from a clean batch (``fundus``/``oct``, uint8 or f32): the dequantize,
   the fundus and OCT augmentations and the low- and high-noise views, on
   the batch's device (``data/device_augment.py``, ``data/device_noise.py``);
   a batch of ready-made views (the host-noise path) skips this;
1. the model (any name of ``baselines.MODEL_REGISTRY``; MedFusion by
   default) in train mode on the low-noise view;
2. the model in train mode on the high-noise view, from the batch
   statistics the first forward updated (its own loss is dropped);
3. ``mmd_weight`` x MK-MMD between the two feature batches (``[B, 3072]``
   for MedFusion)
   (``ops.mmd.mk_mmd``, or the fused kernel B3 with ``use_pallas_mmd``), plus
   the optional JS logit distillation;
4. the backward (through the B1/B2 backward kernels on the card);
5. Adam with the weight decay folded into the gradient and a linear warmup
   of ``min((step + 1) / warmup_steps, 1)`` (``make_optimizer``), at the
   member's learning rate for a deep-ensemble member (``ENSEMBLE_LRS``).

The −MMD ablation (``mmd_weight == 0``) skips the second forward only when
the JS weight is 0 as well.

Master weights stay f32; each Dense casts them per call, so a model that
trains must not go through ``layers.cast_dense_weights_`` (a serving-only
measure).  Unlike the JAX step, which returns a new state, ``train_step``
updates the state's model, optimizer and scheduler in place and leaves the
step's gradients in the parameters' ``.grad``.

``fit`` is the train&test loop: per-epoch train and val, best-accuracy
checkpoints, CSV logs, the plateau schedule, resume.  Each step's noise
comes from a generator seeded with ``(seed + 1000, step)``, as the JAX loop
folds the step into its base key, so a resumed run is step-identical to an
uninterrupted one.  What does not run refuses by name (``check_ported``):
under a model axis above 1, the fused kernels that read whole kernels, B5
and B6.

``scan_batches`` (the JAX package runs K steps per dispatch as one
``lax.scan``, on the same PRNG stream as per-batch dispatch) is accepted at
any K and changes nothing here: ``fit`` steps batch by batch, each step
from the generator reseeded at its step, so the run is the one of
``scan_batches = 0``.  It captures nothing.

Data parallelism (``mesh``: ``parallel.make_mesh``'s, one process per card):
each rank steps on its rows of the global batch with the data axis current
(``parallel.use_mesh``), so the MK-MMD, DILR's Barlow and the BatchNorms see
the global batch and every per-row draw is the global draw's rows; the
gradients are then averaged over the ranks in one flat all-reduce, and
under a model axis above 1 the replicated ones sent from model rank 0 to
the rest of its data row (``parallel.tensor.broadcast_replicated_grads_``),
before the clip and Adam, or ZeRO-1's sharded Adam (``cfg.train.zero1``,
above one rank).  The step returns the global loss and probabilities, ``run_eval``
the global metrics (a remainder batch padded as the JAX package pads it),
and ``fit`` prints, logs and plots on data rank 0 alone.  World N at global
batch B trains on the numbers of one card at batch B, to within the order
of the sums.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torch import nn

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.convert import load_flax_variables
from edrl_tpu_torch.data import device_augment, device_noise
from edrl_tpu_torch.models.layers import init_parameters
from edrl_tpu_torch.models.medfusion import MedFusion
from edrl_tpu_torch.ops.distributions import js_divergence
from edrl_tpu_torch.ops.mmd import mk_mmd
from edrl_tpu_torch.parallel.mesh import (
    AXES, all_reduce_mean_, gather_batches, gather_rows, is_writer, use_mesh, zero1_optimizer)
from edrl_tpu_torch.parallel.tensor import broadcast_replicated_grads_, clip_grad_norm_, shard_model_
from edrl_tpu_torch.train import metrics as metrics_lib
from edrl_tpu_torch.train.logging import AverageMeter, CsvMetricWriter

VIEW_KEYS = ("fundus_low", "fundus_high", "oct_low", "oct_high")
# The eval path's low view of a clean batch is drawn from this seed on every
# call, as the JAX package draws it from ``jax.random.key(123)``; torch cannot
# replay that stream, so only a view that draws nothing (sigma and amount 0,
# the CLI's default) is the JAX package's.
EVAL_NOISE_SEED = 123


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


def set_conv_precision(tf32: bool = False) -> None:
    """Settle, for the process, how the card computes f32 convolutions: in
    full f32 (the default, as the JAX package's f32 CNN baselines compute),
    or with ``tf32`` through cuDNN's TF32, which rounds their inputs to 10
    bits of mantissa and is on by default in PyTorch.

    The port's entry points call it once as they start (the CLIs' ``main``,
    ``Predictor``); nothing else touches the setting, so a caller that wants
    TF32 calls ``set_conv_precision(True)`` after those."""
    torch.backends.cudnn.allow_tf32 = tf32


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: torch finds no CUDA device")
    return device


def require_device(state: "TrainState", device) -> torch.device:
    """``resolve_device(device)``, refusing a state whose model lives elsewhere
    (an evaluation surface runs where its state is, and moves nothing)."""
    device = resolve_device(device)
    if state.device.type != device.type:
        raise ValueError(f"the state's model is on {state.device}, not on {device}")
    return state.device


def make_model(cfg: EDRLConfig, device="cuda") -> nn.Module:
    """The configured model (``cfg.model.model_name``) from the registry, on
    ``device``, its parameters not yet filled (``init_state`` fills them);
    an unknown name raises ``NameError``."""
    from edrl_tpu_torch.baselines.registry import build_baseline

    return build_baseline(cfg.model.model_name, cfg, device=device)[0]


def check_ported(cfg: EDRLConfig, mesh=None) -> None:
    """Refuse a model name the registry does not know (``NameError``), a
    ``mesh`` that is not a ``(data, model)`` ``DeviceMesh`` (``TypeError``)
    and, over a model axis above 1, what does not run there
    (``check_tensor_parallel``)."""
    from edrl_tpu_torch.baselines.registry import MODEL_REGISTRY

    if cfg.model.model_name not in MODEL_REGISTRY:
        raise NameError(f"There is no model named {cfg.model.model_name!r}")
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != AXES:
            raise TypeError(f"mesh must be parallel.make_mesh's (data, model) DeviceMesh, not {mesh!r}")
    model_axis = cfg.train.num_model_shards if mesh is None else mesh.size(1)
    if model_axis > 1:
        check_tensor_parallel(cfg, model_axis)


def check_tensor_parallel(cfg: EDRLConfig, model_axis: int) -> None:
    """Refuse, by name, what does not run over a model axis of ``model_axis``
    > 1: the kernels that read whole weights, B5 and B6 (``ValueError``: the
    JAX package turns them off there; the port does not turn a flag off
    quietly).  Every registry model runs there: the rules split what they
    name (``parallel.mesh.param_shardings``) and replicate the rest, a CNN
    model whole."""
    m = cfg.model
    for flag in ("use_fused_mlp", "use_fused_block_attention"):
        if getattr(m, flag):
            raise ValueError(f"{flag} over a model axis of {model_axis}: its kernel reads whole weights and does "
                             "not run on tensor-parallel shards (ROADMAP queue B: B5 and B6 on TP shards)")


def warmup_factor(step: int, warmup_steps: int) -> float:
    """The lr multiplier of optimizer step ``step`` (0-based)."""
    if warmup_steps <= 0:
        return 1.0
    return min((step + 1.0) / warmup_steps, 1.0)


def make_optimizer(params, cfg: EDRLConfig, mesh=None):
    """``(Adam, LambdaLR)``: Adam(lr, weight_decay) with decay folded into the
    gradient (optax ``add_decayed_weights`` before ``adam``) and the linear
    warmup as a LambdaLR, stepped once per optimizer step.  A deep-ensemble
    member (``Multi_DE{i}_ResNet``) takes its own lr from ``ENSEMBLE_LRS``.
    The plateau schedule edits the base lr under the warmup
    (``set_learning_rate``).  With ``cfg.train.zero1`` and a mesh of more
    than one data rank, Adam's moments are sharded over them
    (``parallel.zero1_optimizer``); on one rank ZeRO-1 is the plain Adam,
    as the JAX package shards nothing on one device."""
    from edrl_tpu_torch.baselines.registry import ENSEMBLE_LRS

    lr = ENSEMBLE_LRS.get(cfg.model.model_name, cfg.train.lr)
    if cfg.train.zero1 and mesh is not None and mesh.size(0) > 1:
        optimizer = zero1_optimizer(params, mesh, lr=lr, weight_decay=cfg.train.weight_decay)
    else:
        optimizer = torch.optim.Adam(params, lr=lr, weight_decay=cfg.train.weight_decay)
    w = cfg.train.warmup_steps
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: warmup_factor(step, w))
    return optimizer, scheduler


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and warmup schedule, and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the base lr under the warmup (the plateau schedule's move): the
    effective lr stays ``lr`` x the warmup factor, as in the JAX package's
    optax chain, where it edits the injected lr."""
    sched = state.scheduler
    for i, group in enumerate(state.optimizer.param_groups):
        sched.base_lrs[i] = lr
        group["initial_lr"] = lr
        group["lr"] = lr * sched.lr_lambdas[i](sched.last_epoch)
    sched._last_lr = [group["lr"] for group in state.optimizer.param_groups]
    return state


def get_learning_rate(state: TrainState) -> float:
    """The base lr under the warmup (inverse of ``set_learning_rate``)."""
    return float(state.scheduler.base_lrs[0])


class PlateauTracker:
    """ReduceLROnPlateau(mode=min, factor, patience), host side: it runs when
    ``use_plateau_schedule`` is on."""

    def __init__(self, lr: float, factor: float, patience: int):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, val_loss: float) -> Optional[float]:
        if val_loss < self.best - 1e-8:
            self.best = val_loss
            self.bad_epochs = 0
            return None
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.lr *= self.factor
            self.bad_epochs = 0
            return self.lr
        return None


def init_state(cfg: EDRLConfig, seed: int = 0, *, device="cuda",
               variables: Optional[Mapping] = None, mesh=None) -> TrainState:
    """The configured registry model and its optimizer on ``device`` (the card
    unless the caller asks for the CPU); ``mesh``: the data ranks a ZeRO-1
    optimizer shards over (``make_optimizer``), and a model axis above 1
    the model is sharded over (``parallel.tensor.shard_model_``).  Every
    rank makes the same seeded init, at full shape.

    ``variables``: ``{"params": ..., "batch_stats": ...}`` flax trees of numpy
    arrays (a JAX ``TrainState``'s), loaded with
    ``convert.load_flax_variables``; ``None`` gives the seeded flax-style
    init.
    """
    device = resolve_device(device)
    model = make_model(cfg, device)
    if variables is None:
        init_parameters(model, torch.Generator(device=device).manual_seed(seed))
    else:
        load_flax_variables(model, variables["params"], variables.get("batch_stats"))
    if mesh is not None and mesh.size(1) > 1:
        check_tensor_parallel(cfg, mesh.size(1))
        shard_model_(model, mesh)
    optimizer, scheduler = make_optimizer(model.parameters(), cfg, mesh)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch on ``device``: on a card, through pinned host
    memory and without blocking the host."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


def seed_step_generator(generator: torch.Generator, seed: int, *steps: int) -> torch.Generator:
    """Seed ``generator`` for train step ``step`` from ``(seed, step)`` (or for
    any other index tuple, e.g. MC-dropout's ``(seed, batch, k)``): the port's
    counterpart of ``jax.random.fold_in(key(seed), step)``."""
    return generator.manual_seed(int(np.random.SeedSequence([seed, *steps]).generate_state(1, np.uint64)[0]))


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


def train_views(batch: Mapping, cfg: EDRLConfig, device, generator: Optional[torch.Generator],
                draws: Optional[Mapping] = None, *, two_views: bool = True) -> Dict[str, torch.Tensor]:
    """The train step's views and labels on ``device``: all four, or with
    ``two_views`` off (the step skips its second forward) the low view only.

    A clean batch (``fundus``, ``oct``) is dequantized, augmented and
    corrupted here, in the order of the JAX step (``trainer.py:226-248``):
    the fundus augmentation, the OCT's, then the noise views.  Each stage
    takes its draws from ``draws`` (``"fundus_augment"``, ``"oct_augment"``,
    ``"views"``: the mappings of ``device_augment.draw_fundus_augment``,
    ``draw_oct_augment`` and ``device_noise.draw_views``) or else from
    ``generator``.  A batch of ready-made views passes through (dequantized).
    """
    label = _as_tensor(batch["label"], device).long()
    if "fundus" not in batch:
        keys = VIEW_KEYS if two_views else VIEW_KEYS[::2]
        return {**{k: _dequantize(_as_tensor(batch[k], device)) for k in keys}, "label": label}
    d, draws = cfg.data, draws or {}
    fundus = device_augment.augment_fundus_batch(
        _dequantize(_as_tensor(batch["fundus"], device)), generator, d.color_jitter_prob, d.color_jitter_strength,
        d.grayscale_prob, d.hflip_prob, draws=draws.get("fundus_augment"))
    oct_vol = device_augment.augment_oct_batch(_dequantize(_as_tensor(batch["oct"], device)), generator,
                                               d.hflip_prob, draws=draws.get("oct_augment"))
    view_draws = draws.get("views")
    if two_views:
        return {**device_noise.make_views_device(fundus, oct_vol, d.noise, generator, draws=view_draws),
                "label": label}
    f_low, o_low = device_noise.make_low_view_device(fundus, oct_vol, d.noise, generator,
                                                     draws=None if view_draws is None else view_draws["low"])
    return {"fundus_low": f_low, "oct_low": o_low, "label": label}


def make_train_step(cfg: EDRLConfig, mesh=None):
    """The dual-view train step for ``cfg``; with ``mesh``, a data-parallel
    rank's (see the module docstring): ``batch`` holds this rank's rows,
    the draws are the global batch's rows (``draws`` and ``input_draws``
    given ones: this rank's rows, EPRL's eps whole), and the result is the
    global batch's.

    Returns ``train_step(state, batch, generator, *, draws=None, input_draws=None)``.
    ``batch`` (numpy arrays or tensors) holds a clean ``fundus``, ``oct`` and
    ``label`` (uint8 or f32; see ``train_views``), or ready-made views
    ``fundus_low``, ``fundus_high``, ``oct_low``, ``oct_high`` and ``label``
    (uint8 views are dequantized).  The step's noise (augmentation and
    noise draws, MedFusion's guided uniforms and EPRL eps, dropout masks)
    comes from ``generator``, a ``torch.Generator`` on the model's device, as
    the JAX step takes a key.  Given tensors override it: ``draws``, one
    mapping per forward with the model's keyword arguments for them
    (MedFusion: ``guided_uniform``, ``eprl_eps``, ``dropout_masks``; a
    baseline: ``dropout_masks``), and ``input_draws``, the
    clean batch's augmentation and noise draws (``train_views``).  Without
    a second forward (``mmd_weight`` and the JS weight 0) the step copies
    and builds the low view only.  Returns ``{"loss", "mmd", "probs",
    **aux}``, detached.
    """
    t = cfg.train
    if t.use_pallas_mmd:
        from edrl_tpu_torch.kernels.mmd import mk_mmd_fused as mmd_fn
    else:
        mmd_fn = mk_mmd
    two_views = t.mmd_weight != 0.0 or t.js_distillation_weight != 0.0

    def train_step(state: TrainState, batch: Mapping, generator: torch.Generator, *,
                   draws: Optional[Sequence[Mapping]] = None,
                   input_draws: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        d1, d2 = (*(draws or ()), {}, {})[:2]
        state.optimizer.zero_grad(set_to_none=True)
        with use_mesh(mesh):
            views = train_views(batch, cfg, state.device, generator, input_draws, two_views=two_views)
            y = views["label"]
            logits, loss, feat1, aux = _normalize_output(model(
                views["fundus_low"], views["oct_low"], y, train=True, generator=generator, **d1))
            mmd = torch.zeros((), device=loss.device)
            if two_views:
                logits2, _, feat2, _ = _normalize_output(model(
                    views["fundus_high"], views["oct_high"], y, train=True, generator=generator, **d2))
                mmd = t.mmd_weight * mmd_fn(gather_rows(feat1), gather_rows(feat2), t.mmd_kernel_mul,
                                            t.mmd_kernel_num)
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
        if mesh is not None:
            all_reduce_mean_([p.grad for p in params], mesh)
            broadcast_replicated_grads_(model, params, mesh)
        if t.grad_clip_norm > 0:
            clip_grad_norm_(model, params, t.grad_clip_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        out = {"loss": loss.detach(), "mmd": mmd.detach(),
               "probs": torch.softmax(logits.detach().float(), dim=-1)}
        out.update({k: v.detach() for k, v in aux.items()})
        return out if mesh is None else _global_outputs(out, mesh)

    return train_step


def _global_outputs(out: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """A data-parallel step's results as the global batch's: each scalar
    (a mean over this rank's rows, or a global term) averaged over the
    ranks in one all-reduce, the probabilities gathered in rank order."""
    keys = [k for k in out if k != "probs"]
    scalars = torch.stack([out[k].float() for k in keys])
    all_reduce_mean_([scalars], mesh)
    result = dict(zip(keys, scalars.unbind()))
    result["probs"] = gather_batches(out["probs"], out["probs"].shape[0], mesh)
    return result


def eval_low_view(batch: Mapping, cfg: EDRLConfig, device,
                  draws: Optional[Mapping] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval path's low-noise view (``fusion_train.py:277``).  A host-noise
    batch carries it (``fundus_low``, ``oct_low``); a clean batch gets it
    here, from ``draws`` (``device_noise.draw_corruption``'s) or else from a
    generator seeded with ``EVAL_NOISE_SEED`` on every call."""
    if "fundus_low" in batch:
        return (_dequantize(_as_tensor(batch["fundus_low"], device)),
                _dequantize(_as_tensor(batch["oct_low"], device)))
    fundus = _dequantize(_as_tensor(batch["fundus"], device))
    oct_vol = _dequantize(_as_tensor(batch["oct"], device))
    gen = None if draws is not None else torch.Generator(device=fundus.device).manual_seed(EVAL_NOISE_SEED)
    return device_noise.make_low_view_device(fundus, oct_vol, cfg.data.noise, gen, draws=draws)


def make_eval_step(cfg: EDRLConfig):
    """Eval on the low-noise view: ``eval_step(state, batch, modality_mask=None,
    *, draws=None)`` -> ``{"loss", "probs"}``.  ``draws``: ``MedFusion.forward``
    keyword arguments (``guided_uniform``, ``eprl_eps``), and under
    ``"low_view"`` the low view's noise (``eval_low_view``); what is absent,
    the model takes from its eval seed.  The missing-modality mask goes to
    MedFusion, which excludes the expert; any other model gets the absent
    modality's input zeroed."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping, modality_mask=None, *,
                  draws: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
        kwargs = dict(draws or {})
        fundus, oct_vol = eval_low_view(batch, cfg, state.device, kwargs.pop("low_view", None))
        if modality_mask is not None:
            mask = _as_tensor(modality_mask, state.device)
            if isinstance(state.model, MedFusion):
                kwargs["modality_mask"] = mask
            else:
                fundus = fundus * mask[0].to(fundus.dtype)
                oct_vol = oct_vol * mask[1].to(oct_vol.dtype)
        label = _as_tensor(batch["label"], state.device).long()
        logits, loss, _, _ = _normalize_output(state.model(fundus, oct_vol, label, train=False, **kwargs))
        return {"loss": loss, "probs": torch.softmax(logits.float(), dim=-1)}

    return eval_step


@dataclasses.dataclass
class FitResult:
    train_history: list
    val_history: list
    best_acc: float
    best_epoch: int


def _check_loader(loader, mesh) -> None:
    """A data-parallel pass needs this rank's loader of the mesh's world."""
    world = 1 if mesh is None else mesh.size(0)
    if getattr(loader, "world", 1) != world:
        raise ValueError(f"the loader splits its batches over {getattr(loader, 'world', 1)} ranks, "
                         f"the mesh has {world}")


def run_eval(state: TrainState, eval_step, loader, epoch: int = 0,
             modality_mask: Optional[np.ndarray] = None,
             mesh=None) -> Tuple[metrics_lib.EpochMetrics, np.ndarray, np.ndarray]:
    """One pass of ``eval_step`` over ``loader``: the epoch metrics, targets
    and probabilities.  The epoch loss weights each batch by its rows (the
    remainder batch counts only its own); losses and probabilities stay on
    the device until the pass ends.  An empty loader gives NaN metrics.

    With ``mesh``, ``loader`` gives this rank's rows (``BatchLoader(...,
    rank, world)``, a remainder batch padded by repeating its last sample);
    each rank evaluates them with the data axis current, and every rank
    gets the global batch's probabilities, targets and loss (the padded
    rows' probabilities dropped, the loss averaged over them as the JAX
    package's mesh ``run_eval`` averages it)."""
    _check_loader(loader, mesh)
    targets, dev_probs, dev_losses, real_sizes = [], [], [], []
    loss_meter = AverageMeter()
    for i, batch in enumerate(loader.epoch(epoch)):
        arrays = to_device(batch, state.device)
        with use_mesh(mesh):
            out = eval_step(state, arrays) if modality_mask is None else eval_step(state, arrays, modality_mask)
        if mesh is None:
            targets.append(np.asarray(batch["label"]))
            real_sizes.append(int(batch["label"].shape[0]))
            dev_probs.append(out["probs"])
            dev_losses.append(out["loss"])
            continue
        n, rows = loader.rows(i), out["probs"].shape[0]
        targets.append(gather_batches(arrays["label"], rows, mesh)[:n])
        real_sizes.append(n)
        dev_probs.append(gather_batches(out["probs"], rows, mesh)[:n])
        loss = out["loss"].float().reshape(1)
        all_reduce_mean_([loss], mesh)
        dev_losses.append(loss[0])
    if not targets:
        nan = float("nan")
        empty = metrics_lib.EpochMetrics(nan, nan, nan, nan, nan, nan, nan)
        return empty, np.zeros((0,), np.int64), np.zeros((0, 2))
    probs = torch.cat(dev_probs).cpu().numpy()
    for loss, n in zip(torch.stack(dev_losses).float().cpu().tolist(), real_sizes):
        loss_meter.update(loss, n=n)
    targets = np.concatenate(targets) if mesh is None else torch.cat(targets).cpu().numpy()
    return metrics_lib.compute_epoch_metrics(targets, probs, loss_meter.avg), targets, probs


def resume_from_latest(cfg: EDRLConfig, checkpoint_manager, train_loader, *, device="cuda", mesh=None):
    """Preemption resume: restore the rolling ``latest`` checkpoint and work
    out where to go on.

    Returns ``(state, cfg, initial_best, completed_epochs)`` with
    ``cfg.train.start_epoch`` moved past the completed epochs, or ``None``
    when there is nothing to resume.  The completed epochs come from the
    restored step count (one step per batch, ``len(train_loader)`` per
    epoch).  The loader's shuffles are epoch-indexed and each step's noise
    is seeded from the step, so the resumed run is step-identical to an
    uninterrupted one; the plateau tracker starts from the restored lr.
    With ``mesh`` every rank restores (and a ZeRO-1 rank keeps its shard)."""
    if checkpoint_manager.latest_info() is None:
        return None
    state = checkpoint_manager.restore(init_state(cfg, cfg.train.seed, device=device, mesh=mesh), "latest")
    done = state.step // max(1, len(train_loader))
    best = checkpoint_manager.best_info()
    initial_best = float(best["accuracy"]) if best else 0.0
    # Offset by the configured start epoch: shuffles key on the absolute epoch.
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, start_epoch=cfg.train.start_epoch + done))
    return state, cfg, initial_best, done


def fit(
    cfg: EDRLConfig,
    train_loader,
    val_loader,
    state: Optional[TrainState] = None,
    mesh=None,
    checkpoint_manager=None,
    verbose: bool = True,
    initial_best: float = 0.0,
    initial_best_epoch: int = -1,
    *,
    device="cuda",
) -> Tuple[TrainState, FitResult]:
    """The train&test loop (``fusion_train.py:754-772``): per-epoch train,
    val on the low-noise view, best-accuracy checkpoints, CSV logs.

    ``state``: where to start (a fresh ``init_state`` on ``device`` if
    ``None``).  ``initial_best``/``initial_best_epoch``: the best val
    accuracy (and its epoch) to beat, set on resume.  ``mesh``: data
    parallelism (see the module docstring); the loaders are this rank's
    (``BatchLoader(..., rank, world)``), every rank calls the checkpoint
    manager (``CheckpointManager(..., mesh=mesh)``: rank 0 writes), and data
    rank 0 alone prints, writes the CSV and plots.  ``cfg.train.scan_batches``
    changes nothing (see the module docstring).
    """
    check_ported(cfg, mesh)
    _check_loader(train_loader, mesh)
    if checkpoint_manager is not None and getattr(checkpoint_manager, "mesh", None) is not mesh:
        raise ValueError("the checkpoint manager must be made with fit's mesh: under a mesh rank 0 alone writes")
    if state is None:
        state = init_state(cfg, cfg.train.seed, device=device, mesh=mesh)
    device = state.device
    train_step = make_train_step(cfg, mesh)
    eval_step = make_eval_step(cfg)
    generator = torch.Generator(device=device)
    base_seed = cfg.train.seed + 1000
    writes = is_writer(mesh)
    verbose = verbose and writes

    writer = None
    if cfg.train.log_dir and writes:
        os.makedirs(cfg.train.log_dir, exist_ok=True)
        writer = CsvMetricWriter(os.path.join(
            cfg.train.log_dir, f"{cfg.data.dataset}_{cfg.data.noise.gaussian_high}_{cfg.train.name}.csv"))
        if cfg.train.resume and cfg.train.start_epoch > 1:
            # Epochs re-run after the restored `latest` re-write their rows.
            writer.drop_rows_from(cfg.train.start_epoch)

    plateau = None
    if cfg.train.use_plateau_schedule:
        # From the state's live lr: a resumed state carries its reductions.
        plateau = PlateauTracker(get_learning_rate(state), cfg.train.plateau_factor, cfg.train.plateau_patience)

    best_acc, best_epoch = initial_best, initial_best_epoch
    train_hist, val_hist = [], []
    for epoch in range(cfg.train.start_epoch, cfg.train.end_epochs + 1):
        loss_meter = AverageMeter()
        # Losses and probabilities stay on the device and are read once the
        # epoch is done: a read per step would make the host wait for each
        # step before it enqueues the next.
        targets, dev_losses, dev_probs = [], [], []
        t0 = time.time()
        for batch in train_loader.epoch(epoch):
            seed_step_generator(generator, base_seed, state.step)
            out = train_step(state, to_device(batch, device), generator)
            dev_losses.append(out["loss"])
            dev_probs.append(out["probs"])
            targets.append(np.asarray(batch["label"]))
        probs = torch.cat(dev_probs).cpu().numpy()
        for loss in torch.stack(dev_losses).float().cpu().tolist():
            loss_meter.update(loss)
        targets = np.concatenate(targets)
        if mesh is not None:
            # One gather of the epoch's labels, each batch's in rank order.
            local = torch.from_numpy(targets).to(device)
            targets = gather_batches(local, train_loader.batch_size // mesh.size(0), mesh).cpu().numpy()
        epoch_time = time.time() - t0
        em = metrics_lib.compute_epoch_metrics(targets, probs, loss_meter.avg)
        train_hist.append(em)
        if writer:
            writer.write(epoch, em)
        if verbose:
            print(f"Train Epoch: {epoch} \tLoss: {em.loss:.6f} \t"
                  f"Accuracy: {em.accuracy:.4f} \tAUC: {em.auc:.4f} \t"
                  f"({len(targets) / max(epoch_time, 1e-9):.2f} pairs/s)", flush=True)

        vm, _, _ = run_eval(state, eval_step, val_loader, epoch, mesh=mesh)
        val_hist.append(vm)
        if verbose:
            print(f"Val   Epoch: {epoch} \tLoss: {vm.loss:.6f} \t"
                  f"Accuracy: {vm.accuracy:.4f} \tAUC: {vm.auc:.4f}", flush=True)
        if vm.accuracy > best_acc:
            best_acc, best_epoch = vm.accuracy, epoch
            if checkpoint_manager is not None:
                checkpoint_manager.save_best(state, epoch, best_acc)
        if checkpoint_manager is not None and cfg.train.save_every > 0 and epoch % cfg.train.save_every == 0:
            checkpoint_manager.save(state, name=f"epoch_{epoch}")
        if (checkpoint_manager is not None and cfg.train.save_latest_every > 0
                and epoch % cfg.train.save_latest_every == 0):
            checkpoint_manager.save_latest(state, epoch)
        if plateau is not None:
            # "accuracy" negates so the min-mode tracker maximizes it.
            signal = -vm.accuracy if cfg.train.plateau_metric == "accuracy" else vm.loss
            new_lr = plateau.step(signal)
            if new_lr is not None:
                set_learning_rate(state, new_lr)
                if verbose:
                    print(f"Plateau: reducing lr to {new_lr:g}", flush=True)
        if writes and cfg.train.plot_dir and cfg.train.student_t_every > 0 and epoch % cfg.train.student_t_every == 0:
            from edrl_tpu_torch.train.visualize import dump_proxy_distributions

            dump_proxy_distributions(state.model, cfg.model, epoch, cfg.train.plot_dir)

    if writes and cfg.train.plot_dir and train_hist:
        # End-of-run curves (``fusion_train.py:771-772``); the acc curve is the
        # per-epoch val accuracy.
        from edrl_tpu_torch.train.visualize import loss_plot, metrics_plot

        stem = f"{cfg.model.model_name}_{cfg.data.batch_size}_{cfg.data.dataset}_{cfg.train.end_epochs}"
        loss_plot([m.loss for m in train_hist], os.path.join(cfg.train.plot_dir, f"{stem}_loss.jpg"))
        metrics_plot({"acc": [m.accuracy for m in val_hist]}, os.path.join(cfg.train.plot_dir, f"{stem}_acc.jpg"))

    if checkpoint_manager is not None:
        # The last write in flight lands before a caller reads `best`.
        checkpoint_manager.wait()
    return state, FitResult(train_hist, val_hist, best_acc, best_epoch)
