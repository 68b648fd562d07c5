"""The ranks of ``test_torch_parallel.py``: a world of gloo processes on the
CPU that run every data- and tensor-parallel case once and send their
results back.

Imports torch and the port only (no JAX).  ``run(rank, world, port, inbox,
outbox, workdir)`` joins the group and builds two meshes over it, the data
mesh ``(2, 1)`` and the tensor-parallel mesh ``(1, 2)``; it runs ``PHASE1``
and ``TP_PHASE1`` (cases that need nothing from JAX), posts ``(rank,
"phase1", results)``, waits for JAX's recorded draws on ``inbox``, runs
``PHASE2`` and ``TP_PHASE2`` with them and posts ``(rank, "phase2",
results)``.  A case that raises posts its traceback under its name; the
parent fails that case's test with it.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import traceback

import numpy as np
import torch

from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch import parallel
from edrl_tpu_torch.parallel import mesh as pmesh

BATCH = 4  # the MedFusion step's global batch (2 per rank)
NUM_VAL = 5  # run_eval's samples: batches of 4 and 1 (padded to 2 at world 2)


def tiny(batch=BATCH, **train):
    cfg = tconfig.tiny_test_config(batch_size=batch)
    return cfg.replace(train=dataclasses.replace(cfg.train, **train))


# The tensor-parallel cases' model: the tiny config with Swin's stage 0 and
# ViT of 1 head each, so that at a model axis of 2 both take the gathered
# route and Swin's stage 1 and DILR's attention the head-local one, and B1
# and B2 on (their plain versions on the CPU), as in the shipped config.
TP_MODEL = dict(swin_heads=(1, 4), vit3d_heads=1, use_fused_attention=True, vit_fused_attention=True)


def tiny_tp(batch=BATCH, **train):
    cfg = tiny(batch, **train)
    return cfg.replace(model=dataclasses.replace(cfg.model, **TP_MODEL))


# The fused flags' cases: widths that B4 and B5 take (multiples of 128).
FUSED_MODEL = dict(swin_embed_dim=128, swin_heads=(1, 2), fundus_embed_dim=256, oct_embed_dim=128, vit3d_heads=1,
                   vit3d_depth=1)


def tiny_fused(flag, batch=BATCH):
    cfg = tiny(batch)
    return cfg.replace(model=dataclasses.replace(cfg.model, **FUSED_MODEL, **{flag: True}))


def medfusion_state(cfg, variables=None, mesh=None):
    """MedFusion from JAX's ``variables`` (numpy flax trees), or the seeded init."""
    from edrl_tpu_torch.train import trainer

    return trainer.init_state(cfg, device="cpu", variables=variables, mesh=mesh)


def step_batch(cfg, seed=0):
    """Ready-made f32 views and labels of the global batch (numpy)."""
    rng = np.random.default_rng(seed)
    d, b = cfg.data, cfg.data.batch_size
    batch = {k: rng.uniform(size=(b, d.fundus_size, d.fundus_size, 3)).astype(np.float32)
             for k in ("fundus_low", "fundus_high")}
    batch.update({k: rng.uniform(size=(b, *d.oct_size, 1)).astype(np.float32) for k in ("oct_low", "oct_high")})
    batch["label"] = (np.arange(b) % 2).astype(np.int32)
    return batch


def _np(t):
    return t.detach().double().cpu().numpy()


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters()}


def moment_bytes(optimizer) -> int:
    """The bytes of Adam's moments this rank holds (its shard under ZeRO-1)."""
    inner = optimizer.optim if pmesh.is_zero1(optimizer) else optimizer
    return sum(t.numel() * t.element_size() for s in inner.state.values() for t in s.values()
               if isinstance(t, torch.Tensor) and t.dim() > 0)


def _buffers(model):
    return {n: _np(b) for n, b in model.named_buffers() if b.is_floating_point()}


# ---------------------------------------------------------------------------
# Phase 1: nothing from JAX.
# ---------------------------------------------------------------------------


def case_losses(mesh, workdir):
    """MK-MMD and Barlow on the gathered rows: values, and the gradients of
    this rank's rows (divided by the world, as the average over the ranks
    divides them)."""
    from edrl_tpu_torch.ops.correlation import barlow_block_loss
    from edrl_tpu_torch.ops.mmd import mk_mmd

    rng = np.random.default_rng(0)
    s, t = (rng.normal(size=(16, 32)).astype(np.float32) for _ in range(2))
    z1, z2 = (rng.normal(size=(32, 16)).astype(np.float32) for _ in range(2))
    local = [torch.tensor(a).requires_grad_(True) for a in parallel.shard_batch({"s": s, "t": t, "z1": z1,
                                                                                 "z2": z2}, mesh).values()]
    with parallel.use_mesh(mesh):
        ls, lt, lz1, lz2 = local
        mmd = mk_mmd(parallel.gather_rows(ls), parallel.gather_rows(lt))
        g1, g2 = parallel.gather_rows(lz1), parallel.gather_rows(lz2)
        barlow = barlow_block_loss(g1, g2, common_dim=8, batch_divisor=4.0 * g1.shape[0])[0]
        (mmd + barlow).backward()
    world = mesh.size(0)
    return {"mmd": float(mmd), "barlow": float(barlow), "grads": [_np(x.grad) / world for x in local]}


def case_batchnorm(mesh, workdir):
    """DILR's and conv's BatchNorm in train mode on this rank's rows, the
    objective a mean over the rows: outputs, running statistics, input
    gradients (divided by the world) and the scale and bias gradients
    (averaged over the ranks), beside the global batch's in one process."""
    from edrl_tpu_torch.models import conv, dilr

    rng = np.random.default_rng(1)
    shapes = {"dilr": (8, 16), "conv": (4, 3, 3, 5)}
    out = {}
    for name, shape in shapes.items():
        x = rng.normal(loc=0.5, size=shape).astype(np.float32)
        w = rng.normal(size=shape).astype(np.float32)
        results = {}
        for where in ("global", "ranks"):
            bn = dilr.BatchNorm(shape[-1]) if name == "dilr" else conv.BatchNorm(shape[-1])
            with torch.no_grad():
                bn.flax_init_(None)
                if name == "conv":
                    bn.weight.copy_(torch.linspace(0.5, 1.5, shape[-1]))
                    bn.bias.copy_(torch.linspace(-0.2, 0.2, shape[-1]))
            if where == "global":
                xs, ws = torch.tensor(x), torch.tensor(w)
            else:
                xs, ws = (torch.tensor(a) for a in parallel.shard_batch({"x": x, "w": w}, mesh).values())
            xs.requires_grad_(True)
            with parallel.use_mesh(mesh if where == "ranks" else None):
                y = bn(xs, train=True)
                (y * ws).reshape(shape[0] // (1 if where == "global" else mesh.size(0)), -1).sum(1).mean().backward()
            params = [p.grad for p in bn.parameters()]
            if where == "ranks" and params:
                parallel.all_reduce_mean_(params, mesh)
            results[where] = {
                "y": _np(y), "x_grad": _np(xs.grad) / (1 if where == "global" else mesh.size(0)),
                "stats": [_np(bn.running_mean), _np(bn.running_var)], "params": [_np(g) for g in params]}
        out[name] = results
    return out


def case_dilr(mesh, workdir):
    """DILR in train mode (its BatchNorms, the gathered Barlow with the
    global divisor) on this rank's rows against the global batch: outputs,
    the loss, running statistics and the inputs' gradients of the loss plus a
    mean over the rows of the outputs."""
    from edrl_tpu_torch.models import dilr
    from edrl_tpu_torch.models.layers import init_parameters

    kw = dict(fundus_dim=32, oct_dim=24, feature_dim=64, guided_in_dim=16, num_heads=4)
    rng = np.random.default_rng(3)
    b = 4
    args = {"ft": rng.normal(size=(b, 9, 32)), "ot": rng.normal(size=(b, 8, 24)), "sh": rng.normal(size=(b, 32)),
            "fg": rng.normal(size=(b, 16)), "og": rng.normal(size=(b, 16))}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    w = rng.normal(size=(b, 96)).astype(np.float32)
    results = {}
    for where in ("global", "ranks"):
        model = dilr.DILR(**kw)
        init_parameters(model, torch.Generator().manual_seed(0))
        inputs = dict(args, w=w) if where == "global" else parallel.shard_batch(dict(args, w=w), mesh)
        tensors = {k: torch.tensor(v).requires_grad_(k != "w") for k, v in inputs.items()}
        with parallel.use_mesh(mesh if where == "ranks" else None):
            combined, loss = model(*(tensors[k] for k in ("ft", "ot", "sh", "fg", "og")), train=True)
            (loss + (combined * tensors["w"]).sum(1).mean()).backward()
        world = 1 if where == "global" else mesh.size(0)
        results[where] = {
            "combined": _np(combined), "loss": float(loss),
            "stats": [_np(b) for b in model.buffers()],
            "grads": {k: _np(t.grad) / world for k, t in tensors.items() if k != "w"}}
    return results


def case_zero1(mesh, workdir):
    """Two MedFusion steps with ZeRO-1 against the replicated steps (the
    same seeds): parameters, and each rank's share of the moment bytes; the
    ZeRO-1 state saved by rank 0 (consolidated) restores on one process to
    the replicated run's optimizer state."""
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    states, byte_shares = {}, {}
    for zero1 in (False, True):
        cfg = tiny(zero1=zero1)
        state = medfusion_state(cfg, mesh=mesh)
        step = trainer.make_train_step(cfg, mesh)
        gen = torch.Generator()
        for i in range(2):
            trainer.seed_step_generator(gen, 1000, i)
            step(state, parallel.shard_batch(step_batch(cfg, seed=i), mesh), gen)
        states[zero1] = state
        byte_shares[zero1] = moment_bytes(state.optimizer)
    directory = os.path.join(workdir, "zero1")
    CheckpointManager(directory, mesh=mesh).save(states[True], "latest")
    CheckpointManager(directory, mesh=mesh).wait()
    out = {"is_zero1": pmesh.is_zero1(states[True].optimizer), "bytes": byte_shares,
           "param_diff": max(float((a - b).abs().max()) for a, b in
                             zip(states[False].model.parameters(), states[True].model.parameters()))}
    if mesh.get_local_rank("data") == 0:
        one = CheckpointManager(directory).restore(trainer.init_state(tiny(), device="cpu"), "latest")
        want, got = states[False].optimizer.state_dict()["state"], one.optimizer.state_dict()["state"]
        out["restored_moment_diff"] = max(float((want[k][f] - got[k][f]).abs().max())
                                          for k in want for f in ("exp_avg", "exp_avg_sq"))
        out["restored_param_diff"] = max(float((a - b).abs().max()) for a, b in
                                         zip(states[True].model.parameters(), one.model.parameters()))
    return out


def _fit(cfg, mesh, directory, resume=False, end_epochs=2):
    from edrl_tpu_torch.data import BatchLoader, SyntheticGammaDataset
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    cfg = cfg.replace(train=dataclasses.replace(cfg.train, end_epochs=end_epochs, log_dir=os.path.join(
        directory, "log"), plot_dir="", save_latest_every=1, resume=resume, name="dp"))
    rank, world = mesh.get_local_rank("data"), mesh.size(0)
    data = dataclasses.replace(cfg.data, num_synthetic_samples=8, device_noise=True)
    train = BatchLoader(SyntheticGammaDataset(data, "train"), 4, seed=0, num_workers=2, uint8_transport=True,
                        rank=rank, world=world)
    val = BatchLoader(SyntheticGammaDataset(dataclasses.replace(data, num_synthetic_samples=NUM_VAL), "val"), 4,
                      shuffle=False, drop_last=False, num_workers=2, uint8_transport=True, rank=rank, world=world)
    mgr = CheckpointManager(os.path.join(directory, "ckpt"), mesh=mesh)
    state, best, best_epoch = None, 0.0, -1
    if resume:
        state, cfg, best, _ = trainer.resume_from_latest(cfg, mgr, train, device="cpu", mesh=mesh)
        best_epoch = mgr.best_info()["epoch"] if mgr.best_info() else -1
    state, result = trainer.fit(cfg, train, val, state=state, mesh=mesh, checkpoint_manager=mgr, verbose=False,
                                initial_best=best, initial_best_epoch=best_epoch, device="cpu")
    return state, result


def case_fit(mesh, workdir):
    """fit for 2 epochs at world 2 (rank 0 writes one CSV and one checkpoint
    tree, restorable in one process), and a run stopped after epoch 1 and
    resumed, which must end bit-equal to it."""
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    cfg = tiny()
    whole, result = _fit(cfg, mesh, os.path.join(workdir, "fit_whole"))
    _fit(cfg, mesh, os.path.join(workdir, "fit_resumed"), end_epochs=1)
    resumed, _ = _fit(cfg, mesh, os.path.join(workdir, "fit_resumed"), resume=True)
    diffs = [float((a - b).abs().max()) for a, b in zip(whole.model.state_dict().values(),
                                                      resumed.model.state_dict().values())]
    opt_a, opt_b = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    diffs += [float((opt_a[k][f] - opt_b[k][f]).abs().max()) for k in opt_a for f in ("exp_avg", "exp_avg_sq")]
    out = {"resume_diff": max(diffs), "steps": (whole.step, resumed.step),
           "val": [m.as_dict() for m in result.val_history], "train": [m.as_dict() for m in result.train_history]}
    if mesh.get_local_rank("data") == 0:
        one = CheckpointManager(os.path.join(workdir, "fit_whole", "ckpt")).restore(
            trainer.init_state(cfg, device="cpu"), "latest")
        out["restored_diff"] = max(float((a - b).abs().max()) for a, b in zip(
            whole.model.state_dict().values(), one.model.state_dict().values()))
    return out


def case_fit_zero1(mesh, workdir):
    """fit with ZeRO-1 at world 2, stopped after epoch 1 and resumed (each
    rank loads the consolidated checkpoint and keeps its shard), against the
    uninterrupted replicated run of ``case_fit`` (its last checkpoint; a
    ZeRO-1 step equals the replicated one): parameters on every rank, and
    the moments consolidated on rank 0, which also restores the resumed
    run's checkpoint in one process."""
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    cfg = tiny(zero1=True)
    directory = os.path.join(workdir, "fit_zero1")
    _fit(cfg, mesh, directory, end_epochs=1)
    resumed, result = _fit(cfg, mesh, directory, resume=True)
    whole = CheckpointManager(os.path.join(workdir, "fit_whole", "ckpt")).restore(
        trainer.init_state(tiny(), device="cpu"), "latest")
    out = {"is_zero1": pmesh.is_zero1(resumed.optimizer), "steps": (whole.step, resumed.step),
           "param_diff": max(float((a - b).abs().max()) for a, b in zip(
               whole.model.state_dict().values(), resumed.model.state_dict().values())),
           "train": [m.as_dict() for m in result.train_history]}
    resumed.optimizer.consolidate_state_dict(to=0)
    if mesh.get_local_rank("data") == 0:
        want, got = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
        out["moment_diff"] = max(float((want[k][f] - got[k][f]).abs().max())
                                 for k in want for f in ("exp_avg", "exp_avg_sq"))
        one = CheckpointManager(os.path.join(directory, "ckpt")).restore(
            trainer.init_state(tiny(), device="cpu"), "latest")
        out["restored_diff"] = max(float((a - b).abs().max()) for a, b in zip(
            resumed.model.state_dict().values(), one.model.state_dict().values()))
    return out


def case_sweep(mesh, workdir):
    """The robustness sweep over 5 samples (batches of 4 and 1, the last
    padded to 2) at world 2; rank 0 adds world 1's."""
    from edrl_tpu_torch.train.robustness import noise_sweep

    cfg = tiny()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_synthetic_samples=NUM_VAL, eval_batch_size=BATCH))
    state = medfusion_state(cfg)
    kw = dict(sigmas=(0.0, 0.3), device="cpu")
    out = {"ranks": noise_sweep(cfg, state, mesh=mesh, **kw)}
    if mesh.get_local_rank("data") == 0:
        out["one"] = noise_sweep(cfg, state, **kw)
    return out


def _resnet():
    """Multi_ResNet at global batch 8 (fundus 32^2, OCT 16^3), its seeded
    weights with BN statistics and affine parameters perturbed, and a batch."""
    from edrl_tpu_torch.baselines import build_baseline
    from edrl_tpu_torch.models.layers import init_parameters

    cfg = tconfig.tiny_test_config(batch_size=8)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, fundus_size=32, oct_size=(16,) * 3),
                      model=dataclasses.replace(cfg.model, model_name="Multi_ResNet"))
    model, _ = build_baseline("Multi_ResNet", cfg, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_var") and hasattr(m, "weight"):
                n = m.weight.shape
                m.weight.copy_(0.75 + 0.5 * torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return cfg, model, step_batch(cfg, seed=2)


def resnet_step(resnet, batch, mesh=None, double=False, reverse=False):
    """One train step of ``_resnet()``'s Multi_ResNet, in f64 with ``double``,
    on the batch reversed with ``reverse`` (the probabilities put back in its
    order): ``(out, grads, statistics)`` as f64 numpy by torch name."""
    from edrl_tpu_torch.train import trainer

    cfg, model, _ = resnet
    model = copy.deepcopy(model)
    state = trainer.TrainState(model, *trainer.make_optimizer(model.parameters(), cfg, mesh))
    if double:
        state.model.double()
    if reverse:
        batch = {k: v[::-1].copy() for k, v in batch.items()}
    out = trainer.make_train_step(cfg, mesh)(state, batch, torch.Generator().manual_seed(0))
    if reverse:
        out["probs"] = out["probs"].flip(0)
    return ({k: _np(v) for k, v in out.items()}, _grads(state.model), _buffers(state.model))


def resnet_references(outbox) -> None:
    """The one-process Multi_ResNet steps the CNN rule holds the ranks' to:
    f64, and f32 in the batch's order and reversed; posted as ``("one",
    "resnet", ...)``.  Runs in a process of its own beside the ranks."""
    torch.set_num_threads(1)
    try:
        resnet = _resnet()
        result = {"f64": resnet_step(resnet, resnet[2], double=True),
                  "f32": [resnet_step(resnet, resnet[2]), resnet_step(resnet, resnet[2], reverse=True)]}
    except Exception:
        result = {"error": traceback.format_exc()}
    outbox.put(("one", "resnet", result))


def case_resnet(mesh, workdir):
    """The Multi_ResNet train step (its conv BatchNorms synced) at global
    batch 8 on this rank's rows."""
    resnet = _resnet()
    return resnet_step(resnet, parallel.shard_batch(resnet[2], mesh), mesh)


def case_predictor_refuses(mesh, workdir):
    """A serving batch that does not split over the ranks raises ValueError."""
    from edrl_tpu_torch.serve.predictor import Predictor

    cfg = tiny(batch=3)
    try:
        Predictor(cfg, device="cpu", mesh=mesh)
    except ValueError as exc:
        return str(exc)
    return None


def case_fused_flags(mesh, workdir):
    """One step of B4, B5 and B6's configs (``tiny_fused``) at world 2 on
    the data mesh, with its global results and averaged gradients; rank 0
    adds world 1's on the same batch and draws."""
    from edrl_tpu_torch.train import trainer

    out = {}
    for flag in ("use_fused_ln", "use_fused_mlp", "use_fused_block_attention"):
        cfg = tiny_fused(flag)
        results = {}
        for where, m in (("ranks", mesh), ("one", None)):
            if where == "one" and mesh.get_local_rank("data") != 0:
                continue
            state = medfusion_state(cfg, mesh=m)
            batch = step_batch(cfg, seed=3)
            step = trainer.make_train_step(cfg, m)
            got = step(state, batch if m is None else parallel.shard_batch(batch, m),
                       torch.Generator().manual_seed(11))
            results[where] = {"out": {k: _np(v) for k, v in got.items()}, "grads": _grads(state.model)}
        out[flag] = results
    return out


PHASE1 = {"losses": case_losses, "batchnorm": case_batchnorm, "dilr": case_dilr, "zero1": case_zero1,
          "fit": case_fit, "fit_zero1": case_fit_zero1, "sweep": case_sweep, "resnet": case_resnet,
          "predictor_refuses": case_predictor_refuses, "fused_flags": case_fused_flags}


# ---------------------------------------------------------------------------
# Tensor parallelism: the (1, 2) mesh.
# ---------------------------------------------------------------------------


def _full_state(model):
    """The model's parameters and buffers at full shape (every rank of the
    model group calls it), as f64 numpy."""
    from edrl_tpu_torch.parallel import tensor

    return {k: _np(v) for k, v in tensor.gather_full(model, model.state_dict()).items()}


def case_tp_refusals(mesh, workdir):
    """What does not run over a model axis of 2 raises by name: B5, B6, a
    baseline, a chunk graph, an export; ``scan_batches`` still names A14."""
    from edrl_tpu_torch.serve.export import export_program
    from edrl_tpu_torch.serve.predictor import Predictor
    from edrl_tpu_torch.train import trainer

    out = {}
    cfg = tiny_tp()
    for name, model, train in (("use_fused_mlp", dict(use_fused_mlp=True), {}),
                               ("use_fused_block_attention", dict(use_fused_block_attention=True), {}),
                               ("baseline", dict(model_name="Multi_ResNet"), {}),
                               ("scan_batches", {}, dict(scan_batches=2))):
        c = cfg.replace(model=dataclasses.replace(cfg.model, **model), train=dataclasses.replace(cfg.train, **train))
        try:
            trainer.check_ported(c, mesh)
            if not train:
                trainer.init_state(c, device="cpu", mesh=mesh)
            out[name] = None
        except (ValueError, NotImplementedError) as exc:
            out[name] = (type(exc).__name__, str(exc))
    try:
        Predictor(cfg, device="cpu", chunk_batches=2, mesh=mesh)
        out["chunk_batches"] = None
    except NotImplementedError as exc:
        out["chunk_batches"] = str(exc)
    try:
        export_program(Predictor(cfg, device="cpu", mesh=mesh))
        out["export"] = None
    except NotImplementedError as exc:
        out["export"] = str(exc)
    return out


def case_tp_clip(mesh, workdir):
    """One step with a small ``grad_clip_norm`` at (1, 2): the clipped
    gradients at full shape; rank 0 adds one process's."""
    from edrl_tpu_torch.parallel import tensor
    from edrl_tpu_torch.train import trainer

    cfg = tiny_tp(grad_clip_norm=0.05)
    out = {}
    for where, m in (("ranks", mesh), ("one", None)):
        if where == "one" and mesh.get_local_rank("model") != 0:
            continue
        state = medfusion_state(cfg, mesh=m)
        trainer.make_train_step(cfg, m)(state, step_batch(cfg, seed=4), torch.Generator().manual_seed(5))
        grads = {n: p.grad for n, p in state.model.named_parameters()}
        out[where] = {k: _np(v) for k, v in tensor.gather_full(state.model, grads).items()}
    return out


def case_tp_remat(mesh, workdir):
    """One step at (1, 2) with every backbone block rematerialised
    (``remat``), and one with the unfused Swin attention rematerialised
    (``remat_attention``), beside the same step without: the recomputed
    forwards re-run the model axis's collectives in the backward.  The
    gradients at full shape of the three."""
    from edrl_tpu_torch.parallel import tensor
    from edrl_tpu_torch.train import trainer

    out = {}
    for label, model in (("plain", dict(remat=False, remat_attention=False)), ("remat", dict(remat=True)),
                         ("remat_attention", dict(remat_attention=True))):
        cfg = tiny_tp()
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_fused_attention=False, **model))
        state = medfusion_state(cfg, mesh=mesh)
        trainer.make_train_step(cfg, mesh)(state, step_batch(cfg, seed=6), torch.Generator().manual_seed(7))
        grads = tensor.gather_full(state.model, {n: p.grad for n, p in state.model.named_parameters()})
        out[label] = {k: _np(v) for k, v in grads.items()}
    return out


def case_tp_run_eval(mesh, workdir):
    """run_eval over 5 samples at (1, 2) (the seeded init); rank 0 adds one
    process's."""
    from edrl_tpu_torch.train import trainer

    cfg = tiny_tp()
    out = {"ranks": trainer.run_eval(medfusion_state(cfg, mesh=mesh), trainer.make_eval_step(cfg), _eval_loader(cfg),
                                     mesh=mesh)}
    if mesh.get_local_rank("model") == 0:
        out["one"] = trainer.run_eval(medfusion_state(cfg), trainer.make_eval_step(cfg), _eval_loader(cfg))
    out = {k: (m.as_dict(), t, p) for k, (m, t, p) in out.items()}
    return out


def case_tp_sweep(mesh, workdir):
    """The robustness sweep at (1, 2) against one process (the seeded init)."""
    from edrl_tpu_torch.train.robustness import noise_sweep

    cfg = tiny_tp()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_synthetic_samples=NUM_VAL, eval_batch_size=BATCH))
    kw = dict(sigmas=(0.0, 0.3), device="cpu")
    out = {"ranks": noise_sweep(cfg, medfusion_state(cfg, mesh=mesh), mesh=mesh, **kw)}
    if mesh.get_local_rank("model") == 0:
        out["one"] = noise_sweep(cfg, medfusion_state(cfg), **kw)
    return out


def case_tp_fit(mesh, workdir):
    """fit at (1, 2): 2 epochs, and 1 epoch then resumed for the second,
    which must end bit-equal; rank 0 restores the checkpoint (full shapes)
    in one process and compares it with the sharded state."""
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    cfg = tiny_tp()
    whole, result = _fit(cfg, mesh, os.path.join(workdir, "tp_fit_whole"))
    _fit(cfg, mesh, os.path.join(workdir, "tp_fit_resumed"), end_epochs=1)
    resumed, _ = _fit(cfg, mesh, os.path.join(workdir, "tp_fit_resumed"), resume=True)
    a, b = _full_state(whole.model), _full_state(resumed.model)
    diffs = [float(np.abs(a[k] - b[k]).max()) for k in a]
    opt_a, opt_b = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    diffs += [float((opt_a[k][f] - opt_b[k][f]).abs().max()) for k in opt_a for f in ("exp_avg", "exp_avg_sq")]
    out = {"resume_diff": max(diffs), "steps": (whole.step, resumed.step),
           "train": [m.as_dict() for m in result.train_history]}
    if mesh.get_local_rank("model") == 0:
        one = CheckpointManager(os.path.join(workdir, "tp_fit_whole", "ckpt")).restore(
            trainer.init_state(cfg, device="cpu"), "latest")
        restored = {k: _np(v) for k, v in one.model.state_dict().items()}
        out["restored_diff"] = max(float(np.abs(a[k] - restored[k]).max()) for k in a)
        out["restored_keys"] = set(a) == set(restored)
    return out


TP_PHASE1 = {"tp_refusals": case_tp_refusals, "tp_clip": case_tp_clip, "tp_remat": case_tp_remat,
             "tp_run_eval": case_tp_run_eval,
             "tp_sweep": case_tp_sweep, "tp_fit": case_tp_fit}


# ---------------------------------------------------------------------------
# Phase 2: with JAX's draws.
# ---------------------------------------------------------------------------


def case_step(mesh, workdir, jax_in):
    """The MedFusion step at global batch 4 on this rank's rows, JAX's
    recorded draws sliced to them (EPRL's eps whole): the global results,
    the averaged gradients and the running statistics."""
    from edrl_tpu_torch.train import trainer

    cfg = tiny()
    state = medfusion_state(cfg, jax_in["variables"], mesh)
    rows = pmesh.rows_of(BATCH, pmesh.data_axis_of(mesh))
    draws = []
    for d in jax_in["step_draws"]:
        draws.append({"guided_uniform": tuple(torch.tensor(u[rows]) for u in d["guided_uniform"]),
                      "eprl_eps": tuple(torch.tensor(e) for e in d["eprl_eps"]),
                      "dropout_masks": tuple([torch.tensor(m[rows]) for m in ms] for ms in d["dropout_masks"])})
    out = trainer.make_train_step(cfg, mesh)(state, parallel.shard_batch(step_batch(cfg), mesh), torch.Generator(),
                                             draws=draws)
    return {"out": {k: _np(v) for k, v in out.items()}, "grads": _grads(state.model),
            "stats": _buffers(state.model)}


def _eval_loader(cfg, rank=0, world=1):
    from edrl_tpu_torch.data import BatchLoader, SyntheticGammaDataset

    data = dataclasses.replace(cfg.data, device_noise=True, num_synthetic_samples=NUM_VAL)
    return BatchLoader(SyntheticGammaDataset(data, mode="val"), BATCH, shuffle=False, drop_last=False,
                       num_workers=2, uint8_transport=True, rank=rank, world=world)


def case_run_eval(mesh, workdir, jax_in):
    """run_eval over 5 samples (batches of 4 and 1) at world 2, the last
    padded to 2, JAX's eval draws of the padded global batches injected;
    rank 0 adds world 1's, with JAX's draws of the unpadded batches."""
    from edrl_tpu_torch.train import trainer

    cfg = tiny()
    state = medfusion_state(cfg, jax_in["variables"])
    port_eval = trainer.make_eval_step(cfg)
    world = mesh.size(0)

    def draws_for(rows, padded):
        d = jax_in["eval_draws"][rows]
        sl = slice(None) if not padded else pmesh.rows_of(rows, pmesh.data_axis_of(mesh))
        return {"guided_uniform": tuple(torch.tensor(u[sl]) for u in d["guided_uniform"]),
                "eprl_eps": torch.tensor(d["eprl_eps"])}

    def ranks_step(st, batch, mm=None):
        return port_eval(st, batch, mm, draws=draws_for(int(batch["label"].shape[0]) * world, True))

    def one_step(st, batch, mm=None):
        return port_eval(st, batch, mm, draws=draws_for(int(batch["label"].shape[0]), False))

    m, t, p = trainer.run_eval(state, ranks_step, _eval_loader(cfg, mesh.get_local_rank("data"), world), mesh=mesh)
    out = {"ranks": (m.as_dict(), t, p)}
    if mesh.get_local_rank("data") == 0:
        m1, t1, p1 = trainer.run_eval(state, one_step, _eval_loader(cfg))
        out["one"] = (m1.as_dict(), t1, p1)
    return out


def case_predictor(mesh, workdir, jax_in):
    """A request of 7 (padded to 8) served at world 2, batch by batch and in
    chunks of 2, with JAX's eval uniforms; rank 0 adds world 1's."""
    from edrl_tpu_torch.serve.predictor import Predictor

    cfg = tiny()
    state = medfusion_state(cfg, jax_in["variables"])
    f, o = jax_in["request"]
    u = jax_in["serving_uniform"]
    out = {f"ranks_{c}": Predictor(cfg, state, device="cpu", guided_uniform=u, chunk_batches=c,
                                   mesh=mesh).predict_probs(f, o) for c in (1, 2)}
    if mesh.get_local_rank("data") == 0:
        out["one"] = Predictor(cfg, state, device="cpu", guided_uniform=u).predict_probs(f, o)
    return out


PHASE2 = {"step": case_step, "run_eval": case_run_eval, "predictor": case_predictor}


def case_tp_step(mesh, workdir, jax_in):
    """The MedFusion step of ``tiny_tp`` at global batch 4 on the (1, 2)
    mesh with JAX's recorded draws: the results; rank 0 the gradients at
    full shape; both the replicated parameters' gradients and values after
    the step, the running statistics, and each attention module's route."""
    from edrl_tpu_torch.parallel import tensor
    from edrl_tpu_torch.train import trainer

    cfg = tiny_tp()
    state = medfusion_state(cfg, jax_in["tp_variables"], mesh)
    draws = [{"guided_uniform": tuple(torch.tensor(u) for u in d["guided_uniform"]),
              "eprl_eps": tuple(torch.tensor(e) for e in d["eprl_eps"]),
              "dropout_masks": tuple([torch.tensor(m) for m in ms] for ms in d["dropout_masks"])}
             for d in jax_in["tp_step_draws"]]
    out = trainer.make_train_step(cfg, mesh)(state, step_batch(cfg), torch.Generator(), draws=draws)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    split = set(tensor.split_parameter_names(state.model))
    full = tensor.gather_full(state.model, grads)
    result = {"out": {k: _np(v) for k, v in out.items()},
              "replicated": {n: _np(g) for n, g in grads.items() if n not in split},
              "replicated_params": {n: _np(p) for n, p in state.model.named_parameters() if n not in split},
              "split": sorted(split), "stats": _buffers(state.model),
              "routes": {n: m.tp_route for n, m in state.model.named_modules() if hasattr(m, "tp_route")}}
    axis = pmesh.model_axis_of(mesh)
    result["model_axis"] = (axis.rank, axis.size)
    if mesh.get_local_rank("model") == 0:
        result["grads"] = {n: _np(g) for n, g in full.items()}
    return result


def case_tp_predictor(mesh, workdir, jax_in):
    """A request of 7 served at (1, 2) in f32 and int8 (dynamic scales, every
    Dense of both sides >= 32) with JAX's eval uniforms; rank 0 adds one
    process's."""
    from edrl_tpu_torch.serve.predictor import Predictor

    cfg = tiny_tp()
    state = medfusion_state(cfg, jax_in["tp_variables"])
    f, o = jax_in["request"]
    kw = dict(device="cpu", guided_uniform=jax_in["serving_uniform"])
    modes = {"f32": {}, "int8": dict(quantize_int8=True, min_dim=32)}
    out = {f"ranks_{k}": Predictor(cfg, state, mesh=mesh, **kw, **v).predict_probs(f, o) for k, v in modes.items()}
    if mesh.get_local_rank("model") == 0:
        out.update({f"one_{k}": Predictor(cfg, state, **kw, **v).predict_probs(f, o) for k, v in modes.items()})
    return out


TP_PHASE2 = {"tp_step": case_tp_step, "tp_predictor": case_tp_predictor}


# ---------------------------------------------------------------------------
# World 4: tensor parallelism over a data axis of 2, the (2, 2) mesh.
# ---------------------------------------------------------------------------


def _full_grads(model):
    """The model's gradients at full shape (every rank of the model group
    calls it), as f64 numpy."""
    from edrl_tpu_torch.parallel import tensor

    return {k: _np(v) for k, v in tensor.gather_full(model, {n: p.grad for n, p in model.named_parameters()}).items()}


def case_tp22_step(mesh, workdir):
    """The step of ``tiny_tp`` at global batch 4 on (2, 2) with the step's
    generator: the global results and the gradients at full shape; rank 0
    adds one process's, and every rank the replicated gradients' spread
    over its model group."""
    from edrl_tpu_torch.tools.profile_data_parallel import replicated_spread
    from edrl_tpu_torch.train import trainer

    cfg, batch = tiny_tp(), step_batch(tiny_tp(), seed=8)
    out = {}
    for where, m in (("ranks", mesh), ("one", None)):
        if where == "one" and not parallel.is_writer(mesh):
            continue
        state = medfusion_state(cfg, mesh=m)
        got = trainer.make_train_step(cfg, m)(state, batch if m is None else parallel.shard_batch(batch, m),
                                              torch.Generator().manual_seed(9))
        out[where] = {"out": {k: _np(v) for k, v in got.items()}, "grads": _full_grads(state.model)}
        if m is not None:
            out["spread"] = replicated_spread(state.model, m)
    return out


def case_tp22_fit_zero1(mesh, workdir):
    """fit of ``tiny_tp`` on (2, 2) for 2 epochs, and with ZeRO-1 (Adam's
    moments sharded over each model rank's data group) for 1 epoch, then
    resumed from its checkpoint for the second: rank 0 holds the two runs'
    last checkpoints (full shapes: ZeRO-1 consolidated over the data group,
    then gathered over the model group) against each other tensor by tensor,
    and restores the resumed run's in one process against its sharded
    state."""
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import _FILE, CheckpointManager

    cfg = tiny_tp()
    _fit(cfg, mesh, os.path.join(workdir, "tp22_whole"))
    directory = os.path.join(workdir, "tp22_zero1")
    _fit(tiny_tp(zero1=True), mesh, directory, end_epochs=1)
    resumed, result = _fit(tiny_tp(zero1=True), mesh, directory, resume=True)
    full = _full_state(resumed.model)
    out = {"is_zero1": pmesh.is_zero1(resumed.optimizer), "steps": resumed.step,
           "train": [m.as_dict() for m in result.train_history]}
    if parallel.is_writer(mesh):
        snaps = [torch.load(os.path.join(workdir, d, "ckpt", "latest", _FILE), weights_only=True)
                 for d in ("tp22_whole", "tp22_zero1")]
        out["keys"] = [sorted(s["model"]) for s in snaps]
        out["param_diff"] = max(float((snaps[0]["model"][k] - snaps[1]["model"][k]).abs().max())
                                for k in snaps[0]["model"])
        moments = [s["optimizer"]["state"] for s in snaps]
        out["moment_keys"] = [sorted(m) for m in moments]
        out["moment_diff"] = max(float((moments[0][k][f] - moments[1][k][f]).abs().max())
                                 for k in moments[0] for f in ("exp_avg", "exp_avg_sq"))
        out["moment_steps"] = sorted({float(m[k]["step"]) for m in moments for k in m})
        one = CheckpointManager(os.path.join(directory, "ckpt")).restore(trainer.init_state(cfg, device="cpu"),
                                                                          "latest")
        restored = {k: _np(v) for k, v in one.model.state_dict().items()}
        out["restored_diff"] = max(float(np.abs(full[k] - restored[k]).max()) for k in full)
        out["restored_step"] = one.step
    return out


WORLD4 = {"tp22_step": case_tp22_step, "tp22_fit_zero1": case_tp22_fit_zero1}


def run_world4(rank: int, world: int, port: int, outbox, workdir: str) -> None:
    """A rank of the world of 4 on the (2, 2) mesh: runs ``WORLD4`` and posts
    ``(rank, results)``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    parallel.init_distributed("cpu")
    try:
        outbox.put((rank, _run_cases(WORLD4, parallel.make_mesh(2, device="cpu"), workdir)))
    finally:
        torch.distributed.destroy_process_group()


def _run_cases(cases, mesh, *args):
    results = {}
    for name, case in cases.items():
        try:
            results[name] = case(mesh, *args)
        except Exception:  # reported to the parent, which fails the case's test
            results[name] = {"error": traceback.format_exc()}
    return results


def run(rank: int, world: int, port: int, inbox, outbox, workdir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    parallel.init_distributed("cpu")
    mesh = parallel.make_mesh(device="cpu")
    tp_mesh = parallel.make_mesh(world, device="cpu")
    try:
        outbox.put((rank, "phase1", {**_run_cases(PHASE1, mesh, workdir), **_run_cases(TP_PHASE1, tp_mesh, workdir)}))
        jax_in = inbox.get(timeout=300)
        outbox.put((rank, "phase2", {**_run_cases(PHASE2, mesh, workdir, jax_in),
                                     **_run_cases(TP_PHASE2, tp_mesh, workdir, jax_in)}))
    finally:
        torch.distributed.destroy_process_group()
