"""The baseline zoo against the JAX package on the CPU: the registry, the
conversion of conv kernels, CLUB and the auxiliary modules, and every distinct
model class of the registry (this file: every eval forward and the
transformer classes' train steps; ``test_torch_baselines_*.py``: the CNN
classes' train steps and eval-mode gradients, split so that they run side
by side).

Per class, on the same inputs (numpy, seeded) and the same variables (the
port's seeded init with perturbed BN statistics and affine parameters,
carried into flax's tree by the port's own key map):

- eval mode: logits, loss and features (atol 1e-5, or 1e-5 of the largest
  magnitude where a deep conv stack's activations reach ~1e2), and for the
  CNN classes the eval-mode loss's gradients against ``jax.grad`` at the
  roadmap's bars (atol 2e-4 / rtol 1e-3): every convolution, pool and pad
  differentiated, every tensor held;
- one train step, ``make_train_step(..., jit=False)`` under one
  ``jax.jit`` in JAX and the port's ``make_train_step``, with JAX's dropout
  masks injected: the loss, the MMD, the probabilities, every gradient
  (atol 2e-4 / rtol 1e-3) and the updated BN statistics (1e-5 of their
  largest magnitude).

Train mode at random init puts a deep CNN's f32 gradients out of reach of
those bars, in JAX as in the port.  On inputs of uniform noise every sample
looks alike, so many channels' batch spread is small against their values,
and each train-mode BatchNorm multiplies what reaches it by its 1/std:
Res2Net-50's last stage carries ~1e-3 of its magnitude in f32 against f64
(eval mode: ~1e-6).  A ReLU whose input lies that close to its kink takes
the other branch in one stack, which changes a whole row of a weight
gradient by its own size.  The port's step made f64 (``model.double()``)
moves by ~1e-12 when its batch is reversed, so the train step is held
against that f64 step, each result by its f32 spread: the largest of the
port's own f32 errors against it (the batch in its order and reversed: the
same sums in other orders) and JAX's own change when each input element
moves by about two ulps.  A fault of the port's is in its f64 step as well:
it puts JAX's error far outside a spread that it leaves as it was.

- Loss, MMD and probabilities meet the roadmap's bars or else read within
  ``WITNESS`` times their spread or 1e-3 of their magnitude.
- Gradients, each relative to its tensor's largest f64 value: at the median
  over the step's tensors within 1e-3 or ``WITNESS`` times the median
  spread; at the worst tensor within 5e-2 (a ReLU flipped in one stack: the
  early-fusion model reads 2.7e-2 at one bias whose spread is 2e-5) or
  ``WITNESS`` times the worst spread, and below ``CAP``, the tensor's own
  largest value.
- BN statistics likewise at 1e-5 (median) and 1e-3 (worst).

Readings (fundus 32^2, OCT 16^3, batch 8): the 3-D ResNets and the
early-fusion model meet the roadmap's bars but for that one bias.  Every
class with Res2Net-50 reads, at the median, JAX 5e-2 to 1.5e-1 against a
spread of 6e-2 to 1.5e-1 (at most 1.5 times it), and at the worst tensor
0.31 to 0.95 against a worst spread of 0.3 to 1.6 (Multi_CBAM_ResNet's 3-D
spatial-attention kernel, whose only live tap is its centre on a 1^3 map:
JAX 0.95, JAX's own change 1.6).  Where the f32 steps themselves move a
tensor by O(1), only the eval-mode gradients hold it.  ``FAULTS`` are
faults a port could make (a symmetric pad, a BatchNorm backward without its
variance term, torch's momentum convention): the train-step check must
fail on each, in the part that sees it, on Res2Net2D, ResNet3D and
Multi_ResNet.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edrl_tpu.baselines import registry as jregistry
from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.models import auxiliary as jaux
from edrl_tpu.ops import club as jclub
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.baselines import MODEL_REGISTRY, build_baseline, registry
from edrl_tpu_torch.convert import _KERNEL_AXES, flax_key_map, load_flax_variables
from edrl_tpu_torch.models import auxiliary
from edrl_tpu_torch.models import conv
from edrl_tpu_torch.models.conv import BatchNorm
from edrl_tpu_torch.models.layers import init_parameters
from edrl_tpu_torch.ops import club
from edrl_tpu_torch.train import trainer
from test_torch_train import record_jax_draws

ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
# The train step's f32 results against the port's f64 step (see the module
# docstring): JAX's error within WITNESS times the f32 spread or a bar of
# its own, at the median over a step's results and at the worst, and at
# the worst below CAP of a result's largest magnitude.
WITNESS = 3.0
GRAD_REL, GRAD_WORST_REL, STAT_REL, STAT_WORST_REL, OUT_REL, CAP = 1e-3, 5e-2, 1e-5, 1e-3, 1e-3, 1.0
BATCH, TRAIN_BATCH = 2, 8
SIZES = (32, 16)  # fundus side, OCT side (tests/test_baselines.py)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for the port's CPU work: the test workers share
    the host's cores with JAX's own threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def configs(name: str, batch=BATCH, **train):
    """The tiny config of both stacks for ``name``, fundus 32^2 and OCT 16^3."""
    out = []
    for make in (jax_tiny_config, tconfig.tiny_test_config):
        cfg = make(batch_size=batch)
        data = dataclasses.replace(cfg.data, fundus_size=SIZES[0], oct_size=(SIZES[1],) * 3)
        out.append(cfg.replace(data=data, model=dataclasses.replace(cfg.model, model_name=name),
                               train=dataclasses.replace(cfg.train, **train)))
    return out


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, b = cfg.data, cfg.data.batch_size
    f = rng.uniform(size=(b, d.fundus_size, d.fundus_size, 3)).astype(np.float32)
    o = rng.uniform(size=(b, *d.oct_size, 1)).astype(np.float32)
    return f, o, np.arange(b, dtype=np.int32) % 2


def _perturb_(model: torch.nn.Module, seed: int) -> None:
    """BN statistics and affine parameters away from the init's 0 / 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.shape
                m.weight.copy_(0.75 + 0.5 * torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def to_flax(tm: torch.nn.Module, shapes) -> dict:
    """The port's tensors as a flax variable tree shaped like ``shapes``
    (``jax.eval_shape`` of the JAX init), through the port's own key map."""
    key_map = flax_key_map(tm, shapes["params"], shapes.get("batch_stats"))
    state = tm.state_dict()
    tree = jax.tree_util.tree_map(lambda s: None, dict(flax.core.unfreeze(shapes)))
    for name, path in key_map.items():
        keys = path.split("/")
        value = state[name].detach().numpy().astype(np.float32)
        if keys[0] == "params" and keys[-1] == "kernel":
            value = value.transpose(np.argsort(_KERNEL_AXES[value.ndim]))
        node = tree
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = np.ascontiguousarray(value)
    return tree


def build_pair(name: str, batch=BATCH, seed=0, **train):
    """``(jcfg, tcfg, jax_model, port_model, variables)`` with shared variables."""
    jcfg, tcfg = configs(name, batch, **train)
    jm, _ = jregistry.build_baseline(name, jcfg)
    tm, _ = build_baseline(name, tcfg, device="cpu")
    init_parameters(tm, torch.Generator().manual_seed(seed))
    _perturb_(tm, seed + 1)
    f, o, y = inputs(tcfg)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                            f, o, y, train=True))
    variables = to_flax(tm, shapes)
    variables.setdefault("batch_stats", {})
    return jcfg, tcfg, jm, tm, variables


def rel_close(got, want, rel=1e-5, atol=ATOL, what=""):
    """``got`` within atol of ``want``, or within ``rel`` of its largest magnitude."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= max(atol, rel * float(np.abs(want).max(initial=0.0))), f"{what}: error {err}"


def check_eval(name: str):
    jcfg, tcfg, jm, tm, variables = build_pair(name)
    f, o, y = inputs(tcfg, seed=1)
    want = jm.apply(variables, f, o, y, train=False)
    got = tm.eval()(torch.tensor(f), torch.tensor(o), torch.tensor(y), train=False)
    for g, w, what in zip(got, want, ("logits", "loss", "features")):
        rel_close(g, w, what=f"{name} eval {what}")
    assert got[2].shape[1] == tm.feature_dim


def _port_step(tcfg, variables, batch, masks, double=False, reverse=False):
    """The port's step from ``variables`` on ``batch``, in f32 or, with
    ``double``, in f64 (the model made f64, see ``models.conv``), with
    ``reverse`` on the batch in reverse order (the same sums in other
    orders): ``(out, grads, statistics)`` as f64 numpy arrays by torch name,
    the probabilities in the batch's order."""
    state = trainer.init_state(tcfg, device="cpu", variables=variables)
    if double:
        state.model.double()
    if reverse:
        batch = {k: v[::-1].copy() for k, v in batch.items()}
        masks = [m.flip(0) for m in masks]
    draws = [{"dropout_masks": [m]} for m in masks] or None
    out = trainer.make_train_step(tcfg)(state, batch, torch.Generator().manual_seed(0), draws=draws)
    if reverse:
        out["probs"] = out["probs"].flip(0)
    as_np = lambda t: t.detach().double().numpy()  # noqa: E731
    return ({k: as_np(v) for k, v in out.items()}, {n: as_np(p.grad) for n, p in state.model.named_parameters()},
            {n: as_np(b) for n, b in state.model.named_buffers()})


def _perturbed(batch, eps=2.0 ** -22, seed=11):
    """Each f32 input element moved by about two ulps, up or down at random.
    (A uniform scaling would not do: the first train-mode BatchNorm undoes it.)"""
    rng = np.random.default_rng(seed)
    return {k: (v * (1.0 + eps * rng.choice(np.array([-1.0, 1.0], np.float32), v.shape))).astype(v.dtype)
            if v.dtype == np.float32 else v for k, v in batch.items()}


_JAX_STEPS = {}


def jax_steps(name, jcfg, variables, batch):
    """JAX's train step, ``make_train_step(..., jit=False)`` under one
    ``jax.jit``, on ``batch`` and on ``_perturbed(batch)`` (the same dropout
    masks): for each, ``(out, grads, new batch_stats, dropout masks)``, the
    masks drawn as flax's ``nn.Dropout`` draws them (``record_jax_draws``).
    Kept per name: the variables and the batch are functions of the name
    alone."""
    if name in _JAX_STEPS:
        return _JAX_STEPS[name]
    model = jtrainer.make_model(jcfg)
    captured = {}

    def update(grads, opt_state, params=None):
        captured["grads"] = grads
        return jax.tree_util.tree_map(jnp.zeros_like, grads), opt_state

    tx = optax.GradientTransformation(lambda params: optax.EmptyState(), update)
    step = jtrainer.make_train_step(model, tx, jcfg, jit=False)

    @jax.jit
    def run(params, stats, batch):
        state = jtrainer.TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                                    opt_state=tx.init(params))
        rec = {"uniform": [], "normal": [], "dropout": []}
        with record_jax_draws(rec, convert=lambda x: x):
            new_state, out = step(state, batch, jax.random.key(7))
        return out, captured["grads"], new_state.batch_stats, rec["dropout"]

    _JAX_STEPS[name] = [
        tuple(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(o))
              for o in run(variables["params"], variables["batch_stats"], {k: jnp.asarray(v) for k, v in b.items()}))
        for b in (batch, _perturbed(batch))]
    return _JAX_STEPS[name]


def _leaves(tm, tree_grads, tree_stats):
    """``(torch name, kind, JAX leaf in torch layout)`` for every parameter
    ("grad") and statistic ("stat") of ``tm``."""
    for tname, path in flax_key_map(tm, tree_grads, tree_stats or None).items():
        keys = path.split("/")
        leaf = tree_grads if keys[0] == "params" else tree_stats
        for k in keys[1:]:
            leaf = leaf[k]
        leaf = np.asarray(leaf, np.float64)
        if keys[-1] == "kernel":
            leaf = leaf.transpose(_KERNEL_AXES[leaf.ndim])
        yield tname, "grad" if keys[0] == "params" else "stat", leaf


def _train_batch(tcfg):
    f, o, y = inputs(tcfg, seed=2)
    f2, o2, _ = inputs(tcfg, seed=3)
    return {"fundus_low": f, "fundus_high": f2, "oct_low": o, "oct_high": o2, "label": y}


def check_train_step(name: str):
    """One train step in each stack, held against the port's f64 step (see
    the module docstring)."""
    jcfg, tcfg, jm, tm, variables = build_pair(name, TRAIN_BATCH)
    batch = _train_batch(tcfg)
    (out_j, grads_j, stats_j, jmasks), jax_p = jax_steps(name, jcfg, variables, batch)
    masks = [torch.tensor(m) for m in jmasks]
    assert len(masks) in (0, 2), len(masks)
    t64 = _port_step(tcfg, variables, batch, masks, double=True)
    t32 = [_port_step(tcfg, variables, batch, masks, reverse=r) for r in (False, True)]

    # Per result: (JAX's error against the f64 step; the f32 spread, the
    # largest of the port's two orders' errors against it and JAX's own
    # change on the perturbed inputs; the result's name), each relative to
    # the f64 result's largest magnitude; (0, 0) where the f32 steps agree at
    # the bars.
    rel = {"out": [], "grad": [], "stat": []}

    def add(kind, what, want, want_p, got32, got64):
        want, want_p = np.asarray(want, np.float64), np.asarray(want_p, np.float64)
        if kind == "stat":
            on_bar = np.abs(got32[0] - want).max() <= STAT_REL * max(np.abs(want).max(), 1.0)
        else:
            on_bar = np.allclose(got32[0], want, atol=GRAD_ATOL, rtol=GRAD_RTOL)
        scale = max(float(np.abs(got64).max()), 1e-30)
        spread = max([float(np.abs(g - got64).max()) for g in got32] + [float(np.abs(want_p - want).max())]) / scale
        rel[kind].append((0.0, 0.0, what) if on_bar else (float(np.abs(want - got64).max()) / scale, spread, what))

    for key in ("loss", "mmd", "probs"):
        add("out", key, out_j[key], jax_p[0][key], [t[0][key] for t in t32], t64[0][key])
    leaves_p = {tname: want for tname, _, want in _leaves(tm, jax_p[1], jax_p[2])}
    for tname, kind, want in _leaves(tm, grads_j, stats_j):
        index = 1 if kind == "grad" else 2
        add(kind, tname, want, leaves_p[tname], [t[index][tname] for t in t32], t64[index][tname])
    for kind, median_bar, worst_bar in (("out", 0.0, OUT_REL), ("grad", GRAD_REL, GRAD_WORST_REL),
                                        ("stat", STAT_REL, STAT_WORST_REL)):
        if not rel[kind]:
            continue
        errs, spreads = np.array([e for e, _, _ in rel[kind]]), np.array([s for _, s, _ in rel[kind]])
        assert np.median(errs) <= max(median_bar, WITNESS * np.median(spreads)), (
            f"{name} {kind}: median error {np.median(errs)}, the f32 spread's median {np.median(spreads)}")
        worst = max(rel[kind])
        assert worst[0] <= min(max(worst_bar, WITNESS * spreads.max()), CAP), (
            f"{name} {kind}: worst {worst}, the worst f32 spread {spreads.max()}")


def check_eval_gradients(name: str):
    """The gradients of the eval-mode loss (BatchNorm on its running
    statistics, no dropout) against ``jax.grad`` at the roadmap's bars:
    every convolution, pool and pad differentiated, free of train mode's
    amplified rounding."""
    jcfg, tcfg, jm, tm, variables = build_pair(name)
    f, o, y = inputs(tcfg, seed=4)

    def loss(params):
        return jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, f, o, y, train=False)[1]

    grads_j = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(variables["params"]))
    tm.eval()(torch.tensor(f), torch.tensor(o), torch.tensor(y), train=False)[1].backward()
    grads = dict(tm.named_parameters())
    checked = 0
    for tname, kind, want in _leaves(tm, grads_j, variables["batch_stats"]):
        if kind == "grad":
            np.testing.assert_allclose(grads[tname].grad.numpy(), want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=tname)
            checked += 1
    assert checked == len(grads)


def _symmetric_padding(size, kernel, stride):
    """torch's ``padding=kernel // 2``: flax's shapes, other numbers at stride 2."""
    return kernel // 2, kernel // 2


def _bn_backward_without_its_variance_term(ctx, dy):
    x, mean, invstd, scale = ctx.saved_tensors
    dims = tuple(range(x.dim() - 1))
    dy = dy.to(x.dtype)
    xhat = (x - mean) * invstd
    sum_dy = dy.sum(dim=dims)
    dx = (invstd * scale) * (dy - sum_dy / (x.numel() // x.shape[-1]))
    return dx, None, None, (dy * xhat).sum(dim=dims), sum_dy


# Faults a port could make, each with the part of the check that must catch
# it: a wrong pad changes the forward, a wrong BatchNorm backward only the
# gradients, torch's momentum convention only the running statistics.
FAULTS = {
    "symmetric pad": ("out", lambda mp: mp.setattr(conv, "same_padding", _symmetric_padding)),
    "BN backward without its variance term": (
        "grad", lambda mp: mp.setattr(conv._BatchNormTrain, "backward",
                                      staticmethod(_bn_backward_without_its_variance_term))),
    "BN momentum in torch's convention": ("stat", lambda mp: mp.setattr(conv.BatchNorm, "momentum", 0.9)),
}


def check_planted_fault(name: str, fault: str, monkeypatch):
    """``check_train_step`` fails, in the part named in ``FAULTS``, once the
    port carries ``fault`` (the faults are the port's; JAX's step is kept
    per name)."""
    kind, plant = FAULTS[fault]
    plant(monkeypatch)
    with pytest.raises(AssertionError, match=f"{name} {kind}"):
        check_train_step(name)


# Eval mode: one registry name per distinct class (MedFusion is tested in
# its own files; a feature extractor's dropout is off in eval mode).
EVAL_NAMES = ["Res2Net2D", "ResNet3D", "Multi_ResNet", "Multi_ResNet_cross", "Multi_EF_ResNet", "Multi_CBAM_ResNet",
              "Multi_dropout_ResNet", "2D_transformer", "3D_transformer", "Trans_cross", "MLC", "MLC_trans",
              "Medical_2DNet", "Medical_3DNet", "Multi_ensemble_ResNet", "Multi_ensemble_3D_ResNet"]
# Train steps, one registry name per distinct class (the feature extractors
# through their dropout variants): the transformer classes here, the CNN
# classes in test_torch_baselines_{2d,3d,fusion,mlc,ensemble,dropout}.py.
TRANSFORMER = ["2D_transformer", "3D_transformer", "Trans_cross", "MLC_trans"]


@pytest.mark.parametrize("name", EVAL_NAMES)
def test_eval_matches_jax(name):
    check_eval(name)


@pytest.mark.parametrize("name", TRANSFORMER)
def test_train_step_matches_jax(name):
    check_train_step(name)


CNN = ["Res2Net2D", "Medical_base_dropout_2DNet", "ResNet3D", "Medical_base_dropout_3DNet", "Multi_EF_ResNet",
       "Multi_ResNet", "Multi_ResNet_cross", "Multi_CBAM_ResNet", "MLC", "Multi_ensemble_ResNet",
       "Multi_ensemble_3D_ResNet", "Multi_dropout_ResNet"]


@pytest.mark.parametrize("name", CNN)
def test_a_double_model_steps_in_f64(name):
    """``model.double()`` makes a CNN class its own f64 reference: every
    module of a train step outputs f64, and so do the loss and gradients."""
    _, tcfg = configs(name)
    state = trainer.init_state(tcfg, device="cpu")
    state.model.double()
    narrow = []

    def hook(module, args, out, name=None):
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.dtype != torch.float64:
                narrow.append((name, t.dtype))

    for mname, m in state.model.named_modules():
        m.register_forward_hook(lambda m, a, o, mname=mname: hook(m, a, o, mname))
    f, o, y = inputs(tcfg)
    batch = {"fundus_low": f, "fundus_high": f, "oct_low": o, "oct_high": o, "label": y}
    out = trainer.make_train_step(tcfg)(state, batch, torch.Generator().manual_seed(0))
    assert not narrow, narrow
    assert out["loss"].dtype == torch.float64
    assert all(p.grad.dtype == torch.float64 for p in state.model.parameters())


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------


def test_registry_names_match_the_jax_package():
    assert list(MODEL_REGISTRY) == list(jregistry.MODEL_REGISTRY)
    assert registry.ENSEMBLE_LRS == jregistry.ENSEMBLE_LRS


def test_unknown_name_raises():
    _, tcfg = configs("NoSuchModel")
    with pytest.raises(NameError, match="NoSuchModel"):
        build_baseline("NoSuchModel", tcfg, device="cpu")
    with pytest.raises(NameError, match="NoSuchModel"):
        trainer.check_ported(tcfg)


@pytest.mark.parametrize("name", [n for n in MODEL_REGISTRY if n not in ("MedFusion", "IMDR")])
def test_every_name_builds_with_the_jax_tree(name):
    """Every registry name builds, and its parameters and statistics are
    exactly the JAX model's tree (the strict key map)."""
    jcfg, tcfg = configs(name)
    jm, jlr = jregistry.build_baseline(name, jcfg)
    tm, lr = build_baseline(name, tcfg, device="meta")
    assert lr == jlr
    f, o, y = inputs(tcfg)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                            f, o, y, train=True))
    key_map = flax_key_map(tm, shapes["params"], shapes.get("batch_stats"))
    assert len(key_map) == len(tm.state_dict())


def test_proxy_dump_skips_a_model_without_eprl(tmp_path):
    """``fit``'s Student-t dump (``--student_t_every``) finds no EPRL proxies
    in a baseline: it draws nothing and does not raise."""
    from edrl_tpu_torch.train.visualize import dump_proxy_distributions

    _, tcfg = configs("Multi_ResNet")
    model, _ = build_baseline("Multi_ResNet", tcfg, device="meta")
    assert dump_proxy_distributions(model, tcfg.model, 1, str(tmp_path)) is None
    assert not any(tmp_path.iterdir())


def test_medfusion_and_its_alias():
    for name in ("MedFusion", "IMDR"):
        tcfg = tconfig.tiny_test_config(batch_size=2)
        model, lr = build_baseline(name, tcfg.replace(model=dataclasses.replace(tcfg.model, model_name=name)),
                                   device="meta")
        assert type(model).__name__ == "MedFusion" and lr is None


@pytest.mark.parametrize("name", list(registry.ENSEMBLE_LRS))
def test_ensemble_lr_reaches_the_optimizer(name):
    _, tcfg = configs(name)
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, lr=0.5, warmup_steps=0))
    optimizer, _ = trainer.make_optimizer([torch.nn.Parameter(torch.zeros(2))], tcfg)
    assert optimizer.param_groups[0]["lr"] == registry.ENSEMBLE_LRS[name]
    _, other = configs("Multi_ResNet", lr=0.5, warmup_steps=0)
    optimizer, _ = trainer.make_optimizer([torch.nn.Parameter(torch.zeros(2))], other)
    assert optimizer.param_groups[0]["lr"] == 0.5


def test_kernel_flags_reach_swin_and_vit():
    """The model config's kernel flags, remat and dtype reach the transformer
    baselines' backbones, as ``_swin_kwargs`` / ``_vit_kwargs`` carry them in JAX."""
    jcfg, tcfg = configs("Trans_cross")
    flags = dict(use_fused_attention=True, vit_fused_attention=True, use_fused_ln=True, use_fused_mlp=True,
                 use_bfloat16=True, remat=True)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **flags))
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **flags))
    assert registry._swin_kwargs(tcfg) == jregistry._swin_kwargs(jcfg)
    assert registry._vit_kwargs(tcfg) == jregistry._vit_kwargs(jcfg)
    tm, _ = build_baseline("Trans_cross", tcfg, device="meta")
    swin, vit = tm.fundus_backbone, tm.oct_backbone
    assert swin.dtype == vit.dtype == torch.bfloat16 and swin.remat and vit.remat
    assert any(getattr(m, "use_fused", False) for m in swin.modules())
    assert any(getattr(m, "use_fused", False) for m in vit.modules())
    # CNN baselines take no dtype: f32 under use_bfloat16 too.
    cnn, _ = build_baseline("Multi_ResNet", tcfg, device="meta")
    assert cnn.fundus_backbone.dtype == cnn.oct_backbone.dtype == torch.float32


# ---------------------------------------------------------------------------
# convert: conv kernels and flax's automatic names, strictly.
# ---------------------------------------------------------------------------


def test_convert_maps_conv_kernels_and_automatic_names():
    jcfg, tcfg, jm, tm, variables = build_pair("Multi_ResNet")
    key_map = flax_key_map(tm, variables["params"], variables["batch_stats"])
    fb = "params/fundus_backbone"
    assert key_map["fundus_backbone.Conv_0.weight"] == f"{fb}/Conv_0/kernel"
    assert key_map["fundus_backbone.Conv_2.weight"] == f"{fb}/Conv_2/kernel"
    assert key_map["oct_backbone.stage1_block0.Conv_1.weight"] == "params/oct_backbone/stage1_block0/Conv_1/kernel"
    assert key_map["fundus_backbone.bn_stem1.running_var"] == "batch_stats/fundus_backbone/bn_stem1/var"
    kernel2d = variables["params"]["fundus_backbone"]["Conv_0"]["kernel"]  # [3, 3, 3, 32]
    kernel3d = variables["params"]["oct_backbone"]["stem"]["kernel"]  # [7, 7, 7, 1, 64]
    fresh, _ = build_baseline("Multi_ResNet", tcfg, device="cpu")
    load_flax_variables(fresh, variables["params"], variables["batch_stats"])
    np.testing.assert_array_equal(fresh.fundus_backbone.Conv_0.weight.detach().numpy(),
                                  np.transpose(kernel2d, (3, 2, 0, 1)))
    np.testing.assert_array_equal(fresh.oct_backbone.stem.weight.detach().numpy(),
                                  np.transpose(kernel3d, (4, 3, 0, 1, 2)))


def test_convert_is_strict_for_conv_trees():
    jcfg, tcfg, jm, tm, variables = build_pair("ResNet3D")
    params = jax.tree_util.tree_map(lambda x: x, variables["params"])
    params["backbone"]["extra"] = {"kernel": np.zeros((3, 3, 3, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="params/backbone/extra"):
        load_flax_variables(tm, params, variables["batch_stats"])
    stats = jax.tree_util.tree_map(lambda x: x, variables["batch_stats"])
    del stats["backbone"]["bn_stem"]["var"]
    with pytest.raises(KeyError, match="backbone.bn_stem.running_var"):
        load_flax_variables(tm, variables["params"], stats)
    params = jax.tree_util.tree_map(lambda x: x, variables["params"])
    params["backbone"]["stem"]["kernel"] = np.zeros((7, 7, 1, 64), np.float32)
    with pytest.raises(ValueError, match="params/backbone/stem/kernel"):
        load_flax_variables(tm, params, variables["batch_stats"])


# ---------------------------------------------------------------------------
# CLUB and the auxiliary modules.
# ---------------------------------------------------------------------------


def test_club_matches_jax():
    rng = np.random.default_rng(7)
    mu, y = rng.normal(size=(6, 5)).astype(np.float32), rng.normal(size=(6, 5)).astype(np.float32)
    rel_close(club.club_mean_mi(torch.tensor(mu), torch.tensor(y)), jclub.club_mean_mi(mu, y))
    rel_close(club.club_learning_loss(torch.tensor(mu), torch.tensor(y)), jclub.club_learning_loss(mu, y))


def test_estimate_v_has_one_definition():
    from edrl_tpu_torch.train import visualize

    assert visualize.estimate_v is auxiliary.estimate_v
    z = np.random.default_rng(8).normal(size=(3, 50, 4)).astype(np.float32) * 1.5
    rel_close(auxiliary.estimate_v(torch.tensor(z)), jaux.estimate_v(z))


def _t(x):
    return torch.tensor(np.asarray(x))


def test_auxiliary_modules_match_jax():
    rng = np.random.default_rng(9)
    x2, x3, xg = (rng.normal(size=(2, n, d)).astype(np.float32) for n, d in ((5, 16), (7, 12), (3, 8)))
    jm = jaux.MIAttentionFusion(dim_2d=16, dim_3d=12, dim_general=8, num_heads=2, out_dim=8)
    v = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(jm.init(jax.random.key(0), x2, x3, xg)))
    tm = load_flax_variables(auxiliary.MIAttentionFusion(16, 12, 8, num_heads=2, out_dim=8), v["params"])
    rel_close(tm(_t(x2), _t(x3), _t(xg)), jm.apply(v, x2, x3, xg))
    # Train mode: the attention's dropout, then the module's, with JAX's masks.
    from test_torch_train import record_jax_draws

    rec = {"uniform": [], "normal": [], "dropout": []}
    with record_jax_draws(rec):
        want = jm.apply(v, x2, x3, xg, deterministic=False, rngs={"dropout": jax.random.key(3)})
    assert len(rec["dropout"]) == 2
    rel_close(tm(_t(x2), _t(x3), _t(xg), deterministic=False, dropout_masks=[_t(m) for m in rec["dropout"]]), want)

    jp = jaux.PID(embed_dim=16, embed_dim_3d=12, num_heads=2)
    v = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(jp.init(jax.random.key(1), x2, x3)))
    tp = load_flax_variables(auxiliary.PID(embed_dim=16, embed_dim_3d=12, num_heads=2), v["params"])
    for g, w in zip(tp(_t(x2), _t(x3)), jp.apply(v, x2, x3)):
        rel_close(g, w)

    h, p, g = (rng.normal(size=(6, d)).astype(np.float32) for d in (8, 8, 8))
    je = jaux.MIEstimator(dim=8)
    v = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(je.init(jax.random.key(2), h, p, g)))
    te = load_flax_variables(auxiliary.MIEstimator(dim=8), v["params"])
    for mode in ("mi", "loss"):
        rel_close(te(_t(h), _t(p), _t(g), mode=mode), je.apply(v, h, p, g, mode=mode))
