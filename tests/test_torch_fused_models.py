"""The port's modules and the MedFusion slice with ``use_fused_ln`` and
``use_fused_mlp`` on, against their flax twins with the same flags, on the CPU
in f32.

At widths that are multiples of 128 both stacks take the fused path (the JAX
side runs the B4/B5 Pallas kernels in interpret mode, the port their plain
versions); at other widths both fall back to the unfused modules and build
the unfused parameter tree.  Tolerances: module outputs, eval features,
logits and probabilities atol 1e-4 / rtol 1e-4 (``test_torch_models.py``'s
bars); a whole train step's loss, MMD and every gradient atol 2e-4 / rtol
1e-3 (``test_torch_train.py``'s).

Downstream of a fused MLP one allowance is made.  In f32 mode the MLP
rounds its activation gelu(hidden) to bf16, as the TPU kernel does.  The two
stacks' inputs to it differ by f32 rounding (their attention and LayerNorm
sum in other orders), so now and then a hidden value next to a bf16 rounding
boundary rounds the other way in one stack, which moves that row's output by
w2 times one bf16 ulp of the activation (~1e-3 here), far above f32
rounding; the backward carries it into the gradients.  The JAX package does
the same to itself: fed inputs scaled by (1 + 2^-22), two f32 ulps, its own
step's gradients move by as much (``_close_or_within_jax_spread``).  Such
results must meet the bar above, or else differ from JAX's by at most three
times JAX's own change under that perturbation (2^-16 for the single
modules, whose few hidden values seldom flip at 2^-22), plus the atol.
"""

import dataclasses
import functools

import flax
import jax
import numpy as np
import pytest
import torch

from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.models import layers as jlayers
from edrl_tpu.models import medfusion as jmedfusion
from edrl_tpu.models import swin2d as jswin
from edrl_tpu.models import vit3d as jvit
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.convert import flax_key_map, load_flax_variables
from edrl_tpu_torch.kernels import fused_mlp as fm
from edrl_tpu_torch.kernels import layer_norm as ln
from edrl_tpu_torch.models import layers, medfusion, swin2d, vit3d
from edrl_tpu_torch.train import trainer
from test_torch_train import _leaf, _run_jax_step, port_draws

ATOL = RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
FLAGS = dict(use_fused_ln=True, use_fused_mlp=True)
BATCH = 3


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))


def _init(module, rng, *args, **kwargs):
    """flax init -> numpy variables with perturbed parameters."""
    variables = _np_tree(jax.jit(functools.partial(module.init, **kwargs))(jax.random.key(0), *args))
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(scale=0.05, size=np.shape(a))).astype(np.float32), variables["params"])
    return {"params": params}


def _apply(module, variables, *args, **kwargs):
    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _close_or_within_jax_spread(got, want, want_perturbed, atol=ATOL, rtol=RTOL):
    """``got`` meets the bar, or its worst error is within 3x JAX's own change
    under a tiny input perturbation, plus atol (see the module docstring)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want, want_perturbed = np.asarray(want), np.asarray(want_perturbed)
    if np.allclose(got, want, atol=atol, rtol=rtol):
        return
    err, spread = float(np.abs(got - want).max()), float(np.abs(want_perturbed - want).max())
    assert err <= 3.0 * spread + atol, f"error {err} over 3 x JAX's own spread {spread} + {atol}"


def _perturbed(x, scale=2.0 ** -16):
    return (x * np.float32(1.0 + scale)).astype(x.dtype)


def _count_primitive(jaxpr, name: str) -> int:
    """Equations named ``name`` in a jaxpr and every jaxpr nested in it."""
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == name
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else (value,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n += _count_primitive(inner, name)
    return n


def _fused_modules(model):
    return ([m for m in model.modules() if isinstance(m, layers.LayerNorm) and m.fused],
            [m for m in model.modules() if isinstance(m, layers.Mlp) and m.fused])


# ---------------------------------------------------------------------------
# Modules with the flags on, at widths that route.
# ---------------------------------------------------------------------------


def test_layer_norm_fused(rng):
    x = rng.normal(size=(3, 5, 256)).astype(np.float32) * 2 + 1
    jm = jlayers.FusedLayerNorm(use_fused=True)
    v = _init(jm, rng, x)
    tm = load_flax_variables(layers.LayerNorm(256, use_fused=True), v["params"])
    assert tm.fused
    _close(tm(_t(x)), _apply(jm, v, x))


def test_mlp_fused_owns_flax_layout_params(rng):
    """The fused MLP's w1/b1/w2/b2 load strictly, untransposed."""
    x = rng.normal(size=(2, 7, 128)).astype(np.float32)
    jm = jlayers.Mlp(hidden_dim=256, out_dim=128, use_fused=True)
    v = _init(jm, rng, x)
    assert set(v["params"]) == {"w1", "b1", "w2", "b2"}
    tm = load_flax_variables(layers.Mlp(128, 256, 128, use_fused=True), v["params"])
    np.testing.assert_array_equal(tm.w1.detach().numpy(), v["params"]["w1"])
    np.testing.assert_array_equal(tm.w2.detach().numpy(), v["params"]["w2"])
    _close(tm(_t(x)), _apply(jm, v, x))


def test_self_attention_block_fused(rng):
    x = rng.normal(size=(2, 16, 128)).astype(np.float32)
    jm = jlayers.SelfAttentionBlock(dim=128, num_heads=2, use_fused_attention=True, **FLAGS)
    v = _init(jm, rng, x)
    tm = load_flax_variables(layers.SelfAttentionBlock(128, 2, use_fused_attention=True, **FLAGS),
                             v["params"])
    assert [len(group) for group in _fused_modules(tm)] == [2, 1]
    _close_or_within_jax_spread(tm(_t(x)), _apply(jm, v, x), _apply(jm, v, _perturbed(x)))


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_fused(rng, shift):
    x = rng.normal(size=(2, 4, 16, 128)).astype(np.float32)
    jm = jswin.SwinBlock(dim=128, grid=8, num_heads=2, window=4, shift=shift, remat_attention=False,
                         use_fused_attention=True, **FLAGS)
    v = _init(jm, rng, x)
    tm = load_flax_variables(swin2d.SwinBlock(128, 8, 2, 4, shift, use_fused_attention=True, **FLAGS),
                             v["params"])
    _close_or_within_jax_spread(tm(_t(x)), _apply(jm, v, x), _apply(jm, v, _perturbed(x)))


def test_patch_merging_fused(rng):
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)  # LayerNorm over 4 * 32 = 128
    jm = jswin.PatchMerging(dim=32, use_fused_ln=True)
    v = _init(jm, rng, x)
    tm = load_flax_variables(swin2d.PatchMerging(32, use_fused_ln=True), v["params"])
    assert tm.LayerNorm_0.fused
    _close(tm(_t(x)), _apply(jm, v, x))


def test_vit3d_fused(rng):
    x = rng.uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)
    kw = dict(volume_size=16, patch_size=8, dim=128, depth=2, num_heads=2)
    jm = jvit.ViT3D(**kw, use_fused_attention=True, **FLAGS)
    v = _init(jm, rng, x)
    tm = load_flax_variables(vit3d.ViT3D(**kw, use_fused_attention=True, **FLAGS), v["params"])
    assert [len(group) for group in _fused_modules(tm)] == [5, 2]
    (tok, pooled), (jtok, jpooled) = tm(_t(x)), _apply(jm, v, x)
    ptok, ppooled = _apply(jm, v, _perturbed(x))
    _close_or_within_jax_spread(tok, jtok, ptok)
    _close_or_within_jax_spread(pooled, jpooled, ppooled)


def test_swin_transformer_fused(rng):
    x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    kw = dict(img_size=32, patch_size=4, embed_dim=128, depths=(2, 2), num_heads=(1, 2), window=4,
              use_fused_attention=True, **FLAGS)
    jm = jswin.SwinTransformer2D(**kw, remat_attention=False)
    v = _init(jm, rng, x)
    tm = load_flax_variables(swin2d.SwinTransformer2D(**kw), v["params"])
    # LayerNorms: after the patch embedding, 2 per block, the patch merge, final_norm.
    assert [len(group) for group in _fused_modules(tm)] == [1 + 2 * 4 + 1 + 1, 4]
    (tok, pooled), (jtok, jpooled) = tm(_t(x)), _apply(jm, v, x)
    ptok, ppooled = _apply(jm, v, _perturbed(x))
    _close_or_within_jax_spread(tok, jtok, ptok)
    _close_or_within_jax_spread(pooled, jpooled, ppooled)


def test_widths_that_do_not_route_keep_the_unfused_tree():
    """With the flags on at widths that are not multiples of 128 (the tiny
    config's 32 and 48), flax builds the unfused tree and so does the port,
    which loads it strictly."""
    jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, **FLAGS))
                  for c in (jax_tiny_config(BATCH), tconfig.tiny_test_config(BATCH)))
    d = jcfg.data
    jm = jmedfusion.MedFusion(cfg=jcfg.model, fundus_size=d.fundus_size, oct_size=d.oct_size)
    shapes = jax.eval_shape(
        functools.partial(jm.init, train=False), {"params": jax.random.key(0), "sample": jax.random.key(1)},
        np.zeros((1, d.fundus_size, d.fundus_size, 3), np.float32), np.zeros((1, *d.oct_size, 1), np.float32))
    tm = medfusion.MedFusion(tcfg.model, d.fundus_size, d.oct_size, device="cpu")
    fused_ln, fused_mlp = _fused_modules(tm)
    # Only the patch merge's LayerNorm (4 * 32 = 128 wide) routes.
    assert len(fused_ln) == 1 and fused_mlp == []
    key_map = flax_key_map(tm, shapes["params"], shapes["batch_stats"])
    assert not any(path.endswith(("/w1", "/w2")) for path in key_map.values())
    assert any(path.endswith("Mlp_0/Dense_0/kernel") for path in key_map.values())


def test_medfusion_builds_with_the_fused_flags_and_refuses_b6():
    cfg = tconfig.tiny_test_config()
    medfusion.MedFusion(dataclasses.replace(cfg.model, **FLAGS), 64, (32, 32, 32), device="meta")
    with pytest.raises(NotImplementedError, match="B6"):
        medfusion.MedFusion(dataclasses.replace(cfg.model, use_fused_block_attention=True), 64, (32, 32, 32))


def test_serving_cast_keeps_the_fused_biases_f32(rng):
    mlp = layers.Mlp(128, 256, 128, use_fused=True, dtype=torch.bfloat16)
    layers.init_parameters(mlp, torch.Generator().manual_seed(0))
    mlp.b1.data.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.tensor(rng.normal(size=(5, 128)).astype(np.float32))
    want = mlp(x)
    layers.cast_dense_weights_(mlp)
    assert (mlp.w1.dtype, mlp.w2.dtype, mlp.b1.dtype, mlp.b2.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
    assert torch.equal(mlp(x), want)


def test_fused_init_uses_the_flax_fan_in():
    """w1 [C, H] is in flax's [in, out] layout: its fan_in is C, not H."""
    mlp = layers.Mlp(128, 2048, 128, use_fused=True)
    layers.init_parameters(mlp, torch.Generator().manual_seed(0))
    for w, fan_in in ((mlp.w1, 128), (mlp.w2, 2048)):
        assert abs(float(w.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.05


# ---------------------------------------------------------------------------
# The slice: a small MedFusion whose widths are multiples of 128.
# ---------------------------------------------------------------------------


def _slice_configs():
    out = []
    for cfg in (jax_tiny_config(batch_size=BATCH), tconfig.tiny_test_config(batch_size=BATCH)):
        out.append(cfg.replace(model=dataclasses.replace(
            cfg.model, swin_embed_dim=128, swin_heads=(1, 2), fundus_embed_dim=256, oct_embed_dim=128,
            vit3d_heads=2, **FLAGS)))
    return out


# LayerNorms of one forward of the slice config: Swin 1 + 2 + 1 + 2 + 1,
# ViT-3D 2 * 2 + 1; MLPs: one per block, 2 + 2.
SLICE_LN, SLICE_MLP = 12, 4


@pytest.fixture(scope="module")
def slice_case():
    jcfg, tcfg = _slice_configs()
    _, state = jtrainer.init_state(jcfg, 0)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=np.shape(a))).astype(np.float32),
        flax.core.unfreeze(state.params))
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), flax.core.unfreeze(state.batch_stats))
    d = jcfg.data
    batch = {k: rng.uniform(size=(BATCH, d.fundus_size, d.fundus_size, 3)).astype(np.float32)
             for k in ("fundus_low", "fundus_high")}
    batch.update({k: rng.uniform(size=(BATCH, *d.oct_size, 1)).astype(np.float32) for k in ("oct_low", "oct_high")})
    batch["label"] = np.array([0, 1, 1], np.int32)
    return jcfg, tcfg, {"params": params, "batch_stats": stats}, batch


def test_slice_eval_matches_jax_on_the_pallas_path(slice_case):
    jcfg, tcfg, variables, batch = slice_case
    d, m = jcfg.data, jcfg.model
    jm = jmedfusion.MedFusion(cfg=m, fundus_size=d.fundus_size, oct_size=d.oct_size)
    f, o, y = batch["fundus_low"], batch["oct_low"], batch["label"]
    fn = functools.partial(jm.apply, train=False)
    jaxpr = jax.make_jaxpr(fn)(variables, f, o, y).jaxpr
    assert _count_primitive(jaxpr, "pallas_call") == SLICE_LN + SLICE_MLP
    logits, loss, combined, aux = jax.jit(fn)(variables, f, o, y)

    ku1, ku2 = jax.random.split(jax.random.key(1))
    shape = (BATCH, m.num_classes, m.z_dim)
    u = tuple(_t(jax.random.uniform(k, shape)) for k in (ku1, ku2))
    eps = _t(jax.random.normal(jax.random.key(1), (m.num_classes, m.sample_num, m.z_dim)))
    tm = load_flax_variables(medfusion.MedFusion(tcfg.model, d.fundus_size, d.oct_size, device="cpu"),
                             variables["params"], variables["batch_stats"]).eval()
    assert [len(group) for group in _fused_modules(tm)] == [SLICE_LN, SLICE_MLP]
    with torch.no_grad():
        tlogits, tloss, tcombined, _ = tm(_t(f), _t(o), _t(y).long(), guided_uniform=u, eprl_eps=eps)
    _close(tcombined, combined)
    _close(tlogits, logits)
    _close(torch.softmax(tlogits, -1), jax.nn.softmax(logits, -1))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=RTOL)


def test_slice_train_step_matches_jax(slice_case):
    jcfg, tcfg, variables, batch = slice_case
    jout, jgrads, _, rec = _run_jax_step(jcfg, variables, batch)
    views = {k: _perturbed(v, 2.0 ** -22) if v.dtype == np.float32 else v for k, v in batch.items()}
    _, jgrads_perturbed, _, _ = _run_jax_step(jcfg, variables, views)
    state = trainer.init_state(tcfg, device="cpu", variables=variables)
    ln.reset_launch_counts()
    fm.reset_launch_counts()
    out = trainer.make_train_step(tcfg)(state, batch, torch.Generator(), draws=port_draws(rec, 2))
    assert all(n == 0 for n in (*ln.LAUNCHES.values(), *fm.LAUNCHES.values()))  # the CPU runs no kernel
    for key in ("loss", "mmd"):
        np.testing.assert_allclose(float(out[key]), float(jout[key]), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=key)
    key_map = flax_key_map(state.model, variables["params"], variables["batch_stats"])
    assert sum(path.endswith("/w1") for path in key_map.values()) == SLICE_MLP
    for name, p in state.model.named_parameters():
        want, want_perturbed = _leaf(jgrads, key_map[name]), _leaf(jgrads_perturbed, key_map[name])
        if key_map[name].endswith("/kernel"):
            want, want_perturbed = want.T, want_perturbed.T
        try:
            _close_or_within_jax_spread(p.grad, want, want_perturbed, GRAD_ATOL, GRAD_RTOL)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
