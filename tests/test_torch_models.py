"""Port's model modules against their flax counterparts, on the CPU in f32.

Each test initialises the flax module, perturbs its parameters (so that
LayerNorm scales, biases and BN statistics are not trivial), carries them
into the torch module with ``convert.load_flax_variables`` and runs both on
the same numpy inputs.  Tolerances: features, logits and probabilities
atol 1e-4 / rtol 1e-4; losses rtol 1e-4.  With the fused-attention flags on,
the JAX side runs the Pallas kernels in interpret mode and the torch side
their plain versions.
"""

import dataclasses
import functools

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu_torch.config import tiny_test_config as port_tiny_config
from edrl_tpu.config import tiny_test_config
from edrl_tpu.models import dilr as jdilr
from edrl_tpu.models import eprl as jeprl
from edrl_tpu.models import layers as jlayers
from edrl_tpu.models import medfusion as jmedfusion
from edrl_tpu.models import poe as jpoe
from edrl_tpu.models import swin2d as jswin
from edrl_tpu.models import vit3d as jvit
from edrl_tpu_torch.convert import load_flax_variables
from edrl_tpu_torch.models import dilr, eprl, layers, medfusion, poe, swin2d, vit3d

ATOL = RTOL = 1e-4


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda a: (a + rng.normal(scale=scale, size=np.shape(a))).astype(np.float32), tree
    )


def _init(module, rng, *args, rngs=None, **kwargs):
    """flax init -> perturbed numpy variables (BN running var kept positive)."""
    init = jax.jit(functools.partial(module.init, **kwargs))
    variables = _np_tree(init(rngs or jax.random.key(0), *args))
    out = {"params": _perturb(variables["params"], rng)}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
            variables["batch_stats"],
        )
    return out


def _apply(module, variables, *args, **kwargs):
    """Jitted flax apply (eager flax dispatch is slow on the CPU)."""
    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


def _load(module, variables):
    return load_flax_variables(module, variables["params"], variables.get("batch_stats")).eval()


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _loss_close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


# ---------------------------------------------------------------------------
# models/layers.py
# ---------------------------------------------------------------------------


class TestLayers:
    def test_layer_norm(self, rng):
        x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 2 + 1
        jm = jlayers.FusedLayerNorm()
        v = _init(jm, rng, x)
        tm = _load(layers.LayerNorm(32), v)
        _close(tm(_t(x)), _apply(jm, v, x))

    def test_flax_layer_norm_fast_variance(self, rng):
        x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 2 + 1
        jm = fnn.LayerNorm()
        v = _init(jm, rng, x)
        tm = _load(layers.LayerNorm(32, fast_variance=True), v)
        _close(tm(_t(x)), _apply(jm, v, x))

    def test_mlp(self, rng):
        x = rng.normal(size=(2, 7, 16)).astype(np.float32)
        jm = jlayers.Mlp(hidden_dim=64, out_dim=16)
        v = _init(jm, rng, x)
        tm = _load(layers.Mlp(16, 64, 16), v)
        _close(tm(_t(x)), _apply(jm, v, x))

    def test_scaled_dot_attention(self, rng):
        q, k, v = (rng.normal(size=(2, 3, 4, 9, 8)).astype(np.float32) for _ in range(3))
        bias = rng.normal(size=(1, 3, 4, 9, 9)).astype(np.float32)
        want = jlayers.scaled_dot_attention(q, k, v, 0.3, bias=bias)
        _close(layers.scaled_dot_attention(_t(q), _t(k), _t(v), 0.3, bias=_t(bias)), want)

    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("nq", [16, 1])
    def test_multihead_attention(self, rng, fused, nq):
        q = rng.normal(size=(2, nq, 32)).astype(np.float32)
        kv = rng.normal(size=(2, 16, 32)).astype(np.float32)
        jm = jlayers.MultiHeadAttention(dim=32, num_heads=4, use_fused=fused)
        v = _init(jm, rng, q, kv, kv)
        tm = _load(layers.MultiHeadAttention(32, 4, use_fused=fused), v)
        _close(tm(_t(q), _t(kv), _t(kv)), _apply(jm, v, q, kv, kv))

    def test_self_attention_block(self, rng):
        x = rng.normal(size=(2, 16, 32)).astype(np.float32)
        jm = jlayers.SelfAttentionBlock(dim=32, num_heads=4, use_fused_attention=True)
        v = _init(jm, rng, x)
        tm = _load(layers.SelfAttentionBlock(32, 4, use_fused_attention=True), v)
        _close(tm(_t(x)), _apply(jm, v, x))


# ---------------------------------------------------------------------------
# models/vit3d.py and models/swin2d.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_vit3d(rng, fused):
    x = rng.uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)
    kw = dict(volume_size=16, patch_size=8, dim=32, depth=2, num_heads=4)
    jm = jvit.ViT3D(**kw, use_fused_attention=fused)
    v = _init(jm, rng, x)
    tm = _load(vit3d.ViT3D(**kw, use_fused_attention=fused), v)
    (tok, pooled), (jtok, jpooled) = tm(_t(x)), _apply(jm, v, x)
    _close(tok, jtok)
    _close(pooled, jpooled)


class TestSwinStatics:
    @pytest.mark.parametrize("window", [4, 12])
    def test_relative_position_index(self, window):
        np.testing.assert_array_equal(
            swin2d.relative_position_index(window), jswin._relative_position_index(window)
        )

    @pytest.mark.parametrize(
        "jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
    )
    def test_rel_bias_lookup_is_exact(self, rng, jdtype, tdtype):
        table = rng.normal(scale=0.02, size=(49, 3)).astype(np.float32)
        want = jswin._rel_bias_from_table(jnp.asarray(table), 4, 3, jdtype)
        index = torch.as_tensor(swin2d.relative_position_index(4))
        got = swin2d.rel_bias_from_table(_t(table), index, 3, tdtype)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize(
        "jdtype,tdtype,rtol", [(jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 1e-2)]
    )
    def test_rel_bias_table_gradient(self, rng, jdtype, tdtype, rtol):
        """The table's gradient sums the gathered entries' cotangents in f32
        (in bf16 mode too), as the one-hot product's transpose does; bf16 mode
        rounds to bf16 on the way, at different places in the two stacks."""
        table = rng.normal(scale=0.02, size=(49, 3)).astype(np.float32)
        ct = rng.normal(size=(3, 16, 16)).astype(np.float32)
        _, vjp = jax.vjp(lambda t: jswin._rel_bias_from_table(t, 4, 3, jdtype), jnp.asarray(table))
        (want,) = vjp(jnp.asarray(ct))
        ttable = torch.tensor(table, requires_grad=True)
        index = torch.as_tensor(swin2d.relative_position_index(4))
        swin2d.rel_bias_from_table(ttable, index, 3, tdtype).backward(_t(ct))
        assert ttable.grad.dtype == torch.float32
        err = np.abs(ttable.grad.numpy() - np.asarray(want, np.float32)).max()
        assert err <= rtol * np.abs(np.asarray(want, np.float32)).max()

    @pytest.mark.parametrize("grid,window,shift", [(8, 4, 2), (96, 12, 6)])
    def test_shift_mask(self, grid, window, shift):
        np.testing.assert_array_equal(
            swin2d.shift_attn_mask(grid, window, shift), jswin._shift_attn_mask(grid, window, shift)
        )

    def test_window_partition_merge_shift(self, rng):
        x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
        xw = swin2d.window_partition(_t(x), 4)
        np.testing.assert_array_equal(xw.numpy(), np.asarray(jswin.window_partition(x, 4)))
        np.testing.assert_array_equal(swin2d.window_merge(xw, 4, 8, 8).numpy(), x)
        np.testing.assert_array_equal(
            swin2d.shift_windows(xw, 4, 8, -2).numpy(),
            np.asarray(jswin._shift_windows(np.asarray(xw), 4, 8, -2)),
        )


class TestSwinModules:
    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("masked", [False, True])
    def test_window_attention(self, rng, fused, masked):
        x = rng.normal(size=(2, 4, 16, 32)).astype(np.float32)
        mask = jswin._shift_attn_mask(8, 4, 2) if masked else None
        jm = jswin.WindowAttention(dim=32, window=4, num_heads=2, use_fused=fused)
        v = _init(jm, rng, x, mask=mask)
        tm = _load(swin2d.WindowAttention(32, 4, 2, use_fused=fused), v)
        got = tm(_t(x), mask=None if mask is None else _t(mask))
        _close(got, _apply(jm, v, x, mask=mask))

    @pytest.mark.parametrize("shift", [0, 2])
    def test_swin_block(self, rng, shift):
        x = rng.normal(size=(2, 4, 16, 32)).astype(np.float32)
        jm = jswin.SwinBlock(dim=32, grid=8, num_heads=2, window=4, shift=shift,
                             remat_attention=False, use_fused_attention=True)
        v = _init(jm, rng, x)
        tm = _load(swin2d.SwinBlock(32, 8, 2, 4, shift, use_fused_attention=True), v)
        _close(tm(_t(x)), _apply(jm, v, x))

    def test_patch_merging(self, rng):
        x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
        jm = jswin.PatchMerging(dim=16)
        v = _init(jm, rng, x)
        tm = _load(swin2d.PatchMerging(16), v)
        _close(tm(_t(x)), _apply(jm, v, x))

    @pytest.mark.parametrize("fused", [False, True])
    def test_swin_transformer(self, rng, fused):
        x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
        kw = dict(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(1, 2),
                  window=4, use_fused_attention=fused)
        jm = jswin.SwinTransformer2D(**kw, remat_attention=False)
        v = _init(jm, rng, x)
        tm = _load(swin2d.SwinTransformer2D(**kw), v)
        (tok, pooled), (jtok, jpooled) = tm(_t(x)), _apply(jm, v, x)
        assert tok.shape == (2, 16, 32)
        _close(tok, jtok)
        _close(pooled, jpooled)


# ---------------------------------------------------------------------------
# models/eprl.py, poe.py, dilr.py
# ---------------------------------------------------------------------------


def test_eprl_eval(rng):
    x = rng.normal(size=(3, 16, 24)).astype(np.float32)
    eps = rng.normal(size=(2, 12, 8)).astype(np.float32)
    kw = dict(x_dim=24, num_tokens=16, z_dim=8, num_classes=2, sample_num=12, topk=5)
    jm = jeprl.EPRL(**kw)
    v = _init(jm, rng, x, train=False, eps=eps)
    tm = _load(eprl.EPRL(**{k: kw[k] for k in ("x_dim", "num_tokens")},
                         **{k: kw[k] for k in ("z_dim", "num_classes", "sample_num", "topk")}), v)
    got = tm(_t(x), eps=_t(eps))
    want = _apply(jm, v, x, train=False, eps=eps)
    for g, w in zip(got[:2] + got[3:4], want[:2] + want[3:4]):  # mu, sigma, z
        _close(g, w)
    _loss_close(got[2], want[2])  # proxy loss
    _loss_close(got[4], want[4])  # entropy


@pytest.mark.parametrize("mask", [None, (True, False), (False, True)])
@pytest.mark.parametrize("renormalize", [False, True])
def test_poe(rng, mask, renormalize):
    mus = [rng.normal(size=(3, 2, 8)).astype(np.float32) for _ in range(2)]
    vars_ = [rng.uniform(0.2, 2.0, size=(3, 2, 8)).astype(np.float32) for _ in range(2)]
    jmask = None if mask is None else jnp.asarray(mask)
    jm = jpoe.PoE(renormalize_mask=renormalize)
    v = _init(jm, rng, mus, vars_, modality_mask=jmask)
    tm = _load(poe.PoE(renormalize_mask=renormalize), v)
    tmask = None if mask is None else torch.tensor(mask)
    got = tm([_t(m) for m in mus], [_t(s) for s in vars_], modality_mask=tmask)
    _close(got, _apply(jm, v, mus, vars_, modality_mask=jmask))


def test_attention_model(rng):
    q = rng.normal(size=(2, 1, 32)).astype(np.float32)
    kv = rng.normal(size=(2, 9, 32)).astype(np.float32)
    jm = jdilr.AttentionModel(embed_dim=32, num_heads=4)
    v = _init(jm, rng, q, kv, kv)
    tm = _load(dilr.AttentionModel(32, 4), v)
    _close(tm(_t(q), _t(kv), _t(kv)), _apply(jm, v, q, kv, kv))


def test_dilr_eval_uses_running_stats(rng):
    kw = dict(fundus_dim=32, oct_dim=24, feature_dim=64, guided_in_dim=16, num_heads=4)
    args = [
        rng.normal(size=(3, 9, 32)).astype(np.float32),
        rng.normal(size=(3, 8, 24)).astype(np.float32),
        rng.normal(size=(3, 32)).astype(np.float32),
        rng.normal(size=(3, 16)).astype(np.float32),
        rng.normal(size=(3, 16)).astype(np.float32),
    ]
    jm = jdilr.DILR(**kw)
    v = _init(jm, rng, *args, train=False)
    tm = _load(dilr.DILR(**kw), v)
    combined, loss = tm(*map(_t, args))
    jcombined, jloss = _apply(jm, v, *args, train=False)
    assert combined.shape == (3, 96)
    _close(combined, jcombined)
    _loss_close(loss, jloss)


# ---------------------------------------------------------------------------
# models/medfusion.py, eval mode, with JAX's eval draws injected
# ---------------------------------------------------------------------------


def _jax_eval_draws(cfg, batch):
    """The eval noise JAX draws from its fixed keys (medfusion.py:136, eprl.py:109)."""
    m = cfg.model
    ku1, ku2 = jax.random.split(jax.random.key(1))
    shape = (batch, m.num_classes, m.z_dim)
    u = tuple(np.asarray(jax.random.uniform(k, shape)) for k in (ku1, ku2))
    eps = np.asarray(jax.random.normal(jax.random.key(1), (m.num_classes, m.sample_num, m.z_dim)))
    return u, eps


def _tiny_cfg(fused=False):
    cfg = tiny_test_config(batch_size=3)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, use_fused_attention=fused, vit_fused_attention=fused))


@pytest.fixture(scope="module")
def medfusion_case():
    """Tiny flax MedFusion variables (perturbed, non-trivial BN stats) and
    inputs; the fused flags do not change the parameter tree."""
    rng = np.random.default_rng(0)
    cfg = _tiny_cfg()
    d = cfg.data
    f = rng.uniform(size=(3, d.fundus_size, d.fundus_size, 3)).astype(np.float32)
    o = rng.uniform(size=(3, *d.oct_size, 1)).astype(np.float32)
    y = rng.integers(0, cfg.model.num_classes, size=(3,)).astype(np.int32)
    jm = jmedfusion.MedFusion(cfg=cfg.model, fundus_size=d.fundus_size, oct_size=d.oct_size)
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1), "dropout": jax.random.key(2)}
    v = _init(jm, rng, f, o, y, train=True, rngs=rngs)
    return v, (f, o, y)


def _medfusion_pair(cfg, variables):
    d = cfg.data
    jm = jmedfusion.MedFusion(cfg=cfg.model, fundus_size=d.fundus_size, oct_size=d.oct_size)
    tm = _load(medfusion.MedFusion(cfg.model, d.fundus_size, d.oct_size, device="cpu"), variables)
    return jm, tm


@pytest.mark.parametrize("fused", [False, True])
def test_medfusion_eval(medfusion_case, fused):
    cfg = _tiny_cfg(fused)
    v, (f, o, y) = medfusion_case
    jm, tm = _medfusion_pair(cfg, v)
    u, eps = _jax_eval_draws(cfg, 3)
    logits, loss, combined, aux = _apply(jm, v, f, o, y, train=False)
    with torch.no_grad():
        tlogits, tloss, tcombined, taux = tm(
            _t(f), _t(o), _t(y).long(), guided_uniform=tuple(map(_t, u)), eprl_eps=_t(eps)
        )
    _close(tlogits, logits)
    _close(torch.softmax(tlogits, -1), jax.nn.softmax(logits, -1))
    _close(tcombined, combined)
    _loss_close(tloss, loss)
    assert set(taux) == set(aux)
    for key in aux:
        _loss_close(taux[key], aux[key])


def test_medfusion_modality_mask(medfusion_case):
    cfg = _tiny_cfg()
    v, (f, o, _) = medfusion_case
    jm, tm = _medfusion_pair(cfg, v)
    u, eps = _jax_eval_draws(cfg, 3)
    mask = np.array([True, False])
    logits, _, combined, _ = _apply(jm, v, f, o, None, train=False, modality_mask=jnp.asarray(mask))
    with torch.no_grad():
        tlogits, tloss, tcombined, _ = tm(
            _t(f), _t(o), modality_mask=torch.tensor(mask),
            guided_uniform=tuple(map(_t, u)), eprl_eps=_t(eps),
        )
    _close(tlogits, logits)
    _close(tcombined, combined)
    assert float(tloss) == 0.0


def test_medfusion_refuses_train_and_unported_flags():
    """B4 and B5 are ported (``test_torch_fused_models.py``); B6 is not."""
    cfg = port_tiny_config()
    with pytest.raises(NotImplementedError, match="B6"):
        medfusion.MedFusion(
            dataclasses.replace(cfg.model, use_fused_block_attention=True), 64, (32, 32, 32)
        )
    tm = medfusion.MedFusion(cfg.model, 64, (32, 32, 32), device="meta")
    with pytest.raises(ValueError, match="train mode requires labels"):
        tm(torch.empty(1, device="meta"), torch.empty(1, device="meta"), train=True)
