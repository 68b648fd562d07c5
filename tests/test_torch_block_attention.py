"""The fused attention sublayer (B6), the v1 window attention adapter and the
``use_fused_block_attention`` configuration, against the JAX package on the
CPU.

The JAX side runs its Pallas kernels in interpret mode (as
``tests/test_block_attention.py`` and ``tests/test_window_attention.py`` run
them), the port its plain versions.  Inputs come from numpy seeds.
Tolerances: B6 forward rtol/atol 2e-5 and its eight gradients rtol 5e-4 /
atol 5e-5 (``tests/test_block_attention.py``'s bars); v1 forward atol 1e-5
and gradients atol 2e-4 / rtol 1e-3 (``tests/test_torch_kernels.py``'s);
modules, backbones, eval features and logits atol/rtol 1e-4
(``tests/test_torch_models.py``'s); a whole train step's loss, MMD and every
gradient atol 2e-4 / rtol 1e-3 (``tests/test_torch_train.py``'s); the fused
block against the port's unfused block on remapped parameters rtol 2e-4 /
atol 2e-5 (``TestBackboneIntegration``'s).
"""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.config import EDRLConfig as JaxEDRLConfig
from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.kernels.block_attention import attention_sublayer_fused as jax_sublayer
from edrl_tpu.kernels.window_attention import window_attention_fused as jax_window_v1
from edrl_tpu.models import layers as jlayers
from edrl_tpu.models import medfusion as jmedfusion
from edrl_tpu.models import swin2d as jswin
from edrl_tpu.models import vit3d as jvit
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.convert import flax_key_map, load_flax_variables
from edrl_tpu_torch.kernels import block_attention as ba
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.models import layers, medfusion, swin2d, vit3d
from edrl_tpu_torch.train import trainer
from test_torch_train import _leaf, _run_jax_step, port_draws

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
ATOL = RTOL = 1e-4
STEP_TOL = dict(atol=2e-4, rtol=1e-3)
GRAD_NAMES = ("x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj", "bias")
FLAG = dict(use_fused_block_attention=True)
BATCH = 3


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# B6: the plain versions against the Pallas kernel in interpret mode.
# ---------------------------------------------------------------------------


def _sublayer_inputs(rng, b=2, w=2, n=16, c=32, heads=2, wb=None):
    """``tests/test_block_attention.py``'s inputs, as numpy arrays."""
    wb = w if wb is None else wb
    return (rng.normal(size=(b, w, n, c)).astype(np.float32),
            (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
            (0.1 * rng.normal(size=(c,))).astype(np.float32),
            rng.normal(size=(c, 3 * c)).astype(np.float32) * 0.05,
            rng.normal(size=(3 * c,)).astype(np.float32) * 0.05,
            rng.normal(size=(c, c)).astype(np.float32) * 0.05,
            rng.normal(size=(c,)).astype(np.float32) * 0.05,
            rng.normal(size=(wb, heads, n, n)).astype(np.float32))


SUBLAYER_CASES = {
    "wb=W": dict(),
    "wb=1": dict(wb=1),
    "one head, W=1": dict(b=4, w=1, n=8, c=16, heads=1, wb=1),
}


@pytest.mark.parametrize("case", list(SUBLAYER_CASES))
def test_sublayer_forward_matches_pallas(rng, case):
    kw = SUBLAYER_CASES[case]
    args = _sublayer_inputs(rng, **kw)
    heads, scale = kw.get("heads", 2), 0.25
    want = jax_sublayer(*map(jnp.asarray, args), heads, scale, True)
    got = ba.attention_sublayer_fused(*map(_t, args), heads, scale)
    _close(got, want, **FWD_TOL)


@pytest.mark.parametrize("case", list(SUBLAYER_CASES))
def test_sublayer_gradients_match_pallas_vjp(rng, case):
    kw = SUBLAYER_CASES[case]
    args = _sublayer_inputs(rng, **kw)
    heads, scale = kw.get("heads", 2), 0.25
    ct = rng.normal(size=args[0].shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(jax_sublayer(*a, heads, scale, True) * ct)

    want = jax.grad(loss, argnums=tuple(range(8)))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    (ba.attention_sublayer_fused(*leaves, heads, scale) * _t(ct)).sum().backward()
    for name, leaf, w in zip(GRAD_NAMES, leaves, want):
        _close(leaf.grad, w, err_msg=f"grad of {name}", **GRAD_TOL)


def test_sublayer_backward_is_the_plain_bwd(rng):
    """The wrapper's CPU gradient is ``attention_sublayer_bwd_reference`` on
    the residuals its forward emits; those are the plain forward's."""
    args = [_t(a) for a in _sublayer_inputs(rng, wb=1)]
    dy = _t(rng.normal(size=args[0].shape).astype(np.float32))
    y, qkv, xln = ba.attention_sublayer_reference(*args, 2, 0.25)
    assert qkv.shape == (2, 2, 16, 96) and xln.shape == (2, 2, 16, 32)
    x, gamma, beta, wqkv, bqkv, wproj, bproj, bias = args
    want = ba.attention_sublayer_bwd_reference(x, xln, qkv, gamma, wqkv, wproj, bias, dy, 2, 0.25)
    leaves = [a.clone().requires_grad_() for a in args]
    got = ba.attention_sublayer_fused(*leaves, 2, 0.25)
    assert torch.equal(got, y)
    got.backward(dy)
    for name, leaf, w in zip(GRAD_NAMES, leaves, want):
        assert torch.equal(leaf.grad, w), name
    assert want[-1].shape == bias.shape  # a Wb = 1 bias gets its gradient summed over windows


def test_sublayer_cotangent_dtypes_follow_primals(rng):
    """bf16 x and weights, f32 LayerNorm parameters, biases and bias: every
    gradient has its primal's dtype (the JAX test of the same name)."""
    x, gamma, beta, wqkv, bqkv, wproj, bproj, bias = _sublayer_inputs(rng)
    bf16 = torch.bfloat16
    leaves = [_t(x).to(bf16), _t(gamma), _t(beta), _t(wqkv).to(bf16), _t(bqkv), _t(wproj).to(bf16), _t(bproj),
              _t(bias)]
    leaves = [leaf.requires_grad_() for leaf in leaves]
    y = ba.attention_sublayer_fused(*leaves, 2, 0.25)
    assert y.dtype == bf16
    y.float().sum().backward()
    for name, leaf in zip(GRAD_NAMES, leaves):
        assert leaf.grad.dtype == leaf.dtype, name


def test_sublayer_bf16_rounds_qkv_before_the_scores(rng):
    """In bf16 the port scores the rounded qkv; the TPU kernel scores the f32
    one.  The plain version copies the port kernel's roundings, so against the
    Pallas kernel in bf16 it differs by those roundings: within 2^-6 of the
    output's largest magnitude here, where one bf16 rounding of y alone is
    2^-9.  The rounded qkv and xln it emits are the TPU kernel's own."""
    x, gamma, beta, wqkv, bqkv, wproj, bproj, bias = _sublayer_inputs(rng, c=128, n=48)
    jbf = jnp.bfloat16
    jargs = (jnp.asarray(x, jbf), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(wqkv, jbf),
             jnp.asarray(bqkv), jnp.asarray(wproj, jbf), jnp.asarray(bproj), jnp.asarray(bias))
    from edrl_tpu.kernels.block_attention import _v4_fwd_call

    want_y, want_qkv, want_xln = _v4_fwd_call(*jargs, 2, 0.25, True)
    targs = [_t(np.asarray(a, np.float32)) for a in jargs]
    for i in (0, 3, 5):
        targs[i] = targs[i].bfloat16()
    y, qkv, xln = ba.attention_sublayer_reference(*targs, 2, 0.25)
    assert y.dtype == qkv.dtype == xln.dtype == torch.bfloat16
    for got, want in ((qkv, want_qkv), (xln, want_xln)):
        err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
        assert err <= 2.0 ** -8 * np.abs(np.asarray(want, np.float32)).max()
    err = np.abs(y.float().numpy() - np.asarray(want_y, np.float32)).max()
    assert err <= 2.0 ** -6 * np.abs(np.asarray(want_y, np.float32)).max()


def test_sublayer_cpu_path_counts_no_launch(rng):
    ba.reset_launch_counts()
    wa.reset_launch_counts()
    leaves = [_t(a).requires_grad_() for a in _sublayer_inputs(rng)]
    ba.attention_sublayer_fused(*leaves, 2, 0.25).sum().backward()
    assert ba.LAUNCHES == {ba.ATTENTION_SUBLAYER: 0}
    assert all(count == 0 for count in wa.LAUNCHES.values())


def test_sublayer_refuses_other_devices_and_shapes(rng):
    args = [_t(a) for a in _sublayer_inputs(rng)]
    with pytest.raises(ValueError, match="no kernel for device"):
        ba.attention_sublayer_fused(*(a.to("meta") for a in args), 2, 0.25)
    with pytest.raises(ValueError, match="bias must be"):
        ba.attention_sublayer_fused(*args[:7], args[7][:, :, :, :3], 2, 0.25)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ba.attention_sublayer_fwd_kernel(*args, 2, 0.25)


# ---------------------------------------------------------------------------
# v1: the layout adapter against window_attention_fused (interpret mode).
# ---------------------------------------------------------------------------


@pytest.fixture
def v1_case(rng):
    b, w, h, n, d = 2, 3, 2, 16, 8
    q, k = (rng.normal(size=(b, w, h, n, d)).astype(np.float32) * 0.3 for _ in range(2))
    v, do = (rng.normal(size=(b, w, h, n, d)).astype(np.float32) for _ in range(2))
    bias = rng.normal(size=(w, h, n, n)).astype(np.float32) * 0.1
    bias[:, :, :, 1::3] = -1e9  # masked keys, as the Swin shift mask makes them
    return q, k, v, bias, do


def test_v1_forward_matches_pallas(v1_case):
    q, k, v, bias, _ = v1_case
    want = jax_window_v1(*map(jnp.asarray, (q, k, v, bias)), True)
    got = wa.window_attention_fused(*map(_t, (q, k, v, bias)))
    _close(got, want, atol=1e-5)
    _close(wa.window_attention_reference(*map(_t, (q, k, v, bias))), want, atol=1e-5)


def test_v1_gradients_match_pallas_vjp(v1_case):
    q, k, v, bias, do = v1_case
    _, vjp = jax.vjp(lambda *a: jax_window_v1(*a, True), *map(jnp.asarray, (q, k, v, bias)))
    want = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    wa.window_attention_fused(*leaves).backward(_t(do))
    for name, leaf, w in zip(("dq", "dk", "dv", "dbias"), leaves, want):
        _close(leaf.grad, w, err_msg=name, atol=2e-4, rtol=1e-3)
    plain = wa.window_attention_bwd_reference(*map(_t, (q, k, v, bias, do)))
    for leaf, p in zip(leaves, plain):
        assert torch.equal(leaf.grad, p)


def test_v1_is_b2_through_the_packed_layout(v1_case):
    """Packing q, k, v into B2's [B, W, N, 3C] and running B2 with scale 1 is
    v1, forward and backward: what the adapter does on the card."""
    q, k, v, bias, do = map(_t, v1_case)
    qkv = wa._pack_qkv(q, k, v)
    o = wa.window_attention_v2_reference(qkv, bias, 2, 1.0)
    torch.testing.assert_close(wa._unpack_heads(o, 2), wa.window_attention_reference(q, k, v, bias))
    dqkv, dbias = wa.window_attention_v2_bwd_reference(qkv, bias, wa._pack_heads(do), 2, 1.0)
    want = wa.window_attention_bwd_reference(q, k, v, bias, do)
    for got, w in zip((*(wa._unpack_heads(t, 2) for t in dqkv.chunk(3, dim=-1)), dbias), want):
        torch.testing.assert_close(got, w)


def test_v1_refuses_shapes_and_devices(v1_case):
    q, k, v, bias, _ = map(_t, v1_case)
    with pytest.raises(ValueError, match="bias must be"):
        wa.window_attention_fused(q, k, v, bias[:1])
    with pytest.raises(ValueError, match="no kernel for device"):
        wa.window_attention_fused(*(t.to("meta") for t in (q, k, v, bias)))


# ---------------------------------------------------------------------------
# The blocks and backbones with the flag, against flax.
# ---------------------------------------------------------------------------


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))


def _init(module, rng, *args, **kwargs):
    """flax init -> numpy variables with perturbed parameters."""
    variables = _np_tree(jax.jit(functools.partial(module.init, **kwargs))(jax.random.key(0), *args))
    return {"params": jax.tree_util.tree_map(
        lambda a: (a + rng.normal(scale=0.05, size=np.shape(a))).astype(np.float32), variables["params"])}


def _apply(module, variables, *args, **kwargs):
    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


SUBLAYER_LEAVES = {"ln1_scale", "ln1_bias", "qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias"}


def test_self_attention_block_matches_flax(rng):
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    jm = jlayers.SelfAttentionBlock(dim=32, num_heads=2, **FLAG)
    v = _init(jm, rng, x)
    assert set(v["params"]) == SUBLAYER_LEAVES | {"LayerNorm_1", "Mlp_0"}
    tm = load_flax_variables(layers.SelfAttentionBlock(32, 2, **FLAG), v["params"])
    _close(tm(_t(x)), _apply(jm, v, x), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_matches_flax_forward_and_gradients(rng, shift):
    x = rng.normal(size=(2, 4, 16, 32)).astype(np.float32)
    jm = jswin.SwinBlock(dim=32, grid=8, num_heads=2, window=4, shift=shift, remat_attention=False, **FLAG)
    v = _init(jm, rng, x)
    assert set(v["params"]) == SUBLAYER_LEAVES | {"rel_bias_table", "LayerNorm_1", "Mlp_0"}
    tm = load_flax_variables(swin2d.SwinBlock(32, 8, 2, 4, shift, **FLAG), v["params"])
    ct = rng.normal(size=x.shape).astype(np.float32)
    tx = _t(x).requires_grad_()
    y = tm(tx)
    _close(y, _apply(jm, v, x), atol=ATOL, rtol=RTOL)
    (y * _t(ct)).sum().backward()

    def loss(params, xin):
        return jnp.sum(jm.apply({"params": params}, xin) * ct)

    gparams, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    _close(tx.grad, gx, **STEP_TOL)
    for name, flax_path in flax_key_map(tm, v["params"]).items():
        want = _leaf(gparams, flax_path)
        p = dict(tm.named_parameters())[name]
        _close(p.grad, want.T if flax_path.endswith("/kernel") else want, err_msg=name, **STEP_TOL)


def test_vit3d_matches_flax(rng):
    x = rng.uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)
    kw = dict(volume_size=16, patch_size=8, dim=32, depth=2, num_heads=2)
    jm = jvit.ViT3D(**kw, **FLAG)
    v = _init(jm, rng, x)
    tm = load_flax_variables(vit3d.ViT3D(**kw, **FLAG), v["params"])
    (tok, pooled), (jtok, jpooled) = tm(_t(x)), _apply(jm, v, x)
    _close(tok, jtok, atol=ATOL, rtol=RTOL)
    _close(pooled, jpooled, atol=ATOL, rtol=RTOL)


def test_swin_transformer_matches_flax(rng):
    x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    kw = dict(img_size=32, patch_size=4, embed_dim=32, depths=(2, 1), num_heads=(2, 4), window=4, **FLAG)
    jm = jswin.SwinTransformer2D(**kw, remat_attention=False)
    v = _init(jm, rng, x)
    tm = load_flax_variables(swin2d.SwinTransformer2D(**kw), v["params"])
    assert sum(m.fused_block for m in tm.modules() if isinstance(m, swin2d.SwinBlock)) == 3
    (tok, pooled), (jtok, jpooled) = tm(_t(x)), _apply(jm, v, x)
    _close(tok, jtok, atol=ATOL, rtol=RTOL)
    _close(pooled, jpooled, atol=ATOL, rtol=RTOL)


def _remap_swin_block(sd, prefix):
    """The unfused SwinBlock's tensors -> the fused layout's."""
    out = {}
    for src, dst in (("LayerNorm_0.weight", "ln1_scale"), ("LayerNorm_0.bias", "ln1_bias"),
                     ("WindowAttention_0.qkv.bias", "qkv_bias"), ("WindowAttention_0.proj.bias", "proj_bias"),
                     ("WindowAttention_0.rel_bias_table", "rel_bias_table")):
        out[prefix + dst] = sd[prefix + src]
    out[prefix + "qkv_kernel"] = sd[prefix + "WindowAttention_0.qkv.weight"].T
    out[prefix + "proj_kernel"] = sd[prefix + "WindowAttention_0.proj.weight"].T
    return out


def _remap_vit_block(sd, prefix):
    att = prefix + "MultiHeadAttention_0."
    return {prefix + "ln1_scale": sd[prefix + "LayerNorm_0.weight"], prefix + "ln1_bias": sd[prefix + "LayerNorm_0.bias"],
            prefix + "qkv_kernel": torch.cat([sd[att + f"{p}.weight"].T for p in "qkv"], dim=1),
            prefix + "qkv_bias": torch.cat([sd[att + f"{p}.bias"] for p in "qkv"]),
            prefix + "proj_kernel": sd[att + "proj.weight"].T, prefix + "proj_bias": sd[att + "proj.bias"]}


def _remapped(unfused, fused, remap):
    """Load ``fused`` from ``unfused``'s tensors: remapped where the layout
    differs, as they are elsewhere."""
    sd = unfused.state_dict()
    out = {}
    for name in fused.state_dict():
        block = name.split(".")[0] + "."
        out[name] = remap(sd, block)[name] if name not in sd else sd[name]
    fused.load_state_dict(out)
    return fused


@pytest.mark.parametrize("backbone", ["swin", "vit"])
def test_fused_block_is_the_unfused_block_on_remapped_params(backbone):
    """The flag computes the same function as the port's unfused path."""
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((2, 32, 32, 3) if backbone == "swin" else (2, 16, 16, 16, 1), generator=gen)
    if backbone == "swin":
        kw = dict(img_size=32, patch_size=4, embed_dim=32, depths=(2, 1), num_heads=(2, 4), window=4)
        make, remap = swin2d.SwinTransformer2D, _remap_swin_block
    else:
        kw = dict(volume_size=16, patch_size=8, dim=32, depth=2, num_heads=2)
        make, remap = vit3d.ViT3D, _remap_vit_block
    unfused = layers.init_parameters(make(**kw), gen)
    with torch.no_grad():
        for p in unfused.parameters():  # non-trivial LayerNorm parameters and biases
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    fused = _remapped(unfused, make(**kw, **FLAG), remap)
    torch.testing.assert_close(fused(x)[0], unfused(x)[0], rtol=2e-4, atol=2e-5)


def test_load_fills_the_flat_layout_strictly(rng):
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    v = _init(jlayers.SelfAttentionBlock(dim=32, num_heads=2, **FLAG), rng, x)
    tm = load_flax_variables(layers.SelfAttentionBlock(32, 2, **FLAG), v["params"])
    # The flat kernels keep flax's [in, out] layout: convert transposes only
    # leaves named ``kernel``.
    np.testing.assert_array_equal(tm.qkv_kernel.detach().numpy(), v["params"]["qkv_kernel"])
    np.testing.assert_array_equal(tm.proj_kernel.detach().numpy(), v["params"]["proj_kernel"])
    np.testing.assert_array_equal(tm.ln1_scale.detach().numpy(), v["params"]["ln1_scale"])
    missing = {k: a for k, a in v["params"].items() if k != "qkv_bias"}
    with pytest.raises(KeyError, match="qkv_bias"):
        load_flax_variables(layers.SelfAttentionBlock(32, 2, **FLAG), missing)
    with pytest.raises(ValueError, match="qkv_kernel"):
        load_flax_variables(layers.SelfAttentionBlock(32, 2, **FLAG),
                            {**v["params"], "qkv_kernel": v["params"]["qkv_kernel"].T})
    with pytest.raises(KeyError, match="no torch tensor"):
        load_flax_variables(layers.SelfAttentionBlock(32, 2), v["params"])


def test_full_width_flat_layout_maps_every_leaf():
    """At full width the flag's flax tree maps onto the port's module leaf for leaf."""
    jcfg = JaxEDRLConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **FLAG))
    tcfg = tconfig.EDRLConfig()
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **FLAG))
    d = jcfg.data
    jm = jmedfusion.MedFusion(cfg=jcfg.model, fundus_size=d.fundus_size, oct_size=d.oct_size)
    shapes = jax.eval_shape(
        functools.partial(jm.init, train=False), {"params": jax.random.key(0), "sample": jax.random.key(1)},
        np.zeros((1, d.fundus_size, d.fundus_size, 3), np.float32), np.zeros((1, *d.oct_size, 1), np.float32))
    tm = medfusion.MedFusion(tcfg.model, d.fundus_size, d.oct_size, device="meta")
    key_map = flax_key_map(tm, shapes["params"], shapes["batch_stats"])
    assert len(key_map) == len(tm.state_dict())
    assert key_map["transformer_2d.SwinBlock_11.qkv_kernel"] == "params/transformer_2d/SwinBlock_11/qkv_kernel"
    assert key_map["transformer_3d.SelfAttentionBlock_0.ln1_scale"] == (
        "params/transformer_3d/SelfAttentionBlock_0/ln1_scale")
    assert sum(getattr(m, "fused_block", False) for m in tm.modules()) == 24


def test_serving_cast_keeps_the_sublayer_biases_f32(rng):
    block = swin2d.SwinBlock(128, 8, 2, 4, 2, dtype=torch.bfloat16, **FLAG)
    layers.init_parameters(block, torch.Generator().manual_seed(0))
    block.qkv_bias.data.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.tensor(rng.normal(size=(2, 4, 16, 128)).astype(np.float32)).bfloat16()
    want = block(x)
    layers.cast_dense_weights_(block)
    assert (block.qkv_kernel.dtype, block.proj_kernel.dtype) == (torch.bfloat16, torch.bfloat16)
    assert all(getattr(block, n).dtype == torch.float32
               for n in ("ln1_scale", "ln1_bias", "qkv_bias", "proj_bias", "rel_bias_table"))
    assert torch.equal(block(x), want)


def test_sublayer_init_uses_the_flax_fan_in():
    block = layers.SelfAttentionBlock(256, 2, **FLAG)
    layers.init_parameters(block, torch.Generator().manual_seed(0))
    assert torch.equal(block.ln1_scale, torch.ones(256)) and not block.qkv_bias.any()
    for w in (block.qkv_kernel, block.proj_kernel):
        assert abs(float(w.detach().std()) * np.sqrt(256) - 1.0) < 0.05


# ---------------------------------------------------------------------------
# The tiny config with the flag: eval and one whole train step against JAX.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flag_case():
    jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, **FLAG))
                  for c in (jax_tiny_config(batch_size=BATCH), tconfig.tiny_test_config(batch_size=BATCH)))
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


def test_tiny_config_eval_matches_jax(flag_case):
    jcfg, tcfg, variables, batch = flag_case
    d, m = jcfg.data, jcfg.model
    jm = jmedfusion.MedFusion(cfg=m, fundus_size=d.fundus_size, oct_size=d.oct_size)
    f, o, y = batch["fundus_low"], batch["oct_low"], batch["label"]
    logits, loss, combined, _ = jax.jit(functools.partial(jm.apply, train=False))(variables, f, o, y)
    ku1, ku2 = jax.random.split(jax.random.key(1))
    shape = (BATCH, m.num_classes, m.z_dim)
    u = tuple(_t(jax.random.uniform(k, shape)) for k in (ku1, ku2))
    eps = _t(jax.random.normal(jax.random.key(1), (m.num_classes, m.sample_num, m.z_dim)))
    tm = load_flax_variables(medfusion.MedFusion(tcfg.model, d.fundus_size, d.oct_size, device="cpu"),
                             variables["params"], variables["batch_stats"]).eval()
    assert sum(getattr(mod, "fused_block", False) for mod in tm.modules()) == sum(m.swin_depths) + m.vit3d_depth
    with torch.no_grad():
        tlogits, tloss, tcombined, _ = tm(_t(f), _t(o), _t(y).long(), guided_uniform=u, eprl_eps=eps)
    _close(tcombined, combined, atol=ATOL, rtol=RTOL)
    _close(tlogits, logits, atol=ATOL, rtol=RTOL)
    _close(torch.softmax(tlogits, -1), jax.nn.softmax(logits, -1), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=RTOL)


def test_tiny_config_train_step_matches_jax(flag_case):
    jcfg, tcfg, variables, batch = flag_case
    jout, jgrads, _, rec = _run_jax_step(jcfg, variables, batch)
    state = trainer.init_state(tcfg, device="cpu", variables=variables)
    ba.reset_launch_counts()
    out = trainer.make_train_step(tcfg)(state, batch, torch.Generator(), draws=port_draws(rec, 2))
    assert ba.LAUNCHES[ba.ATTENTION_SUBLAYER] == 0  # the CPU runs no kernel
    for key in ("loss", "mmd"):
        np.testing.assert_allclose(float(out[key]), float(jout[key]), err_msg=key, **STEP_TOL)
    key_map = flax_key_map(state.model, variables["params"], variables["batch_stats"])
    assert sum(path.endswith("/qkv_kernel") for path in key_map.values()) == 4
    for name, p in state.model.named_parameters():
        want = _leaf(jgrads, key_map[name])
        _close(p.grad, want.T if key_map[name].endswith("/kernel") else want, err_msg=name, **STEP_TOL)
