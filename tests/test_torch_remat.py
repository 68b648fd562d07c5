"""Rematerialisation in the port (``remat``, ``remat_attention``), on the CPU in f32.

flax's ``nn.remat`` keeps a block's inputs and runs its forward again in the
backward instead of keeping its activations.  The port does the same with
``torch.utils.checkpoint`` at the same places (``layers.remat_call``):
``remat`` over every block of both backbones, ``remat_attention`` over the
Swin window attention where it is unfused and ``remat`` is off.

For each case, the same port model with and without the flag: the loss and
every parameter's gradient agree to 1e-6 (the recomputation repeats the
same f32 operations), and the bytes autograd saves (counted by
``torch.autograd.graph.saved_tensors_hooks``) fall.  Then the port model
with the flag against the JAX model built with the same flag, on converted
weights: tokens atol 1e-5, gradients atol 2e-4 / rtol 1e-3
(``tests/test_torch_train.py``'s bar).  With the fused flag on, JAX runs
its Pallas kernels in interpret mode and the port their plain versions.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.models import swin2d as jswin
from edrl_tpu.models import vit3d as jvit
from edrl_tpu_torch.config import tiny_test_config
from edrl_tpu_torch.convert import flax_key_map, load_flax_variables
from edrl_tpu_torch.models import medfusion, swin2d, vit3d
from edrl_tpu_torch.models.layers import init_parameters

SWIN_KW = dict(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(1, 2), window=4)
VIT_KW = dict(volume_size=16, patch_size=8, dim=32, depth=2, num_heads=4)
CASES = {
    # name: (backbone, flags with remat, the same flags without)
    "vit_remat": ("vit", dict(remat=True), dict(remat=False)),
    "vit_remat_fused": ("vit", dict(remat=True, use_fused_attention=True),
                        dict(remat=False, use_fused_attention=True)),
    "swin_remat": ("swin", dict(remat=True), dict(remat=False, remat_attention=False)),
    "swin_remat_fused": ("swin", dict(remat=True, use_fused_attention=True),
                         dict(remat=False, use_fused_attention=True)),
    "swin_remat_attention": ("swin", dict(remat_attention=True), dict(remat_attention=False)),
}
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3


def _inputs(kind, seed=0):
    """Input, and cotangents of the tokens and the pooled features."""
    rng = np.random.default_rng(seed)
    if kind == "vit":
        x = rng.uniform(size=(2, 16, 16, 16, 1))
        tokens, dim = 8, VIT_KW["dim"]
    else:
        x = rng.uniform(size=(2, 32, 32, 3))
        tokens, dim = 16, 2 * SWIN_KW["embed_dim"]
    ct = rng.normal(size=(2, tokens, dim))
    ct2 = rng.normal(size=(2, dim))
    return tuple(a.astype(np.float32) for a in (x, ct, ct2))


def _port(kind, flags):
    return vit3d.ViT3D(**VIT_KW, **flags) if kind == "vit" else swin2d.SwinTransformer2D(**SWIN_KW, **flags)


def _step(model, x, ct, ct2):
    """Loss, gradients and the bytes autograd saved in the forward."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tokens, pooled = model(torch.tensor(x))
        loss = (tokens * torch.tensor(ct)).sum() + (pooled * torch.tensor(ct2)).sum()
    loss.backward()
    grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    return float(loss.detach()), tokens.detach(), grads, sum(saved)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_keeps_the_gradients_and_saves_less(case):
    kind, on, off = CASES[case]
    x, ct, ct2 = _inputs(kind)
    plain = init_parameters(_port(kind, off), torch.Generator().manual_seed(0))
    remat = _port(kind, on)
    remat.load_state_dict(plain.state_dict())
    loss0, tokens0, grads0, bytes0 = _step(plain, x, ct, ct2)
    loss1, tokens1, grads1, bytes1 = _step(remat, x, ct, ct2)
    assert abs(loss1 - loss0) <= 1e-6 * max(1.0, abs(loss0))
    torch.testing.assert_close(tokens1, tokens0, atol=1e-6, rtol=0)
    assert set(grads1) == set(grads0)
    for name, g in grads0.items():
        torch.testing.assert_close(grads1[name], g, atol=1e-6, rtol=0, msg=name)
    assert bytes1 < bytes0, (bytes1, bytes0)


def test_remat_attention_is_moot_where_the_attention_is_fused():
    """With the fused attention (or B6) on, remat_attention rematerialises
    nothing, as in flax; under remat the blocks do not remat it again."""
    fused = swin2d.SwinTransformer2D(**SWIN_KW, use_fused_attention=True, remat_attention=True)
    block6 = swin2d.SwinTransformer2D(**SWIN_KW, use_fused_block_attention=True, remat_attention=True)
    under_remat = swin2d.SwinTransformer2D(**SWIN_KW, remat=True, remat_attention=True)
    plain = swin2d.SwinTransformer2D(**SWIN_KW, remat_attention=True)
    for model, want in ((fused, False), (block6, False), (under_remat, False), (plain, True)):
        blocks = [m for m in model.modules() if isinstance(m, swin2d.SwinBlock)]
        assert len(blocks) == sum(SWIN_KW["depths"])
        assert all(b.remat_attention is want for b in blocks)


@pytest.mark.parametrize("remat,remat_attention", [(False, True), (True, True), (False, False)])
def test_medfusion_passes_the_flags(remat, remat_attention):
    tcfg = tiny_test_config()
    cfg = dataclasses.replace(tcfg.model, remat=remat, remat_attention=remat_attention, use_fused_attention=False)
    model = medfusion.MedFusion(cfg, tcfg.data.fundus_size, tcfg.data.oct_size, device="cpu")
    assert model.transformer_2d.remat is remat and model.transformer_3d.remat is remat
    blocks = [m for m in model.transformer_2d.modules() if isinstance(m, swin2d.SwinBlock)]
    assert blocks and all(b.remat_attention is (remat_attention and not remat) for b in blocks)


def _jax_case(kind, flags, x, ct, ct2):
    """Perturbed flax variables, and the JAX model's tokens and gradients."""
    jm = jvit.ViT3D(**VIT_KW, **flags) if kind == "vit" else jswin.SwinTransformer2D(**SWIN_KW, **flags)
    variables = jax.jit(jm.init)(jax.random.key(0), x)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=np.shape(a))).astype(np.float32),
        flax.core.unfreeze(variables["params"]))

    def loss_fn(p):
        tokens, pooled = jm.apply({"params": p}, x)
        return jnp.sum(tokens * ct) + jnp.sum(pooled * ct2), tokens

    (loss, tokens), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, float(loss), np.asarray(tokens), jax.tree_util.tree_map(np.asarray, grads)


def _leaf(tree, path):
    for key in path.split("/")[1:]:
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_matches_jax(case):
    kind, on, _ = CASES[case]
    x, ct, ct2 = _inputs(kind, seed=2)
    params, jloss, jtokens, jgrads = _jax_case(kind, on, x, ct, ct2)
    model = load_flax_variables(_port(kind, on), params)
    loss, tokens, grads, _ = _step(model, x, ct, ct2)
    np.testing.assert_allclose(tokens.numpy(), jtokens, atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss, jloss, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    key_map = flax_key_map(model, params)
    if on.get("remat"):  # flax names a block under nn.remat Checkpoint<Class>_<i>
        assert any("/Checkpoint" in path for path in key_map.values())
    for name, g in grads.items():
        want = _leaf(jgrads, key_map[name])
        if key_map[name].endswith("/kernel"):
            want = want.T
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    assert len(grads) == len(jax.tree_util.tree_leaves(jgrads))
