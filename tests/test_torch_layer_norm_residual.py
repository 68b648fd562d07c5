"""B4's residual LayerNorm backward (the LayerNorm part of B6's backward)
against the JAX package's ``_v4_bwd``, on the CPU.

``layer_norm.layer_norm_bwd_residual_reference`` is the plain version of
the residual form that B6's backward runs on the card: an f32 cotangent dxln,
and the residual cotangent dy in x's dtype added to the LayerNorm's dx in f32
before dx is rounded once.  Here it is held against those lines of the JAX
VJP (``edrl_tpu/kernels/block_attention.py``, ``_v4_bwd``), which run
outside any Pallas kernel and so are written out below as they stand there,
on inputs from numpy seeds.  Tolerances: dgamma, dbeta and an f32 dx atol
1e-5 (f32 sums in other orders); a bf16 dx to one bf16 ulp of the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels.block_attention import _LN_EPS
from edrl_tpu_torch.kernels import block_attention as ba
from edrl_tpu_torch.kernels import layer_norm as ln
from edrl_tpu_torch.kernels import window_attention as wa

SHAPES = [(37, 128), (64, 256), (9, 768), (5, 1024)]


def _jax_ln_part(x, dxln, gamma, dy):
    """The LayerNorm lines of ``_v4_bwd``: ``(dx, dgamma, dbeta)``."""
    f32 = jnp.float32
    dy32 = dy.astype(f32)
    x32 = x.astype(f32)
    mu = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mu), axis=-1, keepdims=True)
    inv = jax.lax.rsqrt(var + _LN_EPS)
    xhat = (x32 - mu) * inv
    dgamma = jnp.sum(dxln * xhat, axis=0).astype(gamma.dtype)
    dbeta = jnp.sum(dxln, axis=0).astype(gamma.dtype)
    dxhat = dxln * gamma.astype(f32)
    dx_ln = inv * (
        dxhat
        - jnp.mean(dxhat, axis=-1, keepdims=True)
        - xhat * jnp.mean(dxhat * xhat, axis=-1, keepdims=True)
    )
    dx = (dy32 + dx_ln).astype(x.dtype)
    return dx, dgamma, dbeta


def _inputs(m, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, c)) * 2 + 0.5).astype(np.float32)
    dxln = rng.normal(size=(m, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    dy = rng.normal(size=(m, c)).astype(np.float32)
    return x, dxln, gamma, dy


def _bf16_ulp(v):
    """One bf16 ulp at each value of v (f32 numpy)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("m,c", SHAPES)
def test_residual_form_matches_the_jax_vjp_in_bf16(m, c):
    x, dxln, gamma, dy = _inputs(m, c, 20 + c)
    jx, jdy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    want = _jax_ln_part(jx, jnp.asarray(dxln), jnp.asarray(gamma), jdy)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).bfloat16()
    tdy = torch.tensor(np.asarray(jdy.astype(jnp.float32))).bfloat16()
    dx, dgamma, dbeta = ln.layer_norm_bwd_residual_reference(tx, torch.tensor(dxln), torch.tensor(gamma), tdy)
    assert dx.dtype == torch.bfloat16 and dgamma.dtype == dbeta.dtype == torch.float32
    want_dx = np.asarray(want[0].astype(jnp.float32))
    assert (np.abs(dx.float().numpy() - want_dx) <= _bf16_ulp(want_dx)).all()
    for got, w in zip((dgamma, dbeta), want[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,c", SHAPES)
def test_residual_form_matches_the_jax_vjp_in_f32(m, c):
    x, dxln, gamma, dy = _inputs(m, c, 40 + c)
    want = _jax_ln_part(jnp.asarray(x), jnp.asarray(dxln), jnp.asarray(gamma), jnp.asarray(dy))
    got = ln.layer_norm_bwd_residual_reference(*(torch.tensor(a) for a in (x, dxln, gamma, dy)))
    assert got[0].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_residual_form_rounds_dx_once():
    """dx is bf16(dy + the LayerNorm's f32 dx), not dy plus a rounded dx."""
    x, dxln, gamma, dy = (torch.tensor(a) for a in _inputs(64, 256, 7))
    x, dy = x.bfloat16(), dy.bfloat16()
    dx = ln.layer_norm_bwd_residual_reference(x, dxln, gamma, dy)[0]
    dx_ln = ln.layer_norm_bwd_reference(x.float(), dxln, gamma)[0]
    once = (dy.float() + dx_ln).bfloat16()
    twice = (dy.float() + dx_ln.bfloat16().float()).bfloat16()
    assert torch.equal(dx, once)
    assert (dx != twice).sum() > 0


def test_b6_reference_backward_runs_the_residual_form():
    """The B6 plain backward's dx, dgamma and dbeta are the residual form's on
    its dxln (the cotangent of xln, recomputed here as the JAX VJP does)."""
    rng = np.random.default_rng(3)
    b, w, n, c, heads = 2, 2, 16, 128, 2

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale)

    x, gamma, beta = t(b, w, n, c).bfloat16(), 1 + t(c, scale=0.1), t(c, scale=0.1)
    wqkv, bqkv = t(c, 3 * c, scale=c ** -0.5).bfloat16(), t(3 * c, scale=0.1)
    wproj, bproj, bias = t(c, c, scale=c ** -0.5).bfloat16(), t(c, scale=0.1), t(1, heads, n, n)
    y, qkv, xln = ba.attention_sublayer_reference(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, heads, 0.25)
    dy = t(b, w, n, c).bfloat16()
    got = ba.attention_sublayer_bwd_reference(x, xln, qkv, gamma, wqkv, wproj, bias, dy, heads, 0.25)
    do = (dy.float().reshape(-1, c) @ wproj.float().T).bfloat16().reshape(b, w, n, c)
    dqkv = wa.window_attention_v2_bwd_reference(qkv, bias.expand(w, heads, n, n).contiguous(), do, heads, 0.25)[0]
    dxln = dqkv.float().reshape(-1, 3 * c) @ wqkv.float().T
    want = ln.layer_norm_bwd_residual_reference(x.reshape(-1, c), dxln, gamma, dy.reshape(-1, c))
    assert torch.equal(got[0], want[0].reshape(x.shape))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
