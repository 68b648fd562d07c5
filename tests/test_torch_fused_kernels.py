"""The port's B4 (fused LayerNorm) and B5 (fused MLP) against the JAX Pallas
kernels in interpret mode, on the CPU.

On a CPU tensor each wrapper takes its plain PyTorch versions.  Inputs come
from numpy seeds; M is not a multiple of any tile.  Tolerances and why:

- B4 in f32: forward atol 1e-5, gradients atol 1e-4 / rtol 1e-4
  (``tests/test_layer_norm.py``'s bars).  In bf16: dx and y within one bf16
  ulp of the Pallas result (both compute in f32 and round once; the f32
  values differ in their last bits, which can move a rounding by one ulp);
  dgamma and dbeta are f32 sums, at rtol 1e-4.
- B5 in f32 mode: u stays f32 and both versions round the same values (the
  weights and the activation) to bf16, so they agree to f32 rounding: atol
  1e-5 relative to the result's largest magnitude.  In bf16 mode the
  result is bf16: one bf16 ulp of the largest magnitude (2^-8 of it).
  Gradients (all f32 but du): 1e-4 of each tensor's largest magnitude in
  f32 mode, 2^-8 in bf16 mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels.fused_mlp import fused_mlp as jax_fused_mlp
from edrl_tpu.kernels.fused_mlp import mlp_reference as jax_mlp_reference
from edrl_tpu.kernels.layer_norm import fused_layer_norm as jax_fused_layer_norm
from edrl_tpu_torch.kernels import fused_mlp as fm
from edrl_tpu_torch.kernels import layer_norm as ln

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_jax(x, jdtype):
    return jnp.asarray(x).astype(jdtype)


def _to_torch(x, tdtype):
    return torch.tensor(np.asarray(x, np.float32)).to(tdtype)


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _within_bf16_ulp(got, want):
    got, want = _np32(got), _np32(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


def _rel_close(got, want, rel):
    got, want = _np32(got), _np32(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (np.abs(got - want).max(), np.abs(want).max())


# ---------------------------------------------------------------------------
# B4
# ---------------------------------------------------------------------------


def _ln_case(c, seed=0, m=37):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, c)).astype(np.float32) * 2 + 0.5
    gamma = (1 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    dy = rng.normal(size=(m, c)).astype(np.float32)
    return x, gamma, beta, dy


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [16, 128, 768])
def test_layer_norm_plain_matches_pallas(dtype, c):
    jdt, tdt = DTYPES[dtype]
    x, gamma, beta, _ = _ln_case(c)
    want = jax_fused_layer_norm(_to_jax(x, jdt), jnp.asarray(gamma), jnp.asarray(beta), 1e-6, True)
    got = ln.fused_layer_norm(_to_torch(x, tdt), torch.tensor(gamma), torch.tensor(beta))
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:
        _within_bf16_ulp(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [16, 128, 768])
def test_layer_norm_vjp_matches_pallas(dtype, c):
    jdt, tdt = DTYPES[dtype]
    x, gamma, beta, dy = _ln_case(c, seed=1)
    _, vjp = jax.vjp(lambda a, g, b: jax_fused_layer_norm(a, g, b, 1e-6, True),
                     _to_jax(x, jdt), jnp.asarray(gamma), jnp.asarray(beta))
    want_dx, want_dg, want_db = vjp(_to_jax(dy, jdt))
    tx = _to_torch(x, tdt).requires_grad_()
    tg, tb = torch.tensor(gamma, requires_grad=True), torch.tensor(beta, requires_grad=True)
    ln.fused_layer_norm(tx, tg, tb).backward(_to_torch(dy, tdt))
    assert tx.grad.dtype == tdt and tg.grad.dtype == torch.float32
    if dtype == "f32":
        for got, want in ((tx.grad, want_dx), (tg.grad, want_dg), (tb.grad, want_db)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    else:
        _within_bf16_ulp(tx.grad, want_dx)
        for got, want in ((tg.grad, want_dg), (tb.grad, want_db)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_layer_norm_bwd_reference_matches_autograd_of_forward(rng):
    x = torch.tensor(rng.normal(size=(9, 128)).astype(np.float32), requires_grad=True)
    g = torch.tensor(rng.normal(size=(128,)).astype(np.float32), requires_grad=True)
    b = torch.tensor(rng.normal(size=(128,)).astype(np.float32), requires_grad=True)
    dy = torch.tensor(rng.normal(size=(9, 128)).astype(np.float32))
    ln.layer_norm_reference(x, g, b).backward(dy)
    dx, dg, db = ln.layer_norm_bwd_reference(x.detach(), dy, g.detach())
    for got, want in ((dx, x.grad), (dg, g.grad), (db, b.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_layer_norm_cpu_path_counts_no_launch(rng):
    ln.reset_launch_counts()
    x = torch.tensor(rng.normal(size=(4, 128)).astype(np.float32), requires_grad=True)
    ln.fused_layer_norm(x, torch.ones(128), torch.zeros(128)).sum().backward()
    assert ln.LAUNCHES == {ln.LAYER_NORM: 0, ln.LAYER_NORM_BWD: 0}


def test_layer_norm_refuses_other_devices_and_shapes():
    with pytest.raises(ValueError, match="no kernel for device"):
        ln.fused_layer_norm(torch.empty((2, 128), device="meta"), torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match=r"\[M, C\]"):
        ln.fused_layer_norm(torch.zeros((2, 3, 128)), torch.ones(128), torch.zeros(128))


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------


def _mlp_case(m, c, h, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(m, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, h)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(h,))).astype(np.float32)
    w2 = (rng.normal(size=(h, c)) / np.sqrt(h)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    dy = rng.normal(size=(m, c)).astype(np.float32)
    return u, w1, b1, w2, b2, dy


MLP_SHAPES = [(37, 128, 256), (32, 16, 64)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,c,h", MLP_SHAPES)
def test_fused_mlp_plain_matches_pallas(dtype, m, c, h):
    jdt, tdt = DTYPES[dtype]
    u, w1, b1, w2, b2, _ = _mlp_case(m, c, h)
    want = jax_fused_mlp(_to_jax(u, jdt), *map(jnp.asarray, (w1, b1, w2, b2)), True)
    got = fm.fused_mlp(_to_torch(u, tdt), *map(torch.tensor, (w1, b1, w2, b2)))
    assert got.dtype == tdt
    _rel_close(got, want, 1e-5 if dtype == "f32" else 2.0 ** -8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,c,h", MLP_SHAPES)
def test_fused_mlp_vjp_matches_pallas(dtype, m, c, h):
    jdt, tdt = DTYPES[dtype]
    u, w1, b1, w2, b2, dy = _mlp_case(m, c, h, seed=1)
    _, vjp = jax.vjp(lambda *a: jax_fused_mlp(*a, True), _to_jax(u, jdt), *map(jnp.asarray, (w1, b1, w2, b2)))
    want = vjp(_to_jax(dy, jdt))
    leaves = [_to_torch(u, tdt).requires_grad_()] + [torch.tensor(a, requires_grad=True) for a in (w1, b1, w2, b2)]
    fm.fused_mlp(*leaves).backward(_to_torch(dy, tdt))
    assert leaves[0].grad.dtype == tdt
    for leaf, w in zip(leaves, want):
        _rel_close(leaf.grad, w, 1e-4 if dtype == "f32" else 2.0 ** -8)


def test_fused_mlp_bwd_reference_is_the_wrapper_gradient():
    u, w1, b1, w2, b2, dy = _mlp_case(37, 128, 256, seed=2)
    leaves = [torch.tensor(a, requires_grad=True) for a in (u, w1, b1, w2, b2)]
    fm.fused_mlp(*leaves).backward(torch.tensor(dy))
    want = fm.fused_mlp_bwd_reference(*map(torch.tensor, (u, dy, w1, b1, w2)))
    for leaf, w in zip(leaves, want):
        np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy())


def test_mlp_reference_is_not_the_kernels_f32_function():
    """``mlp_reference`` rounds u to bf16; the kernel keeps an f32 u.  The
    plain version must follow the kernel (it does, to 1e-5, above), so it
    must not be "simplified" onto ``mlp_reference``, which is 1e-2 away."""
    u, w1, b1, w2, b2, _ = _mlp_case(32, 16, 64)
    kernel = np.asarray(jax_fused_mlp(*map(jnp.asarray, (u, w1, b1, w2, b2)), True))
    reference = np.asarray(jax_mlp_reference(*map(jnp.asarray, (u, w1, b1, w2, b2))))
    plain = fm.fused_mlp_reference(*map(torch.tensor, (u, w1, b1, w2, b2))).numpy()
    assert np.abs(kernel - reference).max() > 1e-3
    assert np.abs(plain - kernel).max() < 1e-5


def test_fused_mlp_saves_no_hidden():
    """The autograd node keeps (u, w1, b1, w2), as the JAX VJP does."""
    u, w1, b1, w2, b2, _ = _mlp_case(8, 128, 256)
    leaves = [torch.tensor(a, requires_grad=True) for a in (u, w1, b1, w2, b2)]
    y = fm.fused_mlp(*leaves)
    assert [tuple(t.shape) for t in y.grad_fn.saved_tensors] == [(8, 128), (128, 256), (256,), (256, 128)]


def test_fused_mlp_cpu_path_counts_no_launch():
    fm.reset_launch_counts()
    u, w1, b1, w2, b2, _ = _mlp_case(8, 128, 256)
    u_t = torch.tensor(u, requires_grad=True)
    fm.fused_mlp(u_t, *map(torch.tensor, (w1, b1, w2, b2))).sum().backward()
    assert fm.LAUNCHES == {fm.FUSED_MLP: 0, fm.FUSED_MLP_BWD: 0}


def test_fused_mlp_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        fm.fused_mlp(torch.empty((2, 128), device="meta"), torch.empty((128, 256), device="meta"),
                     None, None, None)
