"""Port's attention wrappers against the JAX Pallas kernels (interpret mode).

On a CPU tensor each wrapper takes its plain PyTorch versions, which are
held to the Pallas kernels run with ``interpret=True`` at the shapes of
``tests/test_window_attention.py``: forwards in f32 at atol 1e-5, backwards
(``jax.vjp`` of the fused functions) at atol 2e-4 / rtol 1e-3, that file's
gradient bar.  The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` compares them with the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels.window_attention import self_attention_fused as jax_self_attention
from edrl_tpu.kernels.window_attention import window_attention_fused_v2 as jax_window_v2
from edrl_tpu_torch.kernels import window_attention as wa


def _pack(q, k, v):
    """[B,W,H,N,D] triple -> packed [B,W,N,3C] with [3,H,D] column order."""
    b, w, h, n, d = q.shape

    def flat(x):
        return x.transpose(0, 1, 3, 2, 4).reshape(b, w, n, h * d)

    return np.concatenate([flat(q), flat(k), flat(v)], axis=-1)


@pytest.fixture
def v2_inputs(rng):
    b, w, h, n, d = 2, 4, 2, 16, 8
    q = rng.normal(size=(b, w, h, n, d)).astype(np.float32) * 0.2
    k = rng.normal(size=(b, w, h, n, d)).astype(np.float32) * 0.2
    v = rng.normal(size=(b, w, h, n, d)).astype(np.float32)
    bias = rng.normal(size=(w, h, n, n)).astype(np.float32) * 0.1
    return _pack(q, k, v), bias, h


class TestWindowAttentionV2:
    @pytest.mark.parametrize("scale", [0.7, 0.5])
    def test_plain_matches_pallas(self, v2_inputs, scale):
        qkv, bias, h = v2_inputs
        want = np.asarray(jax_window_v2(jnp.asarray(qkv), jnp.asarray(bias), h, scale, True))
        got = wa.window_attention_fused_v2(torch.tensor(qkv), torch.tensor(bias), h, scale)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    def test_shift_mask_minus_1e9(self, v2_inputs):
        """-1e9 entries (the Swin shift mask) zero those attention weights."""
        qkv, bias, h = v2_inputs
        bias = bias.copy()
        bias[:, :, :, 0] = -1e9  # no query attends to key 0 ...
        bias[:, :, 0, 0] = 0.0  # ... except query 0, so every row keeps a key
        want = np.asarray(jax_window_v2(jnp.asarray(qkv), jnp.asarray(bias), h, 0.7, True))
        got = wa.window_attention_fused_v2(torch.tensor(qkv), torch.tensor(bias), h, 0.7)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    def test_bias_shape_checked(self, v2_inputs):
        qkv, bias, h = v2_inputs
        with pytest.raises(ValueError, match="bias must be"):
            wa.window_attention_fused_v2(torch.tensor(qkv), torch.tensor(bias[:1]), h, 0.7)


class TestSelfAttention:
    @pytest.mark.parametrize("batch", [4, 3])
    def test_plain_matches_pallas(self, rng, batch):
        h, n, d = 2, 16, 8
        q, k = (rng.normal(size=(batch, n, h * d)).astype(np.float32) * 0.3 for _ in range(2))
        v = rng.normal(size=(batch, n, h * d)).astype(np.float32)
        scale = d ** -0.5
        want = np.asarray(jax_self_attention(*map(jnp.asarray, (q, k, v)), h, scale, True))
        got = wa.self_attention_fused(*map(torch.tensor, (q, k, v)), h, scale)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    def test_bf16_keeps_dtype(self, rng):
        q = torch.tensor(rng.normal(size=(2, 16, 16)).astype(np.float32)).bfloat16()
        out = wa.self_attention_fused(q, q, q, 2, 0.25)
        assert out.dtype == torch.bfloat16

    def test_cpu_path_counts_no_launch(self, rng):
        wa.reset_launch_counts()
        q = torch.tensor(rng.normal(size=(2, 16, 16)).astype(np.float32), requires_grad=True)
        wa.self_attention_fused(q, q, q, 2, 0.25).sum().backward()
        assert set(wa.LAUNCHES) == {wa.SELF_ATTENTION, wa.WINDOW_ATTENTION_V2,
                                    wa.SELF_ATTENTION_BWD, wa.WINDOW_ATTENTION_V2_BWD}
        assert all(count == 0 for count in wa.LAUNCHES.values())

    def test_other_devices_raise(self):
        q = torch.empty((2, 16, 16), device="meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            wa.self_attention_fused(q, q, q, 2, 0.25)


# ---------------------------------------------------------------------------
# Backward: the plain versions against jax.vjp of the Pallas kernels and
# against torch autograd of the plain forwards.
# ---------------------------------------------------------------------------

GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


def _requires_grad(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


class TestSelfAttentionBackward:
    @pytest.fixture
    def case(self, rng):
        b, n, h, d = 3, 16, 2, 8
        q, k = (rng.normal(size=(b, n, h * d)).astype(np.float32) * 0.3 for _ in range(2))
        v, do = (rng.normal(size=(b, n, h * d)).astype(np.float32) for _ in range(2))
        return q, k, v, do, h, d ** -0.5

    def test_plain_bwd_matches_pallas_vjp(self, case):
        q, k, v, do, h, scale = case
        _, vjp = jax.vjp(lambda a, b_, c: jax_self_attention(a, b_, c, h, scale, True), q, k, v)
        want = vjp(jnp.asarray(do))
        got = wa.self_attention_bwd_reference(*map(torch.tensor, (q, k, v, do)), h, scale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)

    def test_plain_bwd_matches_autograd_of_plain_fwd(self, case):
        q, k, v, do, h, scale = case
        tq, tk, tv = _requires_grad(q, k, v)
        wa.self_attention_reference(tq, tk, tv, h, scale).backward(torch.tensor(do))
        got = wa.self_attention_bwd_reference(*map(torch.tensor, (q, k, v, do)), h, scale)
        for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)

    def test_wrapper_gradient_is_the_plain_bwd(self, case):
        q, k, v, do, h, scale = case
        tq, tk, tv = _requires_grad(q, k, v)
        wa.self_attention_fused(tq, tk, tv, h, scale).backward(torch.tensor(do))
        want = wa.self_attention_bwd_reference(*map(torch.tensor, (q, k, v, do)), h, scale)
        for g, w in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


class TestWindowAttentionV2Backward:
    @pytest.fixture
    def case(self, v2_inputs, rng):
        qkv, bias, h = v2_inputs
        bias = bias.copy()
        bias[:, :, :, 1::3] = -1e9  # masked keys, as the Swin shift mask makes them
        do = rng.normal(size=(*qkv.shape[:3], qkv.shape[3] // 3)).astype(np.float32)
        return qkv, bias, do, h, 0.7

    def test_plain_bwd_matches_pallas_vjp(self, case):
        qkv, bias, do, h, scale = case
        _, vjp = jax.vjp(lambda a, b_: jax_window_v2(a, b_, h, scale, True), qkv, bias)
        want_dqkv, want_dbias = vjp(jnp.asarray(do))
        dqkv, dbias = wa.window_attention_v2_bwd_reference(*map(torch.tensor, (qkv, bias, do)), h, scale)
        np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_dqkv), **GRAD_TOL)
        np.testing.assert_allclose(dbias.numpy(), np.asarray(want_dbias), **GRAD_TOL)
        assert dbias.dtype == torch.float32

    def test_plain_bwd_matches_autograd_of_plain_fwd(self, case):
        qkv, bias, do, h, scale = case
        tqkv, tbias = _requires_grad(qkv, bias)
        wa.window_attention_v2_reference(tqkv, tbias, h, scale).backward(torch.tensor(do))
        dqkv, dbias = wa.window_attention_v2_bwd_reference(*map(torch.tensor, (qkv, bias, do)), h, scale)
        np.testing.assert_allclose(dqkv.numpy(), tqkv.grad.numpy(), **GRAD_TOL)
        np.testing.assert_allclose(dbias.numpy(), tbias.grad.numpy(), **GRAD_TOL)

    def test_wrapper_gradient_is_the_plain_bwd(self, case):
        qkv, bias, do, h, scale = case
        tqkv, tbias = _requires_grad(qkv, bias)
        wa.window_attention_fused_v2(tqkv, tbias, h, scale).backward(torch.tensor(do))
        dqkv, dbias = wa.window_attention_v2_bwd_reference(*map(torch.tensor, (qkv, bias, do)), h, scale)
        np.testing.assert_array_equal(tqkv.grad.numpy(), dqkv.numpy())
        np.testing.assert_array_equal(tbias.grad.numpy(), dbias.numpy())

    def test_bf16_backward_keeps_dtypes(self, case):
        qkv, bias, do, h, scale = case
        tqkv = torch.tensor(qkv).bfloat16().requires_grad_()
        tbias = torch.tensor(bias, requires_grad=True)
        wa.window_attention_fused_v2(tqkv, tbias, h, scale).backward(torch.tensor(do).bfloat16())
        assert tqkv.grad.dtype == torch.bfloat16 and tbias.grad.dtype == torch.float32
