"""Port's attention wrappers against the JAX Pallas kernels (interpret mode).

On a CPU tensor each wrapper takes its plain PyTorch version, which is held
to the Pallas kernel run with ``interpret=True`` at the shapes of
``tests/test_window_attention.py`` (f32, atol 1e-5).  The CUDA kernels
themselves run only on a card: ``tests/test_torch_cuda.py`` compares them
with the plain versions there.
"""

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
        q = torch.tensor(rng.normal(size=(2, 16, 16)).astype(np.float32))
        wa.self_attention_fused(q, q, q, 2, 0.25)
        assert wa.LAUNCHES == {wa.SELF_ATTENTION: 0, wa.WINDOW_ATTENTION_V2: 0}

    def test_other_devices_raise(self):
        q = torch.empty((2, 16, 16), device="meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            wa.self_attention_fused(q, q, q, 2, 0.25)
