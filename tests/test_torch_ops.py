"""Port's ops and small helpers against the JAX package, on the CPU in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels import layer_norm as jlayer_norm
from edrl_tpu.kernels.mmd_pallas import mk_mmd_pallas
from edrl_tpu.ops import correlation as jcorrelation
from edrl_tpu.ops import distributions as jdistributions
from edrl_tpu.ops import losses as jlosses
from edrl_tpu.ops import mmd as jmmd
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch.kernels import layer_norm
from edrl_tpu_torch.kernels import mmd as kmmd
from edrl_tpu_torch.ops import correlation, distributions, losses, mmd
from edrl_tpu_torch.train import trainer


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("num_classes,smoothing", [(2, 0.1), (5, 0.2), (3, 0.0)])
def test_label_smoothing_cross_entropy(rng, num_classes, smoothing):
    logits = rng.normal(size=(6, num_classes)).astype(np.float32) * 3
    labels = rng.integers(0, num_classes, size=(6,))
    want = jlosses.label_smoothing_cross_entropy(logits, labels, smoothing)
    got = losses.label_smoothing_cross_entropy(_t(logits), _t(labels), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_kl_to_standard_normal(rng):
    mu = rng.normal(size=(4, 2, 16)).astype(np.float32)
    sigma = rng.uniform(0.0, 2.0, size=(4, 2, 16)).astype(np.float32)
    sigma[0, 0, :3] = 0.0  # exercises the 1e-8 log clamp
    want = jdistributions.kl_to_standard_normal(mu, sigma, axis=1)
    got = distributions.kl_to_standard_normal(_t(mu), _t(sigma), axis=1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_entropy_regularization(rng):
    x = rng.uniform(size=(5, 3)).astype(np.float32)
    want = jdistributions.entropy_regularization(x)
    np.testing.assert_allclose(float(distributions.entropy_regularization(_t(x))), float(want), rtol=1e-5)


class TestCorrelation:
    def test_cross_correlation_and_off_diagonal(self, rng):
        z1, z2 = (rng.normal(size=(6, 8)).astype(np.float32) for _ in range(2))
        want = jcorrelation.cross_correlation(z1, z2, 24.0)
        got = correlation.cross_correlation(_t(z1), _t(z2), 24.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(
            float(correlation.off_diagonal_sum_sq(got)),
            float(jcorrelation.off_diagonal_sum_sq(want)), rtol=1e-5,
        )

    @pytest.mark.parametrize("common_dim", [4, 2])
    def test_barlow_block_loss(self, rng, common_dim):
        z1, z2 = (rng.normal(size=(6, 8)).astype(np.float32) for _ in range(2))
        want = jcorrelation.barlow_block_loss(z1, z2, common_dim, 24.0, 0.0051)
        got = correlation.barlow_block_loss(_t(z1), _t(z2), common_dim, 24.0, 0.0051)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_reference(rng, dtype):
    x = (rng.normal(size=(5, 64)) * 3 + 2).astype(np.float32)
    gamma, beta = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlayer_norm.layer_norm_reference(jnp.asarray(x, jdtype), gamma, beta)
    got = layer_norm.layer_norm_reference(_t(x).to(dtype), _t(gamma), _t(beta))
    assert got.dtype == dtype
    atol = 1e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def test_dequantize(rng):
    x = rng.integers(0, 256, size=(2, 8), dtype=np.uint8)
    want = jtrainer._dequantize(jnp.asarray(x))
    got = trainer._dequantize(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    f = _t(x.astype(np.float32))
    assert trainer._dequantize(f) is f


def test_normalize_output():
    assert trainer._normalize_output((1, 2, 3)) == (1, 2, 3, {})
    assert trainer._normalize_output((1, 2, 3, {"a": 4})) == (1, 2, 3, {"a": 4})


# ---------------------------------------------------------------------------
# MK-MMD (plain path and B3's CPU path) and the JS divergence, values and
# gradients at rtol 1e-4 / atol 1e-6 (``tests/test_kernels.py``'s bar).
# ---------------------------------------------------------------------------

MMD_TOL = dict(rtol=1e-4, atol=1e-6)


def _features(rng, n_s=8, n_t=8, d=128):
    src = rng.normal(size=(n_s, d)).astype(np.float32)
    tgt = (rng.normal(size=(n_t, d)) * 1.2 + 0.1).astype(np.float32)
    return src, tgt


@pytest.mark.parametrize("mul,num", [(2.0, 5), (1.5, 3)])
def test_gaussian_kernel(rng, mul, num):
    src, tgt = _features(rng)
    want = jmmd.gaussian_kernel(src, tgt, mul, num)
    np.testing.assert_allclose(mmd.gaussian_kernel(_t(src), _t(tgt), mul, num).numpy(), np.asarray(want),
                               **MMD_TOL)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape", [(8, 8, 128), (3, 5, 7)])
def test_mk_mmd_value_and_grad(rng, fused, shape):
    """ops.mmd.mk_mmd against the JAX XLA path; kernels.mmd.mk_mmd_fused (its
    CPU path) against mk_mmd_pallas in interpret mode (which sends the odd
    shape to the XLA path)."""
    src, tgt = _features(rng, *shape)
    if fused:
        jfn = lambda a, b: mk_mmd_pallas(a, b, 2.0, 5, True)  # noqa: E731
        tfn = kmmd.mk_mmd_fused
    else:
        jfn, tfn = jmmd.mk_mmd, mmd.mk_mmd
    want, (wsrc, wtgt) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(src), jnp.asarray(tgt))
    tsrc, ttgt = (torch.tensor(a, requires_grad=True) for a in (src, tgt))
    got = tfn(tsrc, ttgt)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), **MMD_TOL)
    np.testing.assert_allclose(tsrc.grad.numpy(), np.asarray(wsrc), **MMD_TOL)
    np.testing.assert_allclose(ttgt.grad.numpy(), np.asarray(wtgt), **MMD_TOL)


def test_mk_mmd_fused_cpu_counts_no_launch(rng):
    kmmd.reset_launch_counts()
    src, tgt = _features(rng)
    kmmd.mk_mmd_fused(_t(src), _t(tgt))
    assert kmmd.LAUNCHES == {kmmd.MK_MMD: 0, kmmd.MK_MMD_BWD: 0}


def test_mk_mmd_kernel_needs_cuda(rng):
    src, tgt = _features(rng)
    with pytest.raises(ValueError, match="CUDA"):
        kmmd.mk_mmd_kernel(_t(src), _t(tgt))


def test_js_divergence(rng):
    p = rng.dirichlet(np.ones(3), size=5).astype(np.float32)
    q = rng.dirichlet(np.ones(3), size=5).astype(np.float32)
    q[0, 1] = 0.0  # exercises the 1e-12 log clamp
    np.testing.assert_allclose(float(distributions.js_divergence(_t(p), _t(q))),
                               float(jdistributions.js_divergence(p, q)), rtol=1e-5)
    np.testing.assert_allclose(float(distributions.kl_divergence_categorical(_t(p), _t(q))),
                               float(jdistributions.kl_divergence_categorical(p, q)), rtol=1e-5)
