"""B3's backward in closed form (``ops.mmd.mk_mmd_bwd_reference``, the CPU
path of ``kernels.mmd.mk_mmd_fused`` and the plain version the CUDA
backward kernel is held against) against JAX: ``jax.vjp`` of
``edrl_tpu.ops.mmd.mk_mmd`` (the XLA path) and of ``mk_mmd_pallas`` in
interpret mode (whose VJP is the XLA path's, its forward the Pallas
kernel's where the shape is aligned).  f32, 1e-5 of the largest gradient
magnitude; ties (duplicate rows: an exact-0 distance off the diagonal) as
JAX takes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels.mmd_pallas import mk_mmd_pallas
from edrl_tpu.ops import mmd as jmmd
from edrl_tpu_torch.kernels import mmd as kmmd
from edrl_tpu_torch.ops import mmd

BAR = 1e-5
SHAPES = [(4, 4, 128), (3, 5, 128), (4, 4, 37), (6, 2, 200)]
PARAMS = [(2.0, 5), (2.0, 1), (1.5, 3)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _features(rng, n_s, n_t, d, duplicate):
    src = rng.normal(size=(n_s, d)).astype(np.float32)
    tgt = (rng.normal(size=(n_t, d)) * 1.1 + 0.05).astype(np.float32)
    if duplicate:
        tgt[1] = src[0]  # an exact-0 distance off the diagonal
        src[2] = src[1]
    return src, tgt


def _rel(got, want, scale):
    return float(np.abs(np.asarray(got, dtype=np.float64) - np.asarray(want, dtype=np.float64)).max() / scale)


def _hold(got, want):
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for g, w in zip(got, want):
        assert _rel(g, w, scale) <= BAR


@pytest.mark.parametrize("mul,num", PARAMS)
@pytest.mark.parametrize("duplicate", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_fn", ["xla", "pallas"])
def test_closed_form_matches_jax_vjp(rng, shape, duplicate, mul, num, jax_fn):
    src, tgt = _features(rng, *shape, duplicate)
    if jax_fn == "xla":
        fn = lambda a, b: jmmd.mk_mmd(a, b, mul, num)  # noqa: E731
    else:
        fn = lambda a, b: mk_mmd_pallas(a, b, mul, num, True)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(src), jnp.asarray(tgt))
    want = vjp(jnp.float32(0.75))
    got = mmd.mk_mmd_bwd_reference(torch.tensor(src), torch.tensor(tgt), torch.tensor(0.75), mul, num)
    assert all(g.dtype == torch.float32 for g in got)
    _hold([g.numpy() for g in got], want)


@pytest.mark.parametrize("mul,num", PARAMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_cpu_path_matches_autograd_of_the_plain_mmd(rng, shape, mul, num):
    src, tgt = _features(rng, *shape, duplicate=False)
    leaves = [torch.tensor(a, requires_grad=True) for a in (src, tgt)]
    kmmd.mk_mmd_fused(*leaves, mul, num).backward(torch.tensor(1.3))
    plain = [torch.tensor(a, requires_grad=True) for a in (src, tgt)]
    mmd.mk_mmd(*plain, mul, num).backward(torch.tensor(1.3))
    _hold([t.grad.numpy() for t in leaves], [t.grad.numpy() for t in plain])


def test_fused_cpu_path_keeps_the_input_dtype(rng):
    src, tgt = _features(rng, 4, 4, 64, duplicate=False)
    leaves = [torch.tensor(a).bfloat16().requires_grad_() for a in (src, tgt)]
    value = kmmd.mk_mmd_fused(*leaves)
    value.backward()
    assert value.dtype == torch.float32
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)


@pytest.mark.parametrize("n,route", [(2, "cluster"), (64, "cluster"), (65, "split"), (140, "split")])
def test_forward_route_mirror(n, route):
    assert kmmd.mk_mmd_route(n) == route


def test_backward_kernel_needs_cuda(rng):
    src, tgt = (torch.tensor(a) for a in _features(rng, 4, 4, 8, duplicate=False))
    with pytest.raises(ValueError, match="CUDA"):
        kmmd.mk_mmd_bwd_kernel(src, tgt, torch.zeros(66), torch.tensor(1.0))
