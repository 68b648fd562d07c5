"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``; every test skips on a machine without a card.  The file
imports no JAX, so it also runs on a card machine that has none:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Shapes: the main-path ones, plus odd ones that take the CUDA-core kernel in
bf16 (head_dim 8, N above 224).  Tolerances: forwards bf16 atol 3e-2, f32
atol 1e-4.  Backwards, relative to the largest magnitude of the plain
version's result (gradients scale with their inputs): 1e-2 for bf16
results (one bf16 rounding is 2^-8), 1e-4 for f32 results, dbias included.
MK-MMD: rtol 1e-4 (``tests/test_kernels.py``'s bar).
"""

import pytest
import torch

from edrl_tpu_torch.kernels import mmd as kmmd
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.ops.mmd import mk_mmd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "b,n,c,heads", [(16, 216, 768, 6), (3, 16, 32, 2), (2, 70, 64, 1), (2, 40, 16, 2), (2, 240, 128, 1)]
)
def test_self_attention_kernel_matches_plain(cuda, dtype, atol, b, n, c, heads):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, n, c), generator=gen, device=cuda).to(dtype) for _ in range(3))
    scale = (c // heads) ** -0.5
    with torch.no_grad():
        got = wa.self_attention_fused(q, k, v, heads, scale)
        want = wa.self_attention_reference(q, k, v, heads, scale)
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,w,n,c,heads", [(16, 64, 144, 128, 1), (16, 1, 144, 1024, 8), (3, 2, 16, 32, 2)])
def test_window_attention_kernel_matches_plain(cuda, dtype, atol, b, w, n, c, heads):
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((b, w, n, 3 * c), generator=gen, device=cuda).to(dtype)
    bias = torch.randn((w, heads, n, n), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    scale = (c // heads) ** -0.5
    with torch.no_grad():
        got = wa.window_attention_fused_v2(qkv, bias, heads, scale)
        want = wa.window_attention_v2_reference(qkv, bias, heads, scale)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_kernel_refuses_grad(cuda):
    """A gradient the backward kernel cannot take is refused at the forward."""
    q = torch.randn((2, 264, 16), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="at most 256 tokens"):
        wa.self_attention_fused(q, q, q, 2, 0.25)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def _bwd_bar(dtype):
    return 1e-2 if dtype == torch.bfloat16 else 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,n,c,heads", [(32, 216, 768, 6), (3, 16, 32, 2), (2, 70, 64, 1), (2, 40, 16, 2), (2, 240, 128, 1)]
)
def test_self_attention_bwd_kernel_matches_plain(cuda, dtype, b, n, c, heads):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn((b, n, c), generator=gen, device=cuda).to(dtype) for _ in range(4))
    scale = (c // heads) ** -0.5
    got = wa.self_attention_bwd_kernel(q, k, v, do, heads, scale)
    want = wa.self_attention_bwd_reference(q, k, v, do, heads, scale)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert _rel_err(g, w) <= _bwd_bar(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,w,n,c,heads", [(32, 64, 144, 128, 1), (32, 1, 144, 1024, 8), (3, 2, 16, 32, 2), (2, 1, 240, 48, 2)]
)
def test_window_attention_bwd_kernel_matches_plain(cuda, dtype, b, w, n, c, heads):
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn((b, w, n, 3 * c), generator=gen, device=cuda).to(dtype)
    do = torch.randn((b, w, n, c), generator=gen, device=cuda).to(dtype)
    bias = torch.randn((w, heads, n, n), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    scale = (c // heads) ** -0.5
    dqkv, dbias = wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, scale)
    want_dqkv, want_dbias = wa.window_attention_v2_bwd_reference(qkv, bias, do, heads, scale)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    assert _rel_err(dqkv, want_dqkv) <= _bwd_bar(dtype)
    assert _rel_err(dbias, want_dbias) <= 1e-4
    again = wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, scale)[1]
    assert torch.equal(again, dbias)  # a fixed summation order


@pytest.mark.cuda
def test_autograd_reaches_the_backward_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, 40, 64), generator=gen, device=cuda, requires_grad=True) for _ in range(3))
    qkv = torch.randn((2, 4, 16, 96), generator=gen, device=cuda, requires_grad=True)
    bias = torch.randn((4, 2, 16, 16), generator=gen, device=cuda, requires_grad=True)
    wa.reset_launch_counts()
    (wa.self_attention_fused(q, k, v, 2, 0.3).sum() + wa.window_attention_fused_v2(qkv, bias, 2, 0.3).sum()).backward()
    assert wa.LAUNCHES == {name: 1 for name in wa.LAUNCHES}
    q2, k2, v2, qkv2, bias2 = (t.detach().clone().requires_grad_() for t in (q, k, v, qkv, bias))
    (wa.self_attention_reference(q2, k2, v2, 2, 0.3).sum()
     + wa.window_attention_v2_reference(qkv2, bias2, 2, 0.3).sum()).backward()
    for got, want in ((q, q2), (k, k2), (v, v2), (qkv, qkv2), (bias, bias2)):
        assert _rel_err(got.grad, want.grad) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n_s,n_t,d", [(32, 32, 3072), (3, 5, 7), (16, 16, 200), (70, 70, 129)])
def test_mmd_kernel_matches_plain(cuda, n_s, n_t, d):
    gen = torch.Generator(device=cuda).manual_seed(4)
    src = torch.randn((n_s, d), generator=gen, device=cuda)
    tgt = torch.randn((n_t, d), generator=gen, device=cuda) * 1.1 + 0.05
    kmmd.reset_launch_counts()
    got = kmmd.mk_mmd_kernel(src, tgt)
    want = mk_mmd(src, tgt)
    assert kmmd.LAUNCHES[kmmd.MK_MMD] == 1
    assert abs(got.item() - want.item()) <= 1e-4 * abs(want.item()) + 1e-7


@pytest.mark.cuda
def test_mmd_fused_grad_is_the_plain_paths(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    src = torch.randn((8, 64), generator=gen, device=cuda, requires_grad=True)
    tgt = torch.randn((8, 64), generator=gen, device=cuda, requires_grad=True)
    kmmd.mk_mmd_fused(src, tgt).backward()
    s2, t2 = src.detach().clone().requires_grad_(), tgt.detach().clone().requires_grad_()
    mk_mmd(s2, t2).backward()
    assert torch.allclose(src.grad, s2.grad, rtol=1e-4, atol=1e-7)
    assert torch.allclose(tgt.grad, t2.grad, rtol=1e-4, atol=1e-7)
