"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``; every test skips on a machine without a card.  The file
imports no JAX, so it also runs on a card machine that has none:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Shapes: the main-path ones, plus odd ones that take the CUDA-core kernel in
bf16 (head_dim 8, N above 224).  Tolerances: bf16 atol 3e-2, f32 atol 1e-4.
"""

import pytest
import torch

from edrl_tpu_torch.kernels import window_attention as wa


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
    q = torch.randn((2, 16, 16), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="A6"):
        wa.self_attention_fused(q, q, q, 2, 0.25)
