"""The attention forward's route choice and its tensor-core arithmetic, on the CPU.

``attention_fwd_route`` mirrors the choice the C entry points make before a
launch (``csrc/attention_fwd.cuh``, ``attention_fwd_route_mma``): bf16 with
head_dim % 16 == 0 and N <= 224 takes the tensor cores ("mma"), everything
else the CUDA cores ("fma"), the backward's choice.
``tests/test_torch_cuda.py`` holds the Python choice to the C one on a card.

The tensor-core kernel walks the keys in chunks of 16 with an online
softmax (a running f32 row max and sum, the output rescaled when the max
rises, p = 2^(x log2 e - m log2 e)) and rounds p to bf16 before the value
product.  ``_chunked_attention`` below repeats that order of operations in
torch; it is held to the Pallas kernels run with ``interpret=True`` (which
keep p in f32 and take the softmax over the whole row) on bf16 inputs with
-1e9 bias entries, at the bf16 forward bar of atol 3e-2.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels.window_attention import self_attention_fused as jax_self_attention
from edrl_tpu.kernels.window_attention import window_attention_fused_v2 as jax_window_v2
from edrl_tpu_torch.kernels import window_attention as wa

BF16, F32 = torch.bfloat16, torch.float32
CHUNK = 16  # kFwdChunk in csrc/attention_fwd.cuh
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("dtype,n,d,route", [
    # Main-path shapes: B1 (ViT-3D, N = 216), B2 (Swin, N = 144), B2 and B6
    # under the fused attention sublayer (N = 216), all head_dim 128.
    (BF16, 216, 128, "mma"),
    (BF16, 144, 128, "mma"),
    # The f32 paths take the CUDA cores at the same shapes.
    (F32, 216, 128, "fma"),
    (F32, 144, 128, "fma"),
    # Edges: the tensor cores take N <= 224 and head_dim % 16 == 0.
    (BF16, 224, 128, "mma"),
    (BF16, 225, 128, "fma"),
    (BF16, 240, 128, "fma"),
    (BF16, 1, 128, "mma"),
    (BF16, 17, 32, "mma"),
    (BF16, 145, 128, "mma"),
    (BF16, 16, 16, "mma"),
    (BF16, 16, 8, "fma"),
    (BF16, 40, 24, "fma"),
    (F32, 16, 16, "fma"),
])
def test_route_at_main_path_shapes_and_edges(dtype, n, d, route):
    assert wa.attention_fwd_route(dtype, n, d) == route


def test_forward_and_backward_take_the_same_route():
    """The backward's tensor-core route takes the calls the forward's takes."""
    for dtype in (BF16, F32):
        for n in range(1, wa.MAX_BWD_TOKENS + 1):
            for d in (8, 16, 24, 32, 64, 96, 128):
                assert wa.attention_fwd_route(dtype, n, d) == wa.attention_bwd_route(dtype, n, d)


def test_route_counts_reset_with_the_launch_counts():
    wa.FWD_ROUTES["mma"] = 5
    wa.FWD_ROUTES["fma"] = 2
    wa.reset_launch_counts()
    assert wa.FWD_ROUTES == {"mma": 0, "fma": 0}


def test_cpu_forward_counts_no_route(rng):
    """A CPU tensor takes the plain forward: no launch, no route counted."""
    wa.reset_launch_counts()
    q = torch.tensor(rng.normal(size=(2, 16, 32)), dtype=BF16)
    wa.self_attention_fused(q, q, q, 2, 0.25)
    qkv = torch.tensor(rng.normal(size=(2, 2, 16, 96)), dtype=BF16)
    wa.window_attention_fused_v2(qkv, torch.zeros((2, 2, 16, 16)), 2, 0.25)
    wa.window_attention_fused(*(torch.tensor(rng.normal(size=(2, 2, 2, 16, 16)), dtype=BF16) for _ in range(3)),
                              torch.zeros((2, 2, 16, 16)))
    assert wa.FWD_ROUTES == {"mma": 0, "fma": 0}
    assert set(wa.LAUNCHES.values()) == {0}


def _chunked_attention(q, k, v, bias, scale):
    """The tensor-core kernel's order of operations for f32 ``[G, N, D]``
    operands holding bf16 values and an f32 ``[G, N, N]`` bias (or None);
    returns bf16 ``[G, N, D]``."""
    g, n, d = q.shape
    m = torch.full((g, n, 1), -math.inf)
    l = torch.zeros((g, n, 1))
    o = torch.zeros((g, n, d))
    for k0 in range(0, n, CHUNK):
        x = (q @ k[:, k0:k0 + CHUNK].transpose(1, 2)) * scale
        if bias is not None:
            x = x + bias[:, :, k0:k0 + CHUNK]
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        r = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(x * LOG2E - m_new * LOG2E)
        l = l * r + p.sum(dim=-1, keepdim=True)
        o = o * r + p.to(BF16).float() @ v[:, k0:k0 + CHUNK]
        m = m_new
    return (o / l).to(BF16)


def _bf16(rng, shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=F32).to(BF16)


def _heads(x, heads):
    """bf16 ``[B, N, H * D]`` -> f32 ``[B * H, N, D]``."""
    b, n, c = x.shape
    return x.float().reshape(b, n, heads, c // heads).transpose(1, 2).reshape(b * heads, n, c // heads)


@pytest.mark.parametrize("b,n,c,heads", [(2, 40, 64, 2), (3, 17, 32, 2), (1, 70, 16, 1), (2, 33, 128, 4)])
def test_chunked_order_matches_pallas_self_attention(rng, b, n, c, heads):
    q, k, v = (_bf16(rng, (b, n, c)) for _ in range(3))
    scale = (c // heads) ** -0.5
    got = _chunked_attention(_heads(q, heads), _heads(k, heads), _heads(v, heads), None, scale)
    got = got.float().reshape(b, heads, n, c // heads).transpose(1, 2).reshape(b, n, c)
    want = jax_self_attention(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v)),
                              heads, scale, True)
    assert np.abs(got.numpy() - np.asarray(want, np.float32)).max() <= 3e-2


@pytest.mark.parametrize("b,w,n,c,heads", [(2, 2, 36, 96, 2), (1, 3, 16, 48, 1), (2, 1, 65, 64, 2)])
def test_chunked_order_matches_pallas_window_attention(rng, b, w, n, c, heads):
    qkv = _bf16(rng, (b, w, n, 3 * c))
    bias = rng.normal(size=(w, heads, n, n)).astype(np.float32)
    bias[..., 1::3] = -1e9  # masked keys, as the Swin shift mask ...
    bias[..., 0] = 0.0  # ... with key 0 left to every row
    scale = (c // heads) ** -0.5
    x = qkv.float().reshape(b * w, n, 3, heads, c // heads)
    q, k, v = (x[:, :, i].transpose(1, 2).reshape(b * w * heads, n, c // heads) for i in range(3))
    full_bias = torch.tensor(bias)[None].expand(b, w, heads, n, n).reshape(b * w * heads, n, n)
    got = _chunked_attention(q, k, v, full_bias, scale)
    got = got.float().reshape(b, w, heads, n, c // heads).transpose(2, 3).reshape(b, w, n, c)
    want = jax_window_v2(jnp.asarray(qkv.float().numpy(), dtype=jnp.bfloat16), jnp.asarray(bias), heads, scale,
                         True)
    assert np.abs(got.numpy() - np.asarray(want, np.float32)).max() <= 3e-2
