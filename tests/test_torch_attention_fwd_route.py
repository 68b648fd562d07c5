"""The attention forward's route choice and its wgmma arithmetic, on the CPU.

``attention_fwd_route`` mirrors the choice the C entry points make before a
launch (``csrc/attention_fwd.cuh``, ``attention_fwd_route_wgmma``): bf16
with head_dim % 16 == 0 and N <= 224 takes TMA and ``wgmma`` ("wgmma"),
everything else the CUDA cores ("fma"); the backward takes the same calls
to its own "wgmma" route.  ``tests/test_torch_cuda.py`` holds the
Python mirror to the C one on a card, and there tests the 4-D tensor maps
the wgmma route reads q, k and v through (``edrl_attention_fwd_map_plan``).

The wgmma kernel holds a head's keys whole: s = q k^T over all of them,
scale and bias in f32, -inf past N, the whole row's max, p = 2^(x log2 e -
m log2 e) summed in f32 into l, p rounded to bf16 before the value product,
and o / l at the end.  ``_kernel_attention`` below repeats that order of
operations in torch; it is held to the Pallas kernels run with
``interpret=True`` (which keep p in f32) on bf16 inputs with -1e9 bias
entries, at the bf16 forward bar of atol 3e-2.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels.window_attention import self_attention_fused as jax_self_attention
from edrl_tpu.kernels.window_attention import window_attention_fused_v2 as jax_window_v2
from edrl_tpu_torch.kernels import window_attention as wa

BF16, F32 = torch.bfloat16, torch.float32
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("dtype,n,d,route", [
    # Main-path shapes: B1 (ViT-3D, N = 216), B2 (Swin, N = 144), B2 and B6
    # under the fused attention sublayer (N = 216), all head_dim 128.
    (BF16, 216, 128, "wgmma"),
    (BF16, 144, 128, "wgmma"),
    # The f32 paths take the CUDA cores at the same shapes.
    (F32, 216, 128, "fma"),
    (F32, 144, 128, "fma"),
    # Edges: wgmma takes N <= 224 and head_dim % 16 == 0.
    (BF16, 224, 128, "wgmma"),
    (BF16, 225, 128, "fma"),
    (BF16, 240, 128, "fma"),
    (BF16, 1, 128, "wgmma"),
    (BF16, 17, 32, "wgmma"),
    (BF16, 145, 128, "wgmma"),
    (BF16, 16, 16, "wgmma"),
    # The kernel's key counts (64, 144, 224) change at N = 65 and 145; two
    # query tiles from N = 65 to 128, three to 192.
    (BF16, 64, 128, "wgmma"),
    (BF16, 65, 128, "wgmma"),
    (BF16, 128, 128, "wgmma"),
    (BF16, 129, 128, "wgmma"),
    (BF16, 192, 128, "wgmma"),
    # Head dims under 128 (the maps' zero fill past D), and one that is not
    # a multiple of 16.
    (BF16, 100, 64, "wgmma"),
    (BF16, 100, 96, "wgmma"),
    (BF16, 100, 40, "fma"),
    (BF16, 16, 8, "fma"),
    (BF16, 40, 24, "fma"),
    (F32, 16, 16, "fma"),
])
def test_route_at_main_path_shapes_and_edges(dtype, n, d, route):
    assert wa.attention_fwd_route(dtype, n, d) == route


def test_forward_and_backward_take_the_same_route():
    """Every call the forward sends to wgmma the backward sends to wgmma,
    and every other call both send to the CUDA cores (fma)."""
    for dtype in (BF16, F32):
        for n in range(1, wa.MAX_BWD_TOKENS + 1):
            for d in (8, 16, 24, 32, 64, 96, 128):
                assert wa.attention_fwd_route(dtype, n, d) == wa.attention_bwd_route(dtype, n, d)


def test_route_counts_reset_with_the_launch_counts():
    wa.FWD_ROUTES["wgmma"] = 5
    wa.FWD_ROUTES["fma"] = 2
    wa.reset_launch_counts()
    assert wa.FWD_ROUTES == {"wgmma": 0, "fma": 0}


def test_cpu_forward_counts_no_route(rng):
    """A CPU tensor takes the plain forward: no launch, no route counted."""
    wa.reset_launch_counts()
    q = torch.tensor(rng.normal(size=(2, 16, 32)), dtype=BF16)
    wa.self_attention_fused(q, q, q, 2, 0.25)
    qkv = torch.tensor(rng.normal(size=(2, 2, 16, 96)), dtype=BF16)
    wa.window_attention_fused_v2(qkv, torch.zeros((2, 2, 16, 16)), 2, 0.25)
    wa.window_attention_fused(*(torch.tensor(rng.normal(size=(2, 2, 2, 16, 16)), dtype=BF16) for _ in range(3)),
                              torch.zeros((2, 2, 16, 16)))
    assert wa.FWD_ROUTES == {"wgmma": 0, "fma": 0}
    assert set(wa.LAUNCHES.values()) == {0}


def _kernel_attention(q, k, v, bias, scale):
    """The wgmma kernel's order of operations for f32 ``[G, N, D]`` operands
    holding bf16 values and an f32 ``[G, N, N]`` bias (or None); returns
    bf16 ``[G, N, D]``.

    The kernel pads the keys to 64, 144 or 224 with zero rows (TMA's
    out-of-bounds fill) and sets their scores to -inf, so their p is 0 and
    they add nothing to l or o: the sums below run over the N keys alone."""
    x = (q @ k.transpose(1, 2)) * scale
    if bias is not None:
        x = x + bias
    m = x.amax(dim=-1, keepdim=True)
    p = torch.exp2(x * LOG2E - m * LOG2E)
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(BF16).float() @ v
    return (o * (1.0 / l)).to(BF16)


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
    got = _kernel_attention(_heads(q, heads), _heads(k, heads), _heads(v, heads), None, scale)
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
    got = _kernel_attention(q, k, v, full_bias, scale)
    got = got.float().reshape(b, w, heads, n, c // heads).transpose(2, 3).reshape(b, w, n, c)
    want = jax_window_v2(jnp.asarray(qkv.float().numpy(), dtype=jnp.bfloat16), jnp.asarray(bias), heads, scale,
                         True)
    assert np.abs(got.numpy() - np.asarray(want, np.float32)).max() <= 3e-2


@pytest.mark.parametrize("n", [144, 216, 1, 17, 224, 64, 65, 100, 128, 129])
def test_kernel_order_matches_pallas_at_main_path_widths_and_edges(rng, n):
    """head_dim 128 at the main path's N (144: Swin windows; 216: the ViT),
    the route's edges (N = 1, 17 and 224) and the kernel's (its keys change
    at N = 65 and 145; two query tiles to N = 128): B1 with one batch entry
    of two heads, and B2 with two windows of one head and -1e9 bias
    entries."""
    c, heads = 256, 2
    q, k, v = (_bf16(rng, (1, n, c)) for _ in range(3))
    scale = 128 ** -0.5
    got = _kernel_attention(_heads(q, heads), _heads(k, heads), _heads(v, heads), None, scale)
    got = got.float().reshape(1, heads, n, 128).transpose(1, 2).reshape(1, n, c)
    want = jax_self_attention(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v)),
                              heads, scale, True)
    assert np.abs(got.numpy() - np.asarray(want, np.float32)).max() <= 3e-2

    w, c = 2, 128
    qkv = _bf16(rng, (1, w, n, 3 * c))
    bias = rng.normal(size=(w, 1, n, n)).astype(np.float32)
    bias[..., 1::3] = -1e9
    bias[..., 0] = 0.0
    x = qkv.float().reshape(w, n, 3, 1, c)
    q2, k2, v2 = (x[:, :, i].transpose(1, 2).reshape(w, n, c) for i in range(3))
    got = _kernel_attention(q2, k2, v2, torch.tensor(bias).reshape(w, n, n), scale)
    want = jax_window_v2(jnp.asarray(qkv.float().numpy(), dtype=jnp.bfloat16), jnp.asarray(bias), 1, scale, True)
    assert np.abs(got.float().reshape(1, w, n, c).numpy() - np.asarray(want, np.float32)).max() <= 3e-2


@pytest.mark.parametrize("d", [16, 32, 64, 96])
def test_kernel_order_matches_pallas_at_smaller_head_dims(rng, d):
    """Head dims under 128 at N = 100 (two query tiles, 144 keys held): B1
    with two batch entries of two heads, B2 with two windows of two heads
    and -1e9 bias entries."""
    n, heads = 100, 2
    c = heads * d
    q, k, v = (_bf16(rng, (2, n, c)) for _ in range(3))
    scale = d ** -0.5
    got = _kernel_attention(_heads(q, heads), _heads(k, heads), _heads(v, heads), None, scale)
    got = got.float().reshape(2, heads, n, d).transpose(1, 2).reshape(2, n, c)
    want = jax_self_attention(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v)),
                              heads, scale, True)
    assert np.abs(got.numpy() - np.asarray(want, np.float32)).max() <= 3e-2

    w = 2
    qkv = _bf16(rng, (1, w, n, 3 * c))
    bias = rng.normal(size=(w, heads, n, n)).astype(np.float32)
    bias[..., 1::3] = -1e9
    bias[..., 0] = 0.0
    x = qkv.float().reshape(w, n, 3, heads, d)
    q2, k2, v2 = (x[:, :, i].transpose(1, 2).reshape(w * heads, n, d) for i in range(3))
    got = _kernel_attention(q2, k2, v2, torch.tensor(bias).reshape(w * heads, n, n), scale)
    got = got.float().reshape(1, w, heads, n, d).transpose(2, 3).reshape(1, w, n, c)
    want = jax_window_v2(jnp.asarray(qkv.float().numpy(), dtype=jnp.bfloat16), jnp.asarray(bias), heads, scale,
                         True)
    assert np.abs(got.numpy() - np.asarray(want, np.float32)).max() <= 3e-2
