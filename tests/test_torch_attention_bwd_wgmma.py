"""The wgmma attention backward's order of operations, on the CPU.

The wgmma route (``csrc/attention_bwd.cuh``) runs two kernels.  The rows
kernel holds a head's keys padded to 64, 160 or 224 and splits them over two
warpgroups; for each 64-row query tile it makes one pass over the row: x = s *
scale + bias in f32 (-inf past N), the row max over both halves, then e =
2^((x - m) log2 e), l = rowsum(e) and a = rowsum(e dp) as the sum of the two
halves' partials, delta = a / l, ds = e / l * (dp - delta) summed in f32 into
the chunk's dbias, and dq = ds k * scale with ds as bf16 hi + lo (each half's
product, the two added in f32).  The keys kernel recomputes p = 2^((x - m)
log2 e) / l and ds from those statistics and accumulates dv = bf16(p)^T do
and dk = (hi + lo)(ds)^T q * scale.  dbias is each batch chunk's sum in batch
order, then the chunks' partials summed as column_sum_kernel sums them (row
groups r, r + 8, ..., then the 8 groups in order).

``_kernel_bwd`` repeats that in torch and is held to the Pallas backward
kernels (``_sa_bwd`` and ``_v2_bwd`` through the JAX package's public
``custom_vjp``s, run with ``interpret=True``, which keep p and ds in f32):
dq, dk and dv within 1e-2 of their largest magnitude (the chip's bf16
backward bar), dbias within 1e-4 of its largest (the f32 bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.kernels.window_attention import self_attention_fused as jax_self_attention
from edrl_tpu.kernels.window_attention import window_attention_fused_v2 as jax_window_v2

BF16, F32 = torch.bfloat16, torch.float32
LOG2E = 1.4426950408889634
GRAD_BAR, DBIAS_BAR = 1e-2, 1e-4


def _keys_held(n):
    """The keys the rows kernel holds (attention_bwd_keys), two halves of a
    multiple of 16."""
    return 64 if n <= 64 else (160 if n <= 160 else 224)


def _split(x):
    """x as bf16 hi + lo: hi rounds x, lo rounds what hi leaves."""
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def _column_sum(parts):
    """column_sum_kernel's order over the chunks' partials ``[chunks, ...]``."""
    groups = [sum(parts[r::8].unbind(0), torch.zeros_like(parts[0])) if r < len(parts) else
              torch.zeros_like(parts[0]) for r in range(8)]
    total = torch.zeros_like(parts[0])
    for g in groups:
        total = total + g
    return total


def _kernel_bwd(q, k, v, do, bias, scale, per_block):
    """The wgmma kernels' order of operations on f32 ``[B, W, H, N, D]``
    operands holding bf16 values and an f32 ``[W, H, N, N]`` bias (or None).

    Returns bf16 dq, dk, dv and the f32 dbias (or None), the batch summed in
    chunks of ``per_block`` entries."""
    n = q.shape[-2]
    half = _keys_held(n) // 2
    x = (q @ k.transpose(-1, -2)) * scale
    if bias is not None:
        x = x + bias
    dp = do @ v.transpose(-1, -2)
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp2((x - m) * LOG2E)
    l = e[..., :half].sum(-1, keepdim=True) + e[..., half:].sum(-1, keepdim=True)
    a = (e * dp)[..., :half].sum(-1, keepdim=True) + (e * dp)[..., half:].sum(-1, keepdim=True)
    il = 1.0 / l
    delta = a * il
    p = e * il
    ds = p * (dp - delta)
    hi, lo = _split(ds)
    dq = sum((hi[..., sl] @ k[..., sl, :] + lo[..., sl] @ k[..., sl, :])
             for sl in (slice(0, half), slice(half, None))) * scale
    dv = p.to(BF16).float().transpose(-1, -2) @ do
    dk = (hi.transpose(-1, -2) @ q + lo.transpose(-1, -2) @ q) * scale
    dbias = None
    if bias is not None:
        parts = []
        for b0 in range(0, q.shape[0], per_block):
            part = torch.zeros_like(ds[0])
            for b in range(b0, min(q.shape[0], b0 + per_block)):
                part = part + ds[b]
            parts.append(part)
        dbias = parts[0] if len(parts) == 1 else _column_sum(torch.stack(parts))
    return dq.to(BF16), dk.to(BF16), dv.to(BF16), dbias


def _bf16(rng, shape):
    return torch.tensor(rng.normal(size=shape), dtype=F32).to(BF16)


def _jnp(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _check_self_attention(rng, n, heads=2, d=128):
    """B1 with one batch entry against _sa_bwd."""
    c = heads * d
    q, k, v, do = (_bf16(rng, (1, n, c)) for _ in range(4))
    scale = d ** -0.5

    def heads_first(t):  # [1, N, H * D] -> f32 [1, 1, H, N, D]
        return t.float().reshape(1, n, heads, d).transpose(1, 2)[:, None]

    got = _kernel_bwd(*(heads_first(t) for t in (q, k, v, do)), None, scale, 1)[:3]
    got = [g.float()[:, 0].transpose(1, 2).reshape(1, n, c) for g in got]
    _, vjp = jax.vjp(lambda a, b_, c_: jax_self_attention(a, b_, c_, heads, scale, True), _jnp(q), _jnp(k), _jnp(v))
    want = vjp(_jnp(do))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= GRAD_BAR


def _check_window_attention(rng, n, b=2, w=2, heads=1, d=128, per_block=1):
    """B2 with a -1e9 shift-mask bias (key 0 left to every row) against _v2_bwd."""
    c = heads * d
    qkv = _bf16(rng, (b, w, n, 3 * c))
    do = _bf16(rng, (b, w, n, c))
    bias = rng.normal(size=(w, heads, n, n)).astype(np.float32)
    bias[..., 1::3] = -1e9
    bias[..., 0] = 0.0
    scale = d ** -0.5
    x = qkv.float().reshape(b, w, n, 3, heads, d).permute(3, 0, 1, 4, 2, 5)  # [3, B, W, H, N, D]
    dof = do.float().reshape(b, w, n, heads, d).permute(0, 1, 3, 2, 4)
    dq, dk, dv, dbias = _kernel_bwd(x[0], x[1], x[2], dof, torch.tensor(bias), scale, per_block)
    got = torch.stack([dq, dk, dv]).float().permute(1, 2, 4, 0, 3, 5).reshape(b, w, n, 3 * c)
    _, vjp = jax.vjp(lambda a, bb: jax_window_v2(a, bb, heads, scale, True), _jnp(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = vjp(_jnp(do))
    for part in range(3):
        sl = slice(part * c, (part + 1) * c)
        assert _rel(got[..., sl].numpy(), np.asarray(want_dqkv, np.float32)[..., sl]) <= GRAD_BAR
    assert _rel(dbias.numpy(), want_dbias) <= DBIAS_BAR


@pytest.mark.parametrize("n", [144, 216, 1, 17, 224])
def test_kernel_order_matches_pallas_self_attention(rng, n):
    """The main path's N (216: the ViT; 144: a Swin window), the route's
    edges (N = 1, 17, 224), head_dim 128."""
    _check_self_attention(rng, n)


@pytest.mark.parametrize("n,per_block", [(144, 1), (216, 1), (1, 1), (17, 2), (224, 1)])
def test_kernel_order_matches_pallas_window_attention(rng, n, per_block):
    """B2 at the same N with -1e9 bias entries; dbias over two batch chunks
    (per_block 1) or one (per_block 2)."""
    _check_window_attention(rng, n, per_block=per_block)


def test_column_sum_order_over_many_chunks(rng):
    """Eleven chunks' partials (more than the column sum's 8 row groups) and
    three entries a chunk, as B2's smaller Swin stages chunk a batch of 32."""
    _check_window_attention(rng, 36, b=32, w=1, heads=2, d=32, per_block=3)
