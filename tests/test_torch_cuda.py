"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``; every test skips on a machine without a card.  The file
imports no JAX, so it also runs on a card machine that has none:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Shapes: the main-path ones, plus odd ones that take the CUDA-core kernel in
bf16 (head_dim 8 or 24, N above 224) and ragged tails.  B6 (the fused attention sublayer) and the
v1 adapter are held at the bars of the backwards below, forward and
backward.  Tolerances: forwards bf16 atol 3e-2, f32
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


# Backward shapes: the batch-32 train shapes, and the edges of the two
# routes (bf16 takes the tensor cores at head_dim % 16 == 0 and N <= 224):
# N = 224 (tensor cores) and 225 (CUDA cores), N = 1, 17 and 145 (ragged
# tails), head_dim 16 (tensor cores), head_dim 8 and 24 (CUDA cores), and
# N = 240 (CUDA cores).
SA_BWD_SHAPES = [(32, 216, 768, 6), (2, 224, 128, 1), (2, 225, 128, 1), (2, 1, 32, 2), (3, 17, 32, 2),
                 (2, 145, 256, 2), (3, 16, 32, 2), (2, 70, 64, 1), (2, 40, 16, 2), (2, 40, 48, 2),
                 (2, 240, 128, 1)]
V2_BWD_SHAPES = [(32, 64, 144, 128, 1), (32, 16, 144, 256, 2), (32, 4, 144, 512, 4), (32, 1, 144, 1024, 8),
                 (32, 1, 216, 768, 6), (2, 1, 224, 128, 1), (2, 1, 225, 128, 1), (2, 3, 1, 32, 2),
                 (3, 2, 17, 32, 2), (2, 2, 145, 128, 1), (3, 2, 16, 32, 2), (2, 2, 16, 16, 2), (2, 1, 240, 48, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c,heads", SA_BWD_SHAPES)
def test_self_attention_bwd_kernel_matches_plain(cuda, dtype, b, n, c, heads):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn((b, n, c), generator=gen, device=cuda).to(dtype) for _ in range(4))
    scale = (c // heads) ** -0.5
    wa.reset_launch_counts()
    got = wa.self_attention_bwd_kernel(q, k, v, do, heads, scale)
    want = wa.self_attention_bwd_reference(q, k, v, do, heads, scale)
    route = wa.attention_bwd_route(dtype, n, c // heads)
    assert wa.BWD_ROUTES == {name: int(name == route) for name in wa.BWD_ROUTES}
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert _rel_err(g, w) <= _bwd_bar(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,n,c,heads", V2_BWD_SHAPES)
def test_window_attention_bwd_kernel_matches_plain(cuda, dtype, b, w, n, c, heads):
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn((b, w, n, 3 * c), generator=gen, device=cuda).to(dtype)
    do = torch.randn((b, w, n, c), generator=gen, device=cuda).to(dtype)
    bias = torch.randn((w, heads, n, n), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    scale = (c // heads) ** -0.5
    wa.reset_launch_counts()
    dqkv, dbias = wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, scale)
    route = wa.attention_bwd_route(dtype, n, c // heads)
    assert wa.BWD_ROUTES == {name: int(name == route) for name in wa.BWD_ROUTES}
    want_dqkv, want_dbias = wa.window_attention_v2_bwd_reference(qkv, bias, do, heads, scale)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    assert _rel_err(dqkv, want_dqkv) <= _bwd_bar(dtype)
    assert _rel_err(dbias, want_dbias) <= 1e-4
    again = wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, scale)[1]
    assert torch.equal(again, dbias)  # a fixed summation order


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,n,c,heads", [(32, 16, 144, 256, 2), (32, 1, 216, 768, 6)])
def test_window_attention_bwd_is_deterministic(cuda, dtype, b, w, n, c, heads):
    """dqkv and dbias the same bit for bit over two launches: no atomics, one
    summation order (dbias: per batch chunk in shared memory, then the chunks)."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    qkv = torch.randn((b, w, n, 3 * c), generator=gen, device=cuda).to(dtype)
    do = torch.randn((b, w, n, c), generator=gen, device=cuda).to(dtype)
    bias = torch.randn((w, heads, n, n), generator=gen, device=cuda)
    first = wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, 0.09)
    second = wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, 0.09)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_bwd_route_mirrors_the_entry_points(cuda):
    """attention_bwd_route (Python) picks what edrl_attention_bwd_route (C) picks."""
    from edrl_tpu_torch.kernels import build

    lib = build.load_library()
    for dtype in (torch.bfloat16, torch.float32):
        for n in (1, 16, 17, 144, 145, 216, 224, 225, 240, 256):
            for d in (8, 16, 24, 32, 64, 128):
                want = wa.attention_bwd_route(dtype, n, d)
                got = lib.edrl_attention_bwd_route(int(dtype == torch.bfloat16), n, d)
                assert {1: "mma", 0: "fma"}[got] == want, (dtype, n, d)


@pytest.mark.cuda
def test_fwd_route_mirrors_the_entry_points(cuda):
    """attention_fwd_route (Python) picks what edrl_attention_fwd_route (C) picks."""
    from edrl_tpu_torch.kernels import build

    lib = build.load_library()
    for dtype in (torch.bfloat16, torch.float32):
        for n in (1, 16, 17, 144, 145, 216, 224, 225, 240, 256):
            for d in (8, 16, 24, 32, 64, 128):
                want = wa.attention_fwd_route(dtype, n, d)
                got = lib.edrl_attention_fwd_route(int(dtype == torch.bfloat16), n, d)
                assert {1: "mma", 0: "fma"}[got] == want, (dtype, n, d)


# The forward at the backward's shapes: the train shapes and both routes' edges.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,n,c,heads", SA_BWD_SHAPES)
def test_self_attention_fwd_kernel_counts_its_route(cuda, dtype, atol, b, n, c, heads):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((b, n, c), generator=gen, device=cuda).to(dtype) for _ in range(3))
    scale = (c // heads) ** -0.5
    wa.reset_launch_counts()
    got = wa._self_attention_fwd_kernel(q, k, v, heads, scale)
    route = wa.attention_fwd_route(dtype, n, c // heads)
    assert wa.FWD_ROUTES == {name: int(name == route) for name in wa.FWD_ROUTES}
    want = wa.self_attention_reference(q, k, v, heads, scale)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,w,n,c,heads", V2_BWD_SHAPES)
def test_window_attention_fwd_kernel_counts_its_route(cuda, dtype, atol, b, w, n, c, heads):
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((b, w, n, 3 * c), generator=gen, device=cuda).to(dtype)
    bias = torch.randn((w, heads, n, n), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    scale = (c // heads) ** -0.5
    wa.reset_launch_counts()
    got = wa.window_attention_v2_fwd_kernel(qkv, bias, heads, scale)
    route = wa.attention_fwd_route(dtype, n, c // heads)
    assert wa.FWD_ROUTES == {name: int(name == route) for name in wa.FWD_ROUTES}
    want = wa.window_attention_v2_reference(qkv, bias, heads, scale)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_autograd_reaches_the_backward_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, 40, 64), generator=gen, device=cuda, requires_grad=True) for _ in range(3))
    qkv = torch.randn((2, 4, 16, 96), generator=gen, device=cuda, requires_grad=True)
    bias = torch.randn((4, 2, 16, 16), generator=gen, device=cuda, requires_grad=True)
    wa.reset_launch_counts()
    (wa.self_attention_fused(q, k, v, 2, 0.3).sum() + wa.window_attention_fused_v2(qkv, bias, 2, 0.3).sum()).backward()
    assert wa.LAUNCHES == {name: int(name not in (wa.WINDOW_ATTENTION_V1, wa.WINDOW_ATTENTION_V1_BWD))
                           for name in wa.LAUNCHES}
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


# ---------------------------------------------------------------------------
# B4 (fused LayerNorm) and B5 (fused MLP).  Bars, relative to the largest
# magnitude of the plain result, as for the attention backwards: 1e-2 for
# bf16 results, 1e-4 for f32 ones; B5's f32 results 2^-8, because the
# kernel and the plain version sum in different orders, and a value next to
# a bf16 rounding boundary (the activation, or dh in the backward) then
# rounds the other way, moving one term of each sum it enters by 2^-8 of
# itself (up to ~2e-3 of the largest magnitude where a sum has few terms).
# ---------------------------------------------------------------------------

from edrl_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from edrl_tpu_torch.kernels import layer_norm as ln  # noqa: E402
from edrl_tpu_torch.models import layers  # noqa: E402


def _mlp_bar(dtype):
    return 1e-2 if dtype == torch.bfloat16 else 2.0 ** -8


def _ln_inputs(cuda, m, c, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn((m, c), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device=cuda)
    beta = 0.1 * torch.randn((c,), generator=gen, device=cuda)
    dy = torch.randn((m, c), generator=gen, device=cuda).to(dtype)
    return x, gamma, beta, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", [(37, 128), (1000, 768), (4608, 2048), (3, 1152)])
def test_layer_norm_kernels_match_plain(cuda, dtype, m, c):
    x, gamma, beta, dy = _ln_inputs(cuda, m, c, dtype, 6)
    y = ln.layer_norm_fwd_kernel(x, gamma, beta)
    assert y.dtype == dtype
    assert _rel_err(y, ln.layer_norm_reference(x, gamma, beta)) <= _bwd_bar(dtype)
    got = ln.layer_norm_bwd_kernel(x, dy, gamma)
    want = ln.layer_norm_bwd_reference(x, dy, gamma)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    assert _rel_err(got[0], want[0]) <= _bwd_bar(dtype)
    for g, w in zip(got[1:], want[1:]):
        assert _rel_err(g, w) <= 1e-4
    again = ln.layer_norm_bwd_kernel(x, dy, gamma)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])  # a fixed summation order


@pytest.mark.cuda
@pytest.mark.parametrize("c", [200, 4096])
def test_layer_norm_kernel_refuses_a_width(cuda, c):
    x = torch.zeros((4, c), device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        ln.layer_norm_fwd_kernel(x, torch.ones(c, device=cuda), torch.zeros(c, device=cuda))


def _mlp_inputs(cuda, m, c, h, dtype, seed, wdtype=torch.float32):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    u = torch.randn((m, c), generator=gen, device=cuda).to(dtype)
    w1 = (torch.randn((c, h), generator=gen, device=cuda) / c ** 0.5).to(wdtype)
    b1 = 0.1 * torch.randn((h,), generator=gen, device=cuda)
    w2 = (torch.randn((h, c), generator=gen, device=cuda) / h ** 0.5).to(wdtype)
    b2 = 0.1 * torch.randn((c,), generator=gen, device=cuda)
    dy = torch.randn((m, c), generator=gen, device=cuda).to(dtype)
    return u, w1, b1, w2, b2, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,h", [(37, 128, 512), (300, 768, 3072), (40, 1024, 4096), (33, 256, 1024),
                                   (2000, 128, 512)])
def test_fused_mlp_kernels_match_plain(cuda, dtype, m, c, h):
    u, w1, b1, w2, b2, dy = _mlp_inputs(cuda, m, c, h, dtype, 7)
    y = fm.fused_mlp_fwd_kernel(u, w1, b1, w2, b2)
    assert y.dtype == dtype
    assert _rel_err(y, fm.fused_mlp_reference(u, w1, b1, w2, b2)) <= _mlp_bar(dtype)
    got = fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2)
    want = fm.fused_mlp_bwd_reference(u, dy, w1, b1, w2)
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= _mlp_bar(dtype)
    again = fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2)
    for g, a in zip(got[1:], again[1:]):
        assert torch.equal(g, a)  # a fixed summation order


@pytest.mark.cuda
def test_fused_mlp_takes_bf16_weights(cuda):
    """Serving stores w1/w2 in bf16: the same products as from f32 weights."""
    u, w1, b1, w2, b2, _ = _mlp_inputs(cuda, 64, 256, 1024, torch.bfloat16, 8)
    y32 = fm.fused_mlp_fwd_kernel(u, w1, b1, w2, b2)
    y16 = fm.fused_mlp_fwd_kernel(u, w1.bfloat16(), b1, w2.bfloat16(), b2)
    assert torch.equal(y32, y16)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", [(200, 512), (2048, 8192), (128, 96)])
def test_fused_mlp_kernel_refuses_a_shape(cuda, c, h):
    u, w1, b1, w2, b2, _ = _mlp_inputs(cuda, 4, c, h, torch.bfloat16, 9)
    with pytest.raises(ValueError, match="the kernel takes C"):
        fm.fused_mlp_fwd_kernel(u, w1, b1, w2, b2)


# The bf16 (wgmma) route at one shape per C class, fused forward (C = 128) and
# two products (C >= 256), ragged M, several weight-gradient splits.
WGMMA_SHAPES = [(37, 128, 512), (2000, 128, 512), (1000, 256, 1024), (33, 256, 1024), (130, 512, 2048),
                (300, 768, 3072), (4000, 768, 3072), (40, 1024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,h", WGMMA_SHAPES)
def test_fused_mlp_wgmma_route_matches_plain(cuda, wdtype, m, c, h):
    u, w1, b1, w2, b2, dy = _mlp_inputs(cuda, m, c, h, torch.bfloat16, 10, wdtype)
    fm.reset_launch_counts()
    y = fm.fused_mlp_fwd_kernel(u, w1, b1, w2, b2)
    got = fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2)
    again = fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2)
    assert fm.MLP_ROUTES == {"wgmma": 3, "mma": 0}
    assert _rel_err(y, fm.fused_mlp_reference(u, w1, b1, w2, b2)) <= 1e-2
    for g, w in zip(got, fm.fused_mlp_bwd_reference(u, dy, w1, b1, w2)):
        assert _rel_err(g, w) <= 1e-2
    for g, a in zip(got[1:], again[1:]):
        assert torch.equal(g, a)  # fixed-order sums over M


@pytest.mark.cuda
def test_fused_mlp_route_mirrors_the_entry_point(cuda):
    """fused_mlp_route (Python) picks what edrl_fused_mlp_route (C) picks."""
    from edrl_tpu_torch.kernels import build

    lib = build.load_library()
    for dtype in (torch.bfloat16, torch.float32):
        for c in (0, 128, 200, 256, 512, 768, 1024, 1152):
            for h in (0, 96, 128, 512, 3072, 4096):
                got = lib.edrl_fused_mlp_route(int(dtype == torch.bfloat16), c, h)
                assert {1: "wgmma", 0: "mma", -1: None}[got] == fm.fused_mlp_route(dtype, c, h), (dtype, c, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "mma")])
def test_fused_mlp_counts_its_route(cuda, dtype, route):
    mlp = layers.Mlp(256, 1024, 256, use_fused=True, dtype=dtype, device=cuda)
    layers.init_parameters(mlp, torch.Generator(device=cuda).manual_seed(3))
    x = torch.randn((3, 40, 256), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda,
                    requires_grad=True)
    fm.reset_launch_counts()
    mlp(x).float().sum().backward()
    assert fm.LAUNCHES == {fm.FUSED_MLP: 1, fm.FUSED_MLP_BWD: 1}
    assert fm.MLP_ROUTES == {"wgmma": 2 * (route == "wgmma"), "mma": 2 * (route == "mma")}


@pytest.mark.cuda
def test_fused_mlp_wgmma_route_takes_an_unaligned_view(cuda):
    """A u that starts off a 16-byte boundary is copied for TMA, not refused."""
    u, w1, b1, w2, b2, _ = _mlp_inputs(cuda, 65, 256, 1024, torch.bfloat16, 11)
    view = u.reshape(-1)[1:].reshape(-1)[: 64 * 256].reshape(64, 256)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    y = fm.fused_mlp_fwd_kernel(view, w1, b1, w2, b2)
    assert _rel_err(y, fm.fused_mlp_reference(view, w1, b1, w2, b2)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", [(128, 96), (1152, 4608)])
def test_fused_mlp_wgmma_route_refuses_a_shape(cuda, c, h):
    assert fm.fused_mlp_route(torch.bfloat16, c, h) is None
    u, w1, b1, w2, b2, dy = _mlp_inputs(cuda, 8, c, h, torch.bfloat16, 12)
    fm.reset_launch_counts()
    with pytest.raises(ValueError, match="the kernel takes C"):
        fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2)
    assert fm.MLP_ROUTES == {"wgmma": 0, "mma": 0}


@pytest.mark.cuda
def test_autograd_through_the_modules_reaches_the_b4_b5_kernels(cuda):
    norm = layers.LayerNorm(256, use_fused=True, dtype=torch.bfloat16, device=cuda)
    mlp = layers.Mlp(256, 1024, 256, use_fused=True, dtype=torch.bfloat16, device=cuda)
    layers.init_parameters(norm, torch.Generator(device=cuda).manual_seed(0))
    layers.init_parameters(mlp, torch.Generator(device=cuda).manual_seed(1))
    x = torch.randn((2, 40, 256), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda,
                    requires_grad=True)
    ln.reset_launch_counts()
    fm.reset_launch_counts()
    mlp(norm(x)).float().sum().backward()
    assert ln.LAUNCHES == {ln.LAYER_NORM: 1, ln.LAYER_NORM_BWD: 1}
    assert fm.LAUNCHES == {fm.FUSED_MLP: 1, fm.FUSED_MLP_BWD: 1}
    assert all(torch.isfinite(p.grad).all() for p in (*norm.parameters(), *mlp.parameters()))
    assert x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# B6 (fused attention sublayer) and the v1 adapter over the B2 kernels.  Bars
# relative to the plain result's largest magnitude: 1e-2 for results of a
# bf16 call (its f32 gradients are sums of bf16 cotangents), 1e-4 in f32;
# dbias 1e-4 in both (the B2 backward gets the same inputs on both paths).
# ---------------------------------------------------------------------------

from edrl_tpu_torch.kernels import block_attention as ba  # noqa: E402
from edrl_tpu_torch.models import swin2d  # noqa: E402


def _sublayer_inputs(cuda, b, w, n, c, heads, wb, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    bias = randn(wb, heads, n, n)
    bias[..., 1::3] = -1e9
    return (randn(b, w, n, c).to(dtype), 1 + 0.1 * randn(c), 0.1 * randn(c),
            (randn(c, 3 * c) / c ** 0.5).to(dtype), 0.1 * randn(3 * c), (randn(c, c) / c ** 0.5).to(dtype),
            0.1 * randn(c), bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,n,c,heads,wb", [(2, 64, 144, 128, 1, 1), (2, 16, 144, 256, 2, 16),
                                              (4, 1, 216, 768, 6, 1), (2, 1, 144, 1024, 8, 1),
                                              (3, 2, 40, 128, 8, 2), (2, 3, 16, 256, 4, 1)])
def test_attention_sublayer_kernels_match_plain(cuda, dtype, b, w, n, c, heads, wb):
    args = _sublayer_inputs(cuda, b, w, n, c, heads, wb, dtype, 10)
    scale = (c // heads) ** -0.5
    ba.reset_launch_counts()
    got = ba.attention_sublayer_fwd_kernel(*args, heads, scale)
    want = ba.attention_sublayer_reference(*args, heads, scale)
    assert ba.LAUNCHES[ba.ATTENTION_SUBLAYER] == 1
    for g, w_ in zip(got, want):
        assert g.dtype == dtype and _rel_err(g, w_) <= _bwd_bar(dtype)
    x, gamma, _, wqkv, _, wproj, _, bias = args
    y, qkv, xln = got
    dy = torch.randn(y.shape, generator=torch.Generator(device=cuda).manual_seed(11), device=cuda).to(dtype)
    grads = ba.attention_sublayer_bwd_kernel(x, xln, qkv, gamma, wqkv, wproj, bias, dy, heads, scale)
    plain = ba.attention_sublayer_bwd_reference(x, xln, qkv, gamma, wqkv, wproj, bias, dy, heads, scale)
    for i, (g, w_) in enumerate(zip(grads, plain)):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert _rel_err(g, w_) <= (1e-4 if i == 7 else _bwd_bar(dtype)), i


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,what", [(200, 2, "multiple of 128"), (256, 1, "head_dim"),
                                          (4096, 32, "multiple of 128")])
def test_attention_sublayer_kernel_refuses_a_shape(cuda, c, heads, what):
    args = _sublayer_inputs(cuda, 1, 1, 16, c, heads, 1, torch.bfloat16, 12)
    with pytest.raises(ValueError, match=what):
        ba.attention_sublayer_fwd_kernel(*args, heads, 0.25)


@pytest.mark.cuda
def test_attention_sublayer_refuses_a_grad_over_256_tokens(cuda):
    args = list(_sublayer_inputs(cuda, 1, 1, 264, 128, 1, 1, torch.float32, 13))
    args[0].requires_grad_()
    with pytest.raises(ValueError, match="at most 256 tokens"):
        ba.attention_sublayer_fused(*args, 1, 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 6])
def test_autograd_through_the_swin_block_reaches_b6_and_b2(cuda, shift):
    block = swin2d.SwinBlock(128, 24, 1, 12, shift, use_fused_block_attention=True, dtype=torch.bfloat16,
                             device=cuda)
    layers.init_parameters(block, torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn((2, 4, 144, 128), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda,
                    requires_grad=True)
    ba.reset_launch_counts()
    wa.reset_launch_counts()
    block(x).float().sum().backward()
    assert ba.LAUNCHES == {ba.ATTENTION_SUBLAYER: 1}
    assert wa.LAUNCHES[wa.WINDOW_ATTENTION_V2] == wa.LAUNCHES[wa.WINDOW_ATTENTION_V2_BWD] == 1
    assert wa.LAUNCHES[wa.SELF_ATTENTION] == 0
    for name, p in block.named_parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype and torch.isfinite(p.grad).all(), name
    assert x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,h,n,d", [(4, 64, 1, 144, 128), (2, 1, 8, 144, 128), (3, 2, 2, 16, 16)])
def test_v1_adapter_matches_plain(cuda, dtype, b, w, h, n, d):
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v, do = (torch.randn((b, w, h, n, d), generator=gen, device=cuda).to(dtype) for _ in range(4))
    q = q * d ** -0.5
    bias = torch.randn((w, h, n, n), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    wa.reset_launch_counts()
    out = wa.window_attention_fused(*leaves)
    out.backward(do)
    assert wa.LAUNCHES[wa.WINDOW_ATTENTION_V1] == wa.LAUNCHES[wa.WINDOW_ATTENTION_V1_BWD] == 1
    assert wa.LAUNCHES[wa.WINDOW_ATTENTION_V2] == wa.LAUNCHES[wa.WINDOW_ATTENTION_V2_BWD] == 0
    assert out.dtype == dtype and _rel_err(out, wa.window_attention_reference(q, k, v, bias)) <= _bwd_bar(dtype)
    want = wa.window_attention_bwd_reference(q, k, v, bias, do)
    for leaf, w_, bar in zip(leaves, want, (_bwd_bar(dtype),) * 3 + (1e-4,)):
        assert leaf.grad.dtype == w_.dtype and _rel_err(leaf.grad, w_) <= bar
