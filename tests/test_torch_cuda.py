"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``; every test skips on a machine without a card.  The file
imports no JAX, so it also runs on a card machine that has none:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Shapes: the main-path ones, plus odd ones that take the CUDA-core kernel in
bf16 (head_dim 8 or 24, N above 224) and ragged tails; the bf16 forward's
wgmma route against NaN in the group after a view's last, and where a
consumer warpgroup has no query tile.  B6 (the fused attention sublayer) and v1
(window attention in its own [B, W, H, N, D] layout) are held at the bars
of the backwards below, forward and backward.  Tolerances: forwards bf16 atol 3e-2, f32
atol 1e-4.  Backwards, relative to the largest magnitude of the plain
version's result (gradients scale with their inputs): 1e-2 for bf16
results (one bf16 rounding is 2^-8), 1e-4 for f32 results, dbias included.
MK-MMD: the value rtol 1e-4 (``tests/test_kernels.py``'s bar), the
gradients 1e-4 of their largest magnitude against the closed-form plain
backward (``ops.mmd.mk_mmd_bwd_reference``).
"""

import pytest
import torch

from edrl_tpu_torch.kernels import build
from edrl_tpu_torch.kernels import mmd as kmmd
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.ops.mmd import mk_mmd, mk_mmd_bwd_reference, mk_mmd_grad_d2


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


# Backward shapes: the batch-32 train shapes, a head-local tensor-parallel
# shard of each (B1's 3 of 6 heads, B2's 1 of Swin stage 1's 2), and the
# edges of the two routes (bf16 takes wgmma at head_dim % 16 == 0 and N <=
# 224): N = 224 (wgmma) and 225 (CUDA cores), N = 1, 17 and 145 (ragged
# tails), head_dim 16 (wgmma), head_dim 8 and 24 (CUDA cores), and N = 240
# (CUDA cores).
SA_BWD_SHAPES = [(32, 216, 768, 6), (32, 216, 384, 3), (2, 224, 128, 1), (2, 225, 128, 1), (2, 1, 32, 2),
                 (3, 17, 32, 2), (2, 145, 256, 2), (3, 16, 32, 2), (2, 70, 64, 1), (2, 40, 16, 2), (2, 40, 48, 2),
                 (2, 240, 128, 1)]
V2_BWD_SHAPES = [(32, 64, 144, 128, 1), (32, 16, 144, 256, 2), (32, 4, 144, 512, 4), (32, 1, 144, 1024, 8),
                 (32, 1, 216, 768, 6), (32, 16, 144, 128, 1), (2, 1, 224, 128, 1), (2, 1, 225, 128, 1),
                 (2, 3, 1, 32, 2), (3, 2, 17, 32, 2), (2, 2, 145, 128, 1), (3, 2, 16, 32, 2), (2, 2, 16, 16, 2),
                 (2, 1, 240, 48, 2)]


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
                assert {1: "wgmma", 0: "fma"}[got] == want, (dtype, n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads", [(32, 216, 768, 6), (3, 17, 32, 2)])
def test_self_attention_bwd_is_deterministic(cuda, b, n, c, heads):
    """dq, dk and dv the same bit for bit over two launches of the wgmma route."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    q, k, v, do = (torch.randn((b, n, c), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(4))
    first = wa.self_attention_bwd_kernel(q, k, v, do, heads, 0.09)
    second = wa.self_attention_bwd_kernel(q, k, v, do, heads, 0.09)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.cuda
def test_wgmma_bwd_kernels_do_not_spill(cuda):
    """The rows and keys kernels keep to their registers after setmaxnreg
    (ptxas reports no spill for any of their instances) and fit a CTA on
    an SM at the main-path shapes."""
    import ctypes

    lib = build.load_library()
    entry, found, spills = None, set(), []
    for line in build.build_library().with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif entry and ("attention_bwd_rows_kernel" in entry or "attention_bwd_keys_kernel" in entry):
            found.add("rows" if "rows" in entry else "keys")
            if "spill stores" in line and int(line.split(" bytes spill stores")[0].split()[-1]):
                spills.append((entry, line))
    assert found == {"rows", "keys"} and not spills, spills
    occ = (ctypes.c_int * 4)()
    for n, with_dbias in ((216, 0), (144, 1), (216, 1)):
        assert lib.edrl_attention_bwd_occupancy(1, n, 128, with_dbias, occ) == 0
        assert occ[0] >= 1 and occ[1] >= 1, (n, with_dbias, tuple(occ))


# The wgmma backward reads q, k, v and do through 4-D tensor maps: with NaN
# in the group after a view's last, dq, dk, dv and dbias are finite and within
# the bars (B1's packed layout at N = 216, B2's at N = 144 with a bias, v1's).
@pytest.mark.cuda
def test_wgmma_bwd_reads_no_neighbouring_group(cuda):
    gen = torch.Generator(device=cuda).manual_seed(20)
    bias = torch.randn((4, 2, 144, 144), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    wa.reset_launch_counts()
    q, k, v, do = (_nan_after((4, 216, 768), torch.bfloat16, gen, cuda) for _ in range(4))
    got = wa.self_attention_bwd_kernel(q[:4], k[:4], v[:4], do[:4], 6, 128 ** -0.5)
    want = wa.self_attention_bwd_reference(q[:4], k[:4], v[:4], do[:4], 6, 128 ** -0.5)
    assert all(torch.isfinite(g).all() and _rel_err(g, w) <= 1e-2 for g, w in zip(got, want))

    qkv, do = _nan_after((2, 4, 144, 768), torch.bfloat16, gen, cuda), _nan_after((2, 4, 144, 256), torch.bfloat16,
                                                                                   gen, cuda)
    dqkv, dbias = wa.window_attention_v2_bwd_kernel(qkv[:2], bias, do[:2], 2, 128 ** -0.5)
    want_dqkv, want_dbias = wa.window_attention_v2_bwd_reference(qkv[:2], bias, do[:2], 2, 128 ** -0.5)
    assert torch.isfinite(dqkv).all() and _rel_err(dqkv, want_dqkv) <= 1e-2
    assert torch.isfinite(dbias).all() and _rel_err(dbias, want_dbias) <= 1e-4

    q, k, v, do = (_nan_after((2, 3, 2, 144, 128), torch.bfloat16, gen, cuda) for _ in range(4))
    got = wa.window_attention_v1_bwd_kernel(q[:2], k[:2], v[:2], bias[:3].contiguous(), do[:2])
    want = wa.window_attention_bwd_reference(q[:2], k[:2], v[:2], bias[:3].contiguous(), do[:2])
    assert all(torch.isfinite(g).all() and _rel_err(g, w) <= 1e-2 for g, w in zip(got[:3], want[:3]))
    assert _rel_err(got[3], want[3]) <= 1e-4
    assert wa.BWD_ROUTES == {"wgmma": 3, "fma": 0}


# Units where one of the rows kernel's consumer warpgroups has no key below N
# (N = 17 holds 64 keys, 32 a warpgroup) or few (N = 100 and 150 hold 160),
# and pipelines of the keys kernel with 3 or more units each; three calls
# each against the plain version.
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["B2 N=100 d=64", "B1 N=150", "B1 N=17"])
def test_wgmma_bwd_with_warpgroups_without_a_tile(cuda, case):
    import ctypes

    gen = torch.Generator(device=cuda).manual_seed(21)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    grid = (ctypes.c_int * 7)()
    wa.reset_launch_counts()
    if case.startswith("B2"):
        qkv = torch.randn((8, 64, 100, 384), generator=gen, device=cuda).to(torch.bfloat16)
        do = torch.randn((8, 64, 100, 128), generator=gen, device=cuda).to(torch.bfloat16)
        bias = torch.randn((64, 2, 100, 100), generator=gen, device=cuda)
        bias[..., 1::3] = -1e9
        want = wa.window_attention_v2_bwd_reference(qkv, bias, do, 2, 64 ** -0.5)
        for _ in range(3):
            got = wa.window_attention_v2_bwd_kernel(qkv, bias, do, 2, 64 ** -0.5)
            assert _rel_err(got[0], want[0]) <= 1e-2 and _rel_err(got[1], want[1]) <= 1e-4
        assert build.load_library().edrl_attention_bwd_grid(100, 8, 64, 2, 1, grid) == 0
    else:
        n, b = int(case.split("=")[1]), 6 * sms + sms // 2 - 6
        q, k, v, do = (torch.randn((b, n, 128), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(4))
        want = wa.self_attention_bwd_reference(q, k, v, do, 1, 128 ** -0.5)
        for _ in range(3):
            got = wa.self_attention_bwd_kernel(q, k, v, do, 1, 128 ** -0.5)
            assert all(_rel_err(g, w) <= 1e-2 for g, w in zip(got, want))
        assert build.load_library().edrl_attention_bwd_grid(n, b, 1, 1, 1, grid) == 0
        assert grid[1] >= 3 * grid[0] and grid[3] >= 6 * grid[2], tuple(grid)
    assert wa.BWD_ROUTES == {"wgmma": 3, "fma": 0}


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
                assert {1: "wgmma", 0: "fma"}[got] == want, (dtype, n, d)


# The wgmma route's tensor maps (edrl_attention_fwd_map_plan) at the layouts
# it reads: dims (d, heads, n, groups), byte strides of a head, a token and a
# group, boxes of 64 columns x box rows (64 for q, the keys held for k and v).
@pytest.mark.cuda
@pytest.mark.parametrize("n,d,heads,groups,strides,box,want", [
    # B1's packed q/k/v [32, 216, 768], 6 heads: head stride D, row stride C.
    (216, 128, 6, 32, wa.attention_strides(216, 128, 6, 768), 224,
     (128, 6, 216, 32, 256, 1536, 331776, 64, 1, 224, 1)),
    (216, 128, 6, 32, wa.attention_strides(216, 128, 6, 768), 64,
     (128, 6, 216, 32, 256, 1536, 331776, 64, 1, 64, 1)),
    # B2's packed qkv [32, 64, 144, 3 * 128] at Swin stage 0, one head: row 3C.
    (144, 128, 1, 32 * 64, wa.attention_strides(144, 128, 1, 384), 144,
     (128, 1, 144, 2048, 256, 768, 110592, 64, 1, 144, 1)),
    # v1's [B, W, H, N, D]: a head is a block of N rows.
    (144, 128, 2, 32 * 16, wa.attention_strides(144, 128, 2), 64,
     (128, 2, 144, 512, 36864, 256, 73728, 64, 1, 64, 1)),
    # A head-local tensor-parallel shard: 2 of 4 heads of C = 512 on a rank,
    # the rank's packed qkv rows 3C / 2 = 768 wide.
    (144, 128, 2, 32 * 4, wa.attention_strides(144, 128, 2, 768), 144,
     (128, 2, 144, 128, 256, 1536, 221184, 64, 1, 144, 1)),
])
def test_fwd_tma_plan_of_each_layout(cuda, n, d, heads, groups, strides, box, want):
    import ctypes

    out = (ctypes.c_longlong * 11)()
    group, head, row = strides
    assert build.load_library().edrl_attention_fwd_map_plan(d, heads, n, groups, head, row, group, box, out) == 0
    assert tuple(out) == want


# TMA takes strides in whole 16 bytes: a row, head or group stride that is
# not a multiple of 8 bf16 elements is refused (cudaErrorMisalignedAddress).
@pytest.mark.cuda
@pytest.mark.parametrize("group,head,row", [(216 * 770, 128, 770), (216 * 768, 124, 768), (216 * 768 + 4, 128, 768)])
def test_fwd_tma_plan_refuses_a_misaligned_stride(cuda, group, head, row):
    import ctypes

    out = (ctypes.c_longlong * 11)()
    assert build.load_library().edrl_attention_fwd_map_plan(128, 6, 216, 32, head, row, group, 224, out) != 0


def _nan_after(shape, dtype, gen, device):
    """A tensor of shape[0] + 1 entries along the first axis, the last one NaN."""
    t = torch.randn((shape[0] + 1, *shape[1:]), generator=gen, device=device).to(dtype)
    t[shape[0]] = float("nan")
    return t


# The wgmma forward reads through 4-D tensor maps, so the rows past N of a
# group's last query tile and its keys past N come from TMA's zero fill:
# with NaN in the group after the last, a view of the first groups (same
# strides) must give a finite o within the bar.  B1's packed layout at N =
# 216 (the tail tile's rows 216-255, keys 216-223), B2's at N = 144 with a
# bias (rows 144-191), v1's [B, W, H, N, D].
@pytest.mark.cuda
def test_wgmma_fwd_reads_no_neighbouring_group(cuda):
    gen = torch.Generator(device=cuda).manual_seed(18)
    b, n, c, heads = 4, 216, 768, 6
    q, k, v = (_nan_after((b, n, c), torch.bfloat16, gen, cuda) for _ in range(3))
    wa.reset_launch_counts()
    got = wa.self_attention_fused(q[:b], k[:b], v[:b], heads, 128 ** -0.5)
    want = wa.self_attention_reference(q[:b], k[:b], v[:b], heads, 128 ** -0.5)
    assert torch.isfinite(got).all() and (got.float() - want.float()).abs().max().item() <= 3e-2

    b, w, n, c, heads = 2, 4, 144, 256, 2
    qkv = _nan_after((b, w, n, 3 * c), torch.bfloat16, gen, cuda)
    bias = torch.randn((w, heads, n, n), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    got = wa.window_attention_fused_v2(qkv[:b], bias, heads, 128 ** -0.5)
    want = wa.window_attention_v2_reference(qkv[:b], bias, heads, 128 ** -0.5)
    assert torch.isfinite(got).all() and (got.float() - want.float()).abs().max().item() <= 3e-2

    b, w, h, n, d = 2, 3, 2, 144, 128
    q, k, v = (_nan_after((b, w, h, n, d), torch.bfloat16, gen, cuda) for _ in range(3))
    got = wa.window_attention_v1_fwd_kernel(q[:b], k[:b], v[:b], bias[:w, :h].contiguous())
    want = wa.window_attention_reference(q[:b], k[:b], v[:b], bias[:w, :h].contiguous())
    assert torch.isfinite(got).all() and (got.float() - want.float()).abs().max().item() <= 3e-2
    assert wa.FWD_ROUTES == {"wgmma": 3, "fma": 0}


# A consumer warpgroup with no query tile in a work unit (the third at N <=
# 128; one of a half-item's, when the last wave is at most half the CTAs)
# must release the unit's K and V in step with the others, or the next load
# overwrites them under their products.  Each case has each CTA walk 3 or
# more units; three calls each against the plain version.
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["B2 N=100 d=64", "B1 N=144 halves", "B1 N=150 halves"])
def test_wgmma_fwd_with_warpgroups_without_a_tile(cuda, case):
    import ctypes

    gen = torch.Generator(device=cuda).manual_seed(19)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if case.startswith("B2"):
        n, items = 100, 8 * 64 * 2
        qkv = torch.randn((8, 64, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
        bias = torch.randn((64, 2, n, n), generator=gen, device=cuda)
        bias[..., 1::3] = -1e9
        run = lambda: wa.window_attention_fused_v2(qkv, bias, 2, 64 ** -0.5)  # noqa: E731
        want = wa.window_attention_v2_reference(qkv, bias, 2, 64 ** -0.5)
    else:
        n, items = int(case.split("=")[1].split()[0]), 3 * sms + sms // 2 - 6
        q, k, v = (torch.randn((items, n, 128), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
        run = lambda: wa.self_attention_fused(q, k, v, 1, 128 ** -0.5)  # noqa: E731
        want = wa.self_attention_reference(q, k, v, 1, 128 ** -0.5)
    grid = (ctypes.c_int * 2)()
    assert build.load_library().edrl_attention_fwd_grid(n, items, grid) == 0
    assert grid[1] >= 3 * grid[0], tuple(grid)
    wa.reset_launch_counts()
    for _ in range(3):
        assert (run().float() - want.float()).abs().max().item() <= 3e-2
    assert wa.FWD_ROUTES == {"wgmma": 3, "fma": 0}


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
    route = kmmd.mk_mmd_route(n_s + n_t)
    assert kmmd.MMD_ROUTES == {r: int(r == route) for r in kmmd.MMD_ROUTES}
    assert build.load_library().edrl_mk_mmd_route(n_s + n_t) == int(route == "cluster")
    assert abs(got.item() - want.item()) <= 1e-4 * abs(want.item()) + 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("n_s,n_t,d", [(32, 32, 3072), (3, 5, 7), (1, 1, 130), (40, 24, 200), (70, 50, 129)])
def test_mmd_kernels_forward_and_backward_match_plain(cuda, n_s, n_t, d):
    gen = torch.Generator(device=cuda).manual_seed(6)
    src = torch.randn((n_s, d), generator=gen, device=cuda)
    tgt = torch.randn((n_t, d), generator=gen, device=cuda) * 1.1 + 0.05
    if n_s > 2:
        src[2] = src[1]  # an exact-0 distance off the diagonal
    grad = torch.tensor(0.7, device=cuda)
    kmmd.reset_launch_counts()
    value, state = kmmd.mk_mmd_fwd_kernel(src, tgt)
    grads = kmmd.mk_mmd_bwd_kernel(src, tgt, state, grad)
    assert kmmd.LAUNCHES == {kmmd.MK_MMD: 1, kmmd.MK_MMD_BWD: 1}
    want = mk_mmd(src, tgt)
    assert abs(value.item() - want.item()) <= 1e-4 * abs(want.item()) + 1e-7
    plain = mk_mmd_bwd_reference(src, tgt, grad)
    scale = max(p.abs().max().item() for p in plain)
    if n_s + n_t == 2:  # the gradient is 0 but for rounding: held to the direct term's
        _, total, direct = mk_mmd_grad_d2(src, tgt)
        scale = 2 * grad.item() * (direct + direct.T).abs().sum(dim=1).max().item() * total.abs().max().item()
    for g, p in zip(grads, plain):
        assert g.dtype == torch.float32 and (g - p).abs().max().item() <= 1e-4 * scale
    again = kmmd.mk_mmd_fwd_kernel(src, tgt)
    assert torch.equal(again[0], value) and torch.equal(again[1], state)
    assert all(torch.equal(a, g) for a, g in zip(kmmd.mk_mmd_bwd_kernel(src, tgt, state, grad), grads))


@pytest.mark.cuda
def test_mmd_fused_grad_is_the_plain_paths(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    src = torch.randn((8, 64), generator=gen, device=cuda, requires_grad=True)
    tgt = torch.randn((8, 64), generator=gen, device=cuda, requires_grad=True)
    kmmd.reset_launch_counts()
    kmmd.mk_mmd_fused(src, tgt).backward()
    assert kmmd.LAUNCHES == {kmmd.MK_MMD: 1, kmmd.MK_MMD_BWD: 1}
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


# B4's shapes in a batch-32 train step: the use_fused_ln configuration's
# LayerNorms, and the residual form's (B6's LayerNorm backward).
LN_TRAIN = [(294912, 128), (73728, 512), (73728, 256), (18432, 1024), (18432, 512), (4608, 2048), (4608, 1024),
            (6912, 768)]
LN_RESIDUAL_TRAIN = [(294912, 128), (73728, 256), (18432, 512), (4608, 1024), (6912, 768)]
# Ragged M, and M below the plan's CTA count (200 rows of 2048: 7 backward
# CTAs, 200 of the forward's 528 row groups).
LN_ODD = [(37, 128), (1000, 768), (3, 1152), (200, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", LN_TRAIN + LN_ODD)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", LN_RESIDUAL_TRAIN + LN_ODD)
def test_layer_norm_bwd_residual_kernel_matches_plain(cuda, dtype, m, c):
    """The residual form (B6's LayerNorm backward): an f32 cotangent, and a
    residual cotangent in x's dtype added before dx is rounded once."""
    x, _, _, res = _ln_inputs(cuda, m, c, dtype, 16)
    gen = torch.Generator(device=cuda).manual_seed(17)
    gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device=cuda)
    dy = torch.randn((m, c), generator=gen, device=cuda)
    ln.reset_launch_counts()
    got = ln.layer_norm_bwd_residual_kernel(x, dy, gamma, res)
    again = ln.layer_norm_bwd_residual_kernel(x, dy, gamma, res)
    assert ln.LAUNCHES == {ln.LAYER_NORM: 0, ln.LAYER_NORM_BWD: 2}
    want = ln.layer_norm_bwd_residual_reference(x, dy, gamma, res)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    assert _rel_err(got[0], want[0]) <= _bwd_bar(dtype)
    for g, w in zip(got[1:], want[1:]):
        assert _rel_err(g, w) <= 1e-4
    assert all(torch.equal(a, g) for a, g in zip(again, got))  # a fixed summation order


@pytest.mark.cuda
def test_layer_norm_plan_mirrors_the_entry_point(cuda):
    import ctypes

    from edrl_tpu_torch.kernels import build

    lib, sms = build.load_library(), build.sm_count(cuda)
    out = (ctypes.c_int * 4)()
    for m, c in LN_TRAIN + LN_RESIDUAL_TRAIN + LN_ODD + [(100000, 1920), (5, 640)]:
        for dtype in (torch.bfloat16, torch.float32):
            for i, kind in enumerate(ln.KINDS):
                assert lib.edrl_layer_norm_plan(m, c, int(dtype == torch.bfloat16), i, sms, out) == 0
                assert tuple(out) == ln.layer_norm_plan(m, c, dtype, sms, kind), (m, c, dtype, kind)
    assert lib.edrl_layer_norm_plan(100, 200, 1, 1, sms, out) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_bwd_entry_refuses_another_partial_count(cuda, residual):
    """The C backward plans its own grid; a partials buffer of any other row
    count than that plan's is refused before a launch."""
    from edrl_tpu_torch.kernels import build

    m, c = 4608, 1024
    x, gamma, _, dy = _ln_inputs(cuda, m, c, torch.bfloat16, 9)
    res = dy if residual else None
    dy = dy.float() if residual else dy
    plan = ln.layer_norm_plan(m, c, x.dtype, build.sm_count(cuda), "residual" if residual else "backward")
    lib = build.load_library()
    entry = lib.edrl_layer_norm_bwd_residual if residual else lib.edrl_layer_norm_bwd
    dx, dgb = torch.empty_like(x), torch.empty((2, c), device=cuda)
    head = (x.data_ptr(), dy.data_ptr()) + (() if res is None else (res.data_ptr(),))
    for parts in (plan.partials - 1, plan.partials + 1):
        partial = torch.empty((2, parts, c), device=cuda)
        assert entry(*head, gamma.data_ptr(), dx.data_ptr(), dgb.data_ptr(), partial.data_ptr(), m, c, parts,
                     1e-6, 1, torch.cuda.current_stream(cuda).cuda_stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 384, 768, 1152, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernels_do_not_spill_and_fit_the_plan(cuda, c, dtype):
    """Each row kernel keeps to its registers (no local memory) and as many
    CTAs fit on an SM as the plan's waves count on."""
    import ctypes

    from edrl_tpu_torch.kernels import build

    lib, occ = build.load_library(), (ctypes.c_int * 5)()
    bf16 = int(dtype == torch.bfloat16)
    for kind, query in (("forward", lambda: lib.edrl_layer_norm_fwd_occupancy(c, bf16, occ)),
                        ("backward", lambda: lib.edrl_layer_norm_bwd_occupancy(c, bf16, 0, occ)),
                        ("residual", lambda: lib.edrl_layer_norm_bwd_occupancy(c, bf16, 1, occ))):
        assert query() == 0
        plan = ln.layer_norm_plan(10 ** 6, c, dtype, 1, kind)
        assert occ[4] == 0, (kind, c, dtype, "spills", occ[4])
        assert occ[1] == plan.threads_per_row * plan.rows_per_cta
        waves = plan.ctas if kind == "forward" else ln.layer_norm_plan(10 ** 7, c, dtype, 1, kind).ctas
        assert occ[0] >= waves, (kind, c, dtype, occ[0], waves)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_bwd_makes_two_launches(cuda, residual):
    x, gamma, _, dy = _ln_inputs(cuda, 18432, 512, torch.bfloat16, 8)
    if residual:
        res, dy = dy, dy.float()
        fn = lambda: ln.layer_norm_bwd_residual_kernel(x, dy, gamma, res)  # noqa: E731
    else:
        fn = lambda: ln.layer_norm_bwd_kernel(x, dy, gamma)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2 and "layer_norm_bwd_kernel" in names[0] and "layer_norm_bwd_sums_kernel" in names[1], names


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
# dbias 1e-4 against B2's plain backward on the same inputs.  B6's dbias: in
# f32 both paths compute do with the same torch.matmul, 1e-4; in bf16 the
# kernel path's do is its own wgmma product, whose f32 sums run in another
# order, so a few of its elements round to the other bf16 neighbour and
# dbias (an f32 sum of B2's dS over the batch) moves with them: held at
# sublayer_dbias.DBIAS_BAR against the plain backward, and at 1e-4 against
# B2's plain backward on the kernel path's own do.
# ---------------------------------------------------------------------------

from edrl_tpu_torch.kernels import block_attention as ba  # noqa: E402
from edrl_tpu_torch.models import swin2d  # noqa: E402
from edrl_tpu_torch.tools import sublayer_dbias as sd  # noqa: E402


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
    dbias_bar = sd.DBIAS_BAR if dtype == torch.bfloat16 else 1e-4
    for i, (g, w_) in enumerate(zip(grads, plain)):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert _rel_err(g, w_) <= (dbias_bar if i == 7 else _bwd_bar(dtype)), i
    if dtype == torch.bfloat16:
        assert sd.readings(grads[7], plain[7], qkv, wproj, bias, dy, heads, scale)["kernel_do"] <= sd.KERNEL_DO_BAR


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
    assert ba.LAUNCHES == {ba.ATTENTION_SUBLAYER: 1, ba.ATTENTION_SUBLAYER_BWD: 2}
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


# v1's bar is the one above (1e-2 of the largest magnitude), not the
# forwards' atol 3e-2: at the batch-32 shape with an unscaled q (a sharp
# softmax, o close to one key's v) some |o| reach 4, where one bf16 ulp is
# 2^-5 = 3.125e-2, and the kernel's o (p rounded to bf16 before p v) and the
# plain version's (f32 p) round to neighbours now and then.  Every element
# lies within 3e-2 or one bf16 ulp of the plain value.
@pytest.mark.cuda
def test_v1_fwd_at_the_batch32_shape_within_one_bf16_ulp(cuda):
    gen = torch.Generator(device=cuda).manual_seed(17)
    b, w, h, n, d = 32, 16, 2, 144, 128
    q, k, v = (torch.randn((b, w, h, n, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    bias = torch.randn((w, h, n, n), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    got = wa.window_attention_v1_fwd_kernel(q, k, v, bias).float()
    want = wa.window_attention_reference(q, k, v, bias).float()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    assert ((got - want).abs() <= ulp.clamp_min(3e-2)).all()
    assert _rel_err(got, want) <= _bwd_bar(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,h,n,d", [(32, 16, 2, 144, 128), (3, 2, 3, 17, 24), (2, 3, 2, 225, 32)])
def test_v1_kernels_match_plain_and_repeat_bit_for_bit(cuda, dtype, b, w, h, n, d):
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, k, v, do = (torch.randn((b, w, h, n, d), generator=gen, device=cuda).to(dtype) for _ in range(4))
    bias = torch.randn((w, h, n, n), generator=gen, device=cuda)
    bias[..., 1::3] = -1e9
    route = wa.attention_fwd_route(dtype, n, d)
    wa.reset_launch_counts()
    out = wa.window_attention_v1_fwd_kernel(q, k, v, bias)
    grads = wa.window_attention_v1_bwd_kernel(q, k, v, bias, do)
    assert wa.FWD_ROUTES[route] == 1 and wa.BWD_ROUTES[wa.attention_bwd_route(dtype, n, d)] == 1
    assert _rel_err(out, wa.window_attention_reference(q, k, v, bias)) <= _bwd_bar(dtype)
    want = wa.window_attention_bwd_reference(q, k, v, bias, do)
    for g, w_, bar in zip(grads, want, (_bwd_bar(dtype),) * 3 + (1e-4,)):
        assert g.dtype == w_.dtype and _rel_err(g, w_) <= bar
    again = wa.window_attention_v1_bwd_kernel(q, k, v, bias, do)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


# The wgmma route of B6 (bf16): the forward's products and the backward's
# Dense layers on hopper_gemm.cuh, and B4's residual LayerNorm backward, at
# every shape of the batch-32 train step (Swin stages with Wb = 1 and Wb = W,
# the ViT) and at ragged M.  The bars above: 1e-2 (dgamma and dbeta too: they
# sum dxln, which carries B2's bf16 dqkv), dbias as above; weight and bias
# gradients the same bit for bit over two launches.
SUBLAYER_MAIN_PATH = [(32, 64, 144, 128, 1, 1), (32, 64, 144, 128, 1, 64), (32, 16, 144, 256, 2, 1),
                      (32, 16, 144, 256, 2, 16), (32, 4, 144, 512, 4, 1), (32, 4, 144, 512, 4, 4),
                      (32, 1, 144, 1024, 8, 1), (32, 1, 216, 768, 6, 1)]
SUBLAYER_RAGGED = [(3, 2, 40, 128, 8, 2), (2, 3, 16, 256, 4, 1), (1, 1, 7, 384, 3, 1), (5, 3, 49, 512, 4, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,n,c,heads,wb", SUBLAYER_MAIN_PATH + SUBLAYER_RAGGED)
def test_attention_sublayer_wgmma_route_matches_plain(cuda, b, w, n, c, heads, wb):
    args = _sublayer_inputs(cuda, b, w, n, c, heads, wb, torch.bfloat16, 15)
    scale = (c // heads) ** -0.5
    for module in (ba, ln, wa):
        module.reset_launch_counts()
    got = ba.attention_sublayer_fwd_kernel(*args, heads, scale)
    assert ba.SUBLAYER_ROUTES == {"wgmma": 1, "fma": 0}
    for g, w_ in zip(got, ba.attention_sublayer_reference(*args, heads, scale)):
        assert g.dtype == torch.bfloat16 and _rel_err(g, w_) <= 1e-2
    x, gamma, _, wqkv, _, wproj, _, bias = args
    y, qkv, xln = got
    dy = torch.randn(y.shape, generator=torch.Generator(device=cuda).manual_seed(16), device=cuda).bfloat16()
    res = (x, xln, qkv, gamma, wqkv, wproj, bias, dy, heads, scale)
    grads = ba.attention_sublayer_bwd_kernel(*res)
    again = ba.attention_sublayer_bwd_kernel(*res)
    assert ba.LAUNCHES == {ba.ATTENTION_SUBLAYER: 1, ba.ATTENTION_SUBLAYER_BWD: 4}
    assert ba.SUBLAYER_ROUTES == {"wgmma": 5, "fma": 0}
    assert ln.LAUNCHES[ln.LAYER_NORM_BWD] == 2 and ln.LAUNCHES[ln.LAYER_NORM] == 0
    assert wa.LAUNCHES[wa.WINDOW_ATTENTION_V2] == wa.LAUNCHES[wa.WINDOW_ATTENTION_V2_BWD] == 2
    for g, a in zip(grads[1:], again[1:]):
        assert torch.equal(g, a)  # fixed-order sums over M
    plain = ba.attention_sublayer_bwd_reference(*res)
    for i, (g, w_) in enumerate(zip(grads, plain)):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert _rel_err(g, w_) <= (sd.DBIAS_BAR if i == 7 else 1e-2), i
    assert sd.readings(grads[7], plain[7], qkv, wproj, bias, dy, heads, scale)["kernel_do"] <= sd.KERNEL_DO_BAR


@pytest.mark.cuda
def test_attention_sublayer_route_mirrors_the_entry_point(cuda):
    """attention_sublayer_route (Python) picks what edrl_attention_sublayer_route (C) picks."""
    from edrl_tpu_torch.kernels import build

    lib = build.load_library()
    for dtype in (torch.bfloat16, torch.float32):
        for c in (0, 128, 200, 256, 384, 768, 1024, 2048, 2176):
            for heads in (0, 1, 2, 3, 6, 8, 16, 32):
                got = lib.edrl_attention_sublayer_route(int(dtype == torch.bfloat16), c, heads)
                assert {1: "wgmma", 0: "fma", -1: None}[got] == ba.attention_sublayer_route(dtype, c, heads), (
                    dtype, c, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "fma")])
def test_attention_sublayer_counts_its_routes(cuda, dtype, route):
    """Through autograd: one forward launch, and in bf16 two backward ones,
    each under its route; the LayerNorm backward is B4's kernel."""
    args = list(_sublayer_inputs(cuda, 2, 4, 144, 128, 1, 1, dtype, 18))
    leaves = [a.requires_grad_() for a in args]
    for module in (ba, ln):
        module.reset_launch_counts()
    ba.attention_sublayer_fused(*leaves, 1, 128 ** -0.5).float().sum().backward()
    bwd = 2 if route == "wgmma" else 0
    assert ba.LAUNCHES == {ba.ATTENTION_SUBLAYER: 1, ba.ATTENTION_SUBLAYER_BWD: bwd}
    assert ba.SUBLAYER_ROUTES == {"wgmma": (1 + bwd) * (route == "wgmma"), "fma": int(route == "fma")}
    assert ln.LAUNCHES == {ln.LAYER_NORM: 0, ln.LAYER_NORM_BWD: 1}
    assert all(torch.isfinite(a.grad).all() for a in leaves)


# -- The serving half: the forward kernels as operators (export), the int8
# products, the chunk graph. ---------------------------------------------------

from edrl_tpu_torch.ops import quantization as quant  # noqa: E402


def _operator_cases(cuda):
    """Each forward operator, its plain version and bf16 inputs at a serving shape."""
    gen = torch.Generator(device=cuda).manual_seed(20)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=cuda)).to(dtype)

    f32 = torch.float32
    bias = randn(16, 2, 144, 144, dtype=f32)
    return {
        "self_attention_fwd": (wa.self_attention_fwd, wa.self_attention_reference,
                               (randn(4, 216, 768), randn(4, 216, 768), randn(4, 216, 768), 6, 128 ** -0.5)),
        "window_attention_v2_fwd": (wa.window_attention_v2_fwd, wa.window_attention_v2_reference,
                                    (randn(2, 16, 144, 768), bias, 2, 128 ** -0.5)),
        "layer_norm_fwd": (ln.layer_norm_fwd, ln.layer_norm_reference,
                           (randn(512, 768), randn(768, dtype=f32), randn(768, dtype=f32), 1e-6)),
        "fused_mlp_fwd": (fm.fused_mlp_fwd, fm.fused_mlp_reference,
                          (randn(512, 256), randn(256, 1024, scale=256 ** -0.5), randn(1024, dtype=f32),
                           randn(1024, 256, scale=1024 ** -0.5), randn(256, dtype=f32))),
        "attention_sublayer_fwd": (ba.attention_sublayer_fwd, ba.attention_sublayer_reference,
                                   (*_sublayer_inputs(cuda, 2, 4, 144, 128, 1, 1, torch.bfloat16, 21), 1,
                                    128 ** -0.5)),
    }


def _all_launches():
    return sum(sum(m.LAUNCHES.values()) for m in (wa, ln, fm, ba, kmmd))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["self_attention_fwd", "window_attention_v2_fwd", "layer_norm_fwd", "fused_mlp_fwd",
                                  "attention_sublayer_fwd"])
def test_forward_operator_launches_its_kernel(cuda, name):
    """The operator's CUDA implementation is the kernel: one launch, the
    plain version's result at the bf16 bar."""
    op, reference, args = _operator_cases(cuda)[name]
    before = _all_launches()
    got = op(*args)
    torch.cuda.synchronize()
    assert _all_launches() == before + 1
    want = reference(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape and _rel_err(g, w) <= _bwd_bar(torch.bfloat16)


@pytest.mark.cuda
def test_int_mm_pads_sixteen_rows(cuda):
    """The card's torch._int_mm refuses M = 16 (the serving batch's per-sample
    Dense layers); int8_matmul pads to 17 rows and stays exact."""
    gen = torch.Generator(device=cuda).manual_seed(30)
    x = torch.randint(-127, 128, (16, 1024), generator=gen, device=cuda, dtype=torch.int8)
    w = torch.randint(-127, 128, (512, 1024), generator=gen, device=cuda, dtype=torch.int8)
    with pytest.raises(RuntimeError):
        torch._int_mm(x, w.t())
    quant.reset_launch_counts()
    got = quant.int8_matmul(x, w)
    assert got.dtype == torch.int32 and got.shape == (16, 512)
    # Exact in f64: |sum| <= 1024 * 127^2 < 2^53.
    assert torch.equal(got.double(), x.double() @ w.double().t())
    assert quant.INT8_MATMULS == {quant.INT_MM: 1, quant.INT_MM_PADDED: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_chunk_graph_replays_the_eager_forward(cuda, int8):
    """13 pairs at batch 4 in chunks of 3: one graph replay and one eager
    batch, equal to the per-batch forward at 1e-6; B2's launches (2 a
    forward at the tiny config) count the warm-up, the replay and the tail."""
    import dataclasses

    import numpy as np

    from edrl_tpu_torch.config import tiny_test_config
    from edrl_tpu_torch.serve.predictor import Predictor

    cfg = tiny_test_config(4)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_fused_attention=True))
    rng = np.random.default_rng(31)
    d = cfg.data
    f = rng.integers(0, 256, (13, d.fundus_size, d.fundus_size, 3), dtype=np.uint8)
    o = rng.integers(0, 256, (13, *d.oct_size, 1), dtype=np.uint8)
    kw = dict(device="cuda", quantize_int8=int8, min_dim=32)
    per_batch = Predictor(cfg, **kw).predict_probs(f, o)
    pred = Predictor(cfg, chunk_batches=3, **kw)
    wa.reset_launch_counts()
    got = pred.predict_probs(f, o)
    assert pred.chunk_graph is not None and pred.chunk_graph.replays == 1
    np.testing.assert_allclose(got, per_batch, atol=1e-6, rtol=0)
    assert wa.LAUNCHES[wa.WINDOW_ATTENTION_V2] == 2 * (3 + 3 + 1)
    assert pred.chunk_graph.launches[0][wa.WINDOW_ATTENTION_V2] == 6
