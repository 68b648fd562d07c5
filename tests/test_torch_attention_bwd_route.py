"""The attention backward's route choice, on the CPU.

``attention_bwd_route`` mirrors the choice the C entry points make before a
launch (``csrc/attention_bwd.cuh``, ``attention_bwd_route_wgmma``): bf16 with
head_dim % 16 == 0 and N <= 224 takes TMA and ``wgmma`` on the tensor cores
("wgmma"), everything else the CUDA cores ("fma").  ``tests/test_torch_cuda.py``
holds the Python choice to the C one on a card.
"""

import pytest
import torch

from edrl_tpu_torch.kernels import window_attention as wa

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,n,d,route", [
    # Main-path shapes: B1 (ViT-3D, N = 216), B2 (Swin, N = 144), B2 under
    # the fused attention sublayer (N = 216), all head_dim 128.
    (BF16, 216, 128, "wgmma"),
    (BF16, 144, 128, "wgmma"),
    # The f32 step takes the CUDA cores at the same shapes.
    (F32, 216, 128, "fma"),
    (F32, 144, 128, "fma"),
    # Edges: the tensor cores take N <= 224 and head_dim % 16 == 0.
    (BF16, 224, 128, "wgmma"),
    (BF16, 225, 128, "fma"),
    (BF16, 256, 128, "fma"),
    (BF16, 1, 128, "wgmma"),
    (BF16, 17, 32, "wgmma"),
    (BF16, 145, 128, "wgmma"),
    (BF16, 16, 16, "wgmma"),
    (BF16, 16, 8, "fma"),
    (BF16, 40, 24, "fma"),
    (F32, 16, 16, "fma"),
    (F32, 1, 128, "fma"),
])
def test_route_at_main_path_shapes_and_edges(dtype, n, d, route):
    assert wa.attention_bwd_route(dtype, n, d) == route


def test_route_boundary_is_the_forwards():
    """The wgmma backward takes N up to 224, as the wgmma forward does; 224 <
    N <= 256 stays on the CUDA cores."""
    assert wa.WGMMA_MAX_TOKENS == 224 <= wa.MAX_BWD_TOKENS
    assert all(wa.attention_bwd_route(BF16, n, 128) == "wgmma" for n in range(1, 225))
    assert all(wa.attention_bwd_route(BF16, n, 128) == "fma" for n in range(225, wa.MAX_BWD_TOKENS + 1))


def test_route_counts_reset_with_the_launch_counts():
    wa.BWD_ROUTES["wgmma"] = 3
    wa.BWD_ROUTES["fma"] = 1
    wa.reset_launch_counts()
    assert wa.BWD_ROUTES == {"wgmma": 0, "fma": 0}


def test_cpu_backward_counts_no_route(rng):
    """A CPU tensor takes the plain backward: no launch, no route counted."""
    wa.reset_launch_counts()
    q = torch.tensor(rng.normal(size=(2, 16, 32)), dtype=torch.float32, requires_grad=True)
    wa.self_attention_fused(q, q, q, 2, 0.25).sum().backward()
    qkv = torch.tensor(rng.normal(size=(2, 2, 16, 96)), dtype=torch.float32, requires_grad=True)
    bias = torch.zeros((2, 2, 16, 16), requires_grad=True)
    wa.window_attention_fused_v2(qkv, bias, 2, 0.25).sum().backward()
    assert wa.BWD_ROUTES == {"wgmma": 0, "fma": 0}


@pytest.mark.parametrize("route,copied", [("wgmma", True), ("fma", False)])
def test_misaligned_view_is_copied_for_the_tensor_cores(route, copied):
    """The wgmma route reads rows by TMA: a view off a 16-byte boundary is
    copied (same values), an aligned one is passed as is."""
    base = torch.arange(4 * 16 * 33, dtype=torch.bfloat16).reshape(-1)
    odd = base[1:1 + 4 * 16 * 32].view(4, 16, 32)  # starts 2 bytes in
    aligned = base[:4 * 16 * 32].view(4, 16, 32)
    assert odd.data_ptr() % 16 != 0 and aligned.data_ptr() % 16 == 0
    got_odd, got_aligned = wa._aligned_operands(route, (odd, aligned))
    assert (got_odd.data_ptr() != odd.data_ptr()) == copied
    assert got_odd.data_ptr() % 16 == 0 or not copied
    assert torch.equal(got_odd, odd)
    assert got_aligned.data_ptr() == aligned.data_ptr()


@pytest.mark.parametrize("b,base,slots,want", [
    # The four Swin stages of a batch-32 step on 132 SMs at 2 dq blocks per SM:
    # 64 windows x 3 query tiles, 16 x 2 x 3, 4 x 4 x 3, 1 x 8 x 3.
    # Each takes 24, 12, 6 and 3 entries' time, as one entry per block would;
    # ties go to the fewest chunks.
    (32, 192, 264, (8, 4)),
    (32, 96, 264, (4, 8)),
    (32, 48, 264, (3, 11)),
    (32, 24, 264, (3, 11)),
    # One batch entry; a grid far below the card's slots (one entry per block).
    (1, 192, 264, (1, 1)),
    (4, 2, 264, (1, 4)),
])
def test_dbias_chunking(b, base, slots, want):
    per_block, chunks = wa.dbias_chunking(b, base, slots)
    assert (per_block, chunks) == want
    assert chunks == -(-b // per_block)


def test_dbias_chunking_is_never_slower_than_one_entry_per_block():
    for b in (1, 3, 16, 32, 33):
        for base in (1, 24, 100, 192, 500):
            per_block, chunks = wa.dbias_chunking(b, base, 264)
            assert -(-base * chunks // 264) * per_block <= -(-base * b // 264)


@pytest.mark.parametrize("b,base,slots,windows,heads,want", [
    # The wgmma rows kernel at one CTA an SM (132 slots) over the Swin stages
    # of a batch-32 step at N = 144 (3 query tiles): stage 0's 32 chunks of
    # 5.3 MB partials would cost more than the one entry they save.
    (32, 192, 132, 64, 1, (16, 2)),
    (32, 96, 132, 16, 2, (8, 4)),
    (32, 48, 132, 4, 4, (4, 8)),
    (32, 24, 132, 1, 8, (3, 11)),
])
def test_dbias_chunking_counts_the_partials(b, base, slots, windows, heads, want):
    cost = wa.dbias_chunk_cost("wgmma", windows, heads, 144, 128, slots)
    assert wa.dbias_chunking(b, base, slots, cost) == want
    assert wa.dbias_chunk_cost("fma", windows, heads, 144, 128, slots) == 0.0
