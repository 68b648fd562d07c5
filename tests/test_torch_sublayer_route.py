"""B6's route mirror and its backward's planning, on the CPU.

The C entry points pick the route of a fused attention-sublayer call
(``"wgmma"`` for bf16 x: the products on the wgmma mainloop, forward and
backward; ``"fma"`` for f32 x); ``block_attention.attention_sublayer_route``
mirrors the choice, and ``tests/test_torch_cuda.py`` holds the two equal on
a card.  Here: the mirror at admitted and refused shapes and dtypes, the
bf16 backward's weight-gradient split plans (``fused_mlp.wgmma_wgrad_splits``,
B5's planner) for both Dense layers of the sublayer at the five main-path
shapes against hand-counted plans, the bias gradients' partial blocks, the
CPU path counting no launch and no route, and the reset.
"""

import numpy as np
import pytest
import torch

from edrl_tpu_torch.kernels import block_attention as ba
from edrl_tpu_torch.kernels.fused_mlp import wgmma_wgrad_splits

# The batch-32 train step's B6 shapes: (M = B * W * N, C, heads) of Swin
# stages 0-3 and the ViT.
MAIN_PATH = [(294912, 128, 1), (73728, 256, 2), (18432, 512, 4), (4608, 1024, 8), (6912, 768, 6)]


@pytest.mark.parametrize("c,heads", [(c, h) for _, c, h in MAIN_PATH] + [(128, 16), (2048, 16), (384, 3)])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "fma")])
def test_route_at_admitted_shapes(dtype, route, c, heads):
    assert ba.attention_sublayer_route(dtype, c, heads) == route


@pytest.mark.parametrize("c,heads", [(200, 2), (2176, 17), (0, 1), (256, 1), (128, 32), (384, 5), (128, 0),
                                     (2304, 18)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_refuses_other_shapes(dtype, c, heads):
    # 256 / 1: head dim over 128; 128 / 32: head dim 4; 384 / 5 does not split.
    assert ba.attention_sublayer_route(dtype, c, heads) is None


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_route_refuses_other_dtypes(dtype):
    assert ba.attention_sublayer_route(dtype, 768, 6) is None


# Hand-counted on 132 SMs (264 CTA slots): tiles = (C / 128) * (Q / 128),
# stages of 64 rows at 0.85 us per wave, partials (2 s + 1) * C * Q * 4
# bytes at 3 TB/s.  The proj layer (Q = C): Swin stage 0's one tile takes
# 256 splits of 1152 rows (294912 / 264 rounds up to 1152, 256 splits, one
# wave: 18 stages = 15.3 us + 11.2 us of partials; 272 splits of 1088 would
# take two waves); stage 1's 4 tiles 64 splits of 1152; stage 2's 16 tiles
# 16 of 1152; stage 3's 64 tiles 4 of 1152; the ViT's 36 tiles 7 of 1024
# (252 CTAs, 16 stages).  The qkv layer (Q = 3C): 3 tiles x 87 splits of 3392
# rows (261 CTAs, 53 stages = 45.1 us + 11.5 us); 12 x 22 of 3392; 48 x 5 of
# 3712 (240 CTAs, 58 stages); stage 3's 192 tiles fill one wave unsplit (78
# stages = 61.2 us; 2 splits would take two waves of 36 stages and 4.8 MB of
# partials); the ViT's 108 tiles 2 splits of 3456 (216 CTAs, 54 stages).
PLANS = {
    (294912, 128): ((256, 1152), (87, 3392)),
    (73728, 256): ((64, 1152), (22, 3392)),
    (18432, 512): ((16, 1152), (5, 3712)),
    (4608, 1024): ((4, 1152), (1, 4608)),
    (6912, 768): ((7, 1024), (2, 3456)),
}


@pytest.mark.parametrize("m,c,heads", MAIN_PATH)
def test_wgrad_splits_at_the_main_path_shapes(m, c, heads):
    proj, qkv = PLANS[(m, c)]
    assert wgmma_wgrad_splits(m, c, c, 132) == proj
    assert wgmma_wgrad_splits(m, c, 3 * c, 132) == qkv


@pytest.mark.parametrize("m,want", [(294912, 1152), (73728, 320), (18432, 128), (6912, 64), (4608, 64), (1, 64),
                                    (16384, 64), (16385, 128)])
def test_bias_gradient_partials(m, want):
    """Blocks of a multiple of 64 rows, at most 256 partials per column."""
    rows = ba.bias_grad_rows(m)
    assert rows == want
    assert -(-m // rows) <= 256 and (rows == 64 or -(-m // (rows - 64)) > 256)


def _inputs(rng, dtype):
    b, w, n, c, heads = 2, 2, 16, 128, 2

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale)

    args = [t(b, w, n, c).to(dtype), 1 + t(c, scale=0.1), t(c, scale=0.1), t(c, 3 * c, scale=c ** -0.5).to(dtype),
            t(3 * c, scale=0.1), t(c, c, scale=c ** -0.5).to(dtype), t(c, scale=0.1), t(1, heads, n, n)]
    return [a.requires_grad_() for a in args], heads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_path_counts_no_launch_and_no_route(dtype):
    args, heads = _inputs(np.random.default_rng(5), dtype)
    ba.reset_launch_counts()
    ba.attention_sublayer_fused(*args, heads, 0.25).float().sum().backward()
    assert all(a.grad is not None for a in args)
    assert ba.LAUNCHES == {ba.ATTENTION_SUBLAYER: 0, ba.ATTENTION_SUBLAYER_BWD: 0}
    assert ba.SUBLAYER_ROUTES == {"wgmma": 0, "fma": 0}


def test_reset_clears_the_route_counts():
    ba.SUBLAYER_ROUTES["wgmma"] = 3
    ba.SUBLAYER_ROUTES["fma"] = 1
    ba.LAUNCHES[ba.ATTENTION_SUBLAYER_BWD] = 2
    ba.reset_launch_counts()
    assert ba.SUBLAYER_ROUTES == {"wgmma": 0, "fma": 0}
    assert ba.LAUNCHES == {ba.ATTENTION_SUBLAYER: 0, ba.ATTENTION_SUBLAYER_BWD: 0}


def test_backward_on_the_cpu_refuses_the_kernel_wrapper():
    """The card's backward wrapper takes CUDA tensors only: a CPU tensor
    raises instead of running a plain version."""
    args, heads = _inputs(np.random.default_rng(6), torch.bfloat16)
    x, gamma, _, wqkv, _, wproj, _, bias = (a.detach() for a in args)
    with pytest.raises(ValueError, match="CUDA"):
        ba.attention_sublayer_bwd_kernel(x, x, x, gamma, wqkv, wproj, bias, x, heads, 0.25)
