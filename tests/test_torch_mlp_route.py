"""B5's route mirror and the wgmma route's planning, on the CPU.

The C entry points pick the route of a fused-MLP call (``"wgmma"`` for bf16
u, ``"mma"`` for f32 u); ``fused_mlp.fused_mlp_route`` mirrors the choice,
and ``tests/test_torch_cuda.py`` holds the two equal on a card.  Here: the
mirror at admitted and refused shapes, the weight-gradient split planner
against hand-counted plans for the five main-path shapes and its invariants,
the logistic form of the tanh GELU that the wgmma route's epilogues use
(against the plain versions' tanh form, at f32 rounding: 2e-6 of the largest
magnitude), and the CPU path counting no launch.
"""

import numpy as np
import pytest
import torch

from edrl_tpu_torch.kernels import fused_mlp as fm

# The batch-32 train step's B5 shapes (M, C, H): Swin stages 0-2, the ViT, Swin stage 3.
MAIN_PATH = [(294912, 128, 512), (73728, 256, 1024), (18432, 512, 2048), (6912, 768, 3072), (4608, 1024, 4096)]


@pytest.mark.parametrize("c,h", [(128, 512), (256, 1024), (512, 2048), (768, 3072), (1024, 4096), (128, 128),
                                 (1024, 128)])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "mma")])
def test_route_at_admitted_shapes(dtype, route, c, h):
    assert fm.fused_mlp_route(dtype, c, h) == route


@pytest.mark.parametrize("c,h", [(200, 512), (1152, 4608), (0, 512), (128, 96), (128, 0), (2048, 8192)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_refuses_other_shapes(dtype, c, h):
    assert fm.fused_mlp_route(dtype, c, h) is None


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_route_refuses_other_dtypes(dtype):
    assert fm.fused_mlp_route(dtype, 768, 3072) is None


# Hand-counted on 132 SMs (264 CTA slots): tiles = (C / 128) * (H / 128);
# stages of 64 rows at 0.85 us per wave; partials (2 s + 1) * C * H * 4
# bytes at 3 TB/s.  Stage 3: 256 tiles fill one wave unsplit.  ViT: 144
# tiles, 3 splits of 2304 rows -> 432 tiles, 2 waves x 36 stages = 61.2 us
# + 22.0 us of partials, against 91.8 us unsplit and 107.5 for 2 splits.
@pytest.mark.parametrize("shape,want", zip(MAIN_PATH, [(66, 4480), (16, 4608), (4, 4608), (3, 2304), (1, 4608)]))
def test_wgrad_splits_at_the_main_path_shapes(shape, want):
    assert fm.wgmma_wgrad_splits(*shape, 132) == want


@pytest.mark.parametrize("m", [1, 37, 63, 64, 300, 2000, 6912, 294912])
@pytest.mark.parametrize("c,h", [(128, 512), (768, 3072), (1024, 4096)])
def test_wgrad_splits_cover_m_in_whole_ring_stages(m, c, h):
    splits, chunk = fm.wgmma_wgrad_splits(m, c, h, 132)
    assert chunk % 64 == 0 and chunk >= 64
    assert splits * chunk >= m > (splits - 1) * chunk  # no empty split
    assert splits == 1 or chunk >= 256


def test_wgrad_splits_of_the_mma_route_are_unchanged():
    # The mma.sync route keeps its plan: >= 4 blocks per SM, chunks a multiple of 32.
    assert fm._wgrad_splits(6912, 768, 3072, 132) == (4, 1728)
    assert fm._wgrad_splits(4608, 1024, 4096, 132) == (3, 1536)


def _gelu_logistic(x):
    """The wgmma route's GELU (csrc/fused_mlp.cuh, gelu_logistic): x / (1 + exp(-2y))."""
    y = fm._SQRT_2_OVER_PI * (x + fm._GELU_C * x * x * x)
    s = 1.0 / (1.0 + torch.exp(-2.0 * y))
    return x * s, s + 2.0 * x * s * (1.0 - s) * fm._SQRT_2_OVER_PI * (1.0 + 3.0 * fm._GELU_C * x * x)


@pytest.mark.parametrize("scale", [0.01, 1.0, 8.0, 60.0])
def test_logistic_gelu_is_the_tanh_gelu(scale):
    x = torch.tensor(np.random.default_rng(3).normal(size=4096) * scale, dtype=torch.float32)
    act, grad = _gelu_logistic(x)
    for got, want in ((act, fm._gelu(x)), (grad, fm._gelu_grad(x))):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2e-6 * want.abs().max()


def test_cpu_path_counts_no_launch_and_no_route():
    rng = np.random.default_rng(4)
    u = torch.tensor(rng.normal(size=(37, 128)), dtype=torch.bfloat16, requires_grad=True)
    w1, w2 = (torch.tensor(rng.normal(size=s) * 0.1, dtype=torch.float32, requires_grad=True)
              for s in ((128, 256), (256, 128)))
    b1, b2 = torch.zeros(256, requires_grad=True), torch.zeros(128, requires_grad=True)
    fm.reset_launch_counts()
    fm.fused_mlp(u, w1, b1, w2, b2).float().sum().backward()
    assert fm.LAUNCHES == {fm.FUSED_MLP: 0, fm.FUSED_MLP_BWD: 0}
    assert fm.MLP_ROUTES == {"wgmma": 0, "mma": 0}


def test_reset_clears_the_route_counts():
    fm.MLP_ROUTES["wgmma"] = 3
    fm.LAUNCHES[fm.FUSED_MLP] = 2
    fm.reset_launch_counts()
    assert fm.MLP_ROUTES == {"wgmma": 0, "mma": 0} and fm.LAUNCHES[fm.FUSED_MLP] == 0
