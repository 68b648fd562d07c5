"""The port's measurement tools: their CPU-side arithmetic, and their refusal
to measure without a card."""

import pytest
import torch

from edrl_tpu_torch.tools import profile_train_step as pts


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),        # overlapping
    ([(5.0, 6.0), (0.0, 1.0)], 2.0),        # disjoint, unsorted
    ([(0.0, 10.0), (2.0, 3.0)], 10.0),      # nested
])
def test_union_of_kernel_intervals(spans, want):
    assert pts._union_us(spans) == want


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::attention_bwd_dq_kernel<__nv_bfloat16>(AttnBwdParams)",
     "attention kernels (B1/B2 bwd)"),
    ("void (anonymous namespace)::attention_fwd_mma_kernel<18>(AttnParams)", "attention kernels (B1/B2 fwd)"),
    ("nvjet_tst_128x160_64x5_2x1_v_bz_coopA_bias_TNT", "GEMM (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda>", "copies and casts"),
    ("void (anonymous namespace)::layer_norm_fwd_kernel<__nv_bfloat16, 1>(const T1 *, const float *)",
     "LayerNorm kernels (B4 fwd/bwd)"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float>", "LayerNorm"),
    ("void (anonymous namespace)::mlp_wgrad_kernel<__nv_bfloat16, __nv_bfloat16>(const T1 *)",
     "MLP kernels (B5 fwd/bwd, weight preps)"),
    ("void (anonymous namespace)::fused_mlp_fwd_kernel<__nv_bfloat16, 32, 2>(MlpFwdParams)",
     "MLP kernels (B5 fwd/bwd, weight preps)"),
    ("void (anonymous namespace)::column_sum_kernel(const float *, float *, int, int)", "partial sums (dbias, B4, B5)"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_categories(name, want):
    assert pts._category(name) == want


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        pts.main([])
