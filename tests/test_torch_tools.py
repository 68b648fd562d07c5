"""The port's measurement tools: their CPU-side arithmetic, and their refusal
to measure without a card."""

import numpy as np
import pytest
import torch

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.tools import profile_data_parallel as pdp
from edrl_tpu_torch.tools import profile_layer_norm as pln
from edrl_tpu_torch.tools import profile_sublayer as psl
from edrl_tpu_torch.tools import sublayer_dbias as sd
from edrl_tpu_torch.tools import profile_train_step as pts
from edrl_tpu_torch.tools import profile_v1_mmd as pv


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
    ("void (anonymous namespace)::layer_norm_fwd_kernel<__nv_bfloat16, 128>(const T1 *, const float *)",
     "LayerNorm kernels (B4 fwd/bwd)"),
    ("void (anonymous namespace)::layer_norm_bwd_sums_kernel(const float4 *, float4 *, int, int)",
     "LayerNorm kernels (B4 fwd/bwd)"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float>", "LayerNorm"),
    ("void (anonymous namespace)::mlp_wgrad_kernel<__nv_bfloat16, __nv_bfloat16>(const T1 *)",
     "B5 or B6 products (wgmma, mma.sync, f32), weight preps"),
    ("void (anonymous namespace)::fused_mlp_fwd_kernel<__nv_bfloat16, 32, 2>(MlpFwdParams)",
     "B5 or B6 products (wgmma, mma.sync, f32), weight preps"),
    ("void (anonymous namespace)::wgmma_gemm_kernel<(anonymous namespace)::GeluEpilogue, 128, false, true, 3, 2>"
     "(CUtensorMap, CUtensorMap, (anonymous namespace)::GeluEpilogue, (anonymous namespace)::TileGrid)",
     "B5 or B6 products (wgmma, mma.sync, f32), weight preps"),
    ("void (anonymous namespace)::mlp_fwd_fused_wgmma_kernel<256>(CUtensorMap, CUtensorMap, CUtensorMap)",
     "B5 or B6 products (wgmma, mma.sync, f32), weight preps"),
    ("void (anonymous namespace)::mlp_bwd_hidden_wgmma_kernel(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap)",
     "B5 or B6 products (wgmma, mma.sync, f32), weight preps"),
    ("void (anonymous namespace)::col_partials_kernel(const __nv_bfloat16 *, float *, int, int, int)",
     "B5 or B6 products (wgmma, mma.sync, f32), weight preps"),
    ("void (anonymous namespace)::column_sum_kernel(const float *, float *, int, int)",
     "partial sums (dbias, B5, B6)"),
    ("void (anonymous namespace)::column_sum4_kernel<__nv_bfloat16>(const float4 *, T1 *, int, long long)",
     "partial sums (dbias, B5, B6)"),
    ("void (anonymous namespace)::sublayer_gemm_f32_kernel<(anonymous namespace)::F32QkvEpilogue>", "B5 or B6 products (wgmma, mma.sync, f32), weight preps"),
    ("void (anonymous namespace)::wgmma_gemm_kernel<(anonymous namespace)::ResidualEpilogue, 128, false, true, 3, 2>"
     "(CUtensorMap, CUtensorMap, (anonymous namespace)::ResidualEpilogue, (anonymous namespace)::TileGrid)", "B5 or B6 products (wgmma, mma.sync, f32), weight preps"),
    ("void (anonymous namespace)::layer_norm_bwd_kernel<__nv_bfloat16, float, true, 128>(const T1 *, const T2 *)",
     "LayerNorm kernels (B4 fwd/bwd)"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_ndhwckrsc_nhwc_tilesize128x64x32",
     "convolutions (cuDNN), layout changes"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true, (cudnnKernelDataType_t)2>",
     "convolutions (cuDNN), layout changes"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<float, float>", "pooling"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_categories(name, want):
    assert pts._category(name) == want


@pytest.mark.parametrize("argv,flags", [
    ([], dict(use_fused_attention=True, vit_fused_attention=True, use_fused_ln=False, use_fused_mlp=False,
              use_fused_block_attention=False)),
    (["--plain"], dict(use_fused_attention=False, vit_fused_attention=False, use_fused_block_attention=False)),
    (["--fused-ln", "--fused-mlp"], dict(use_fused_ln=True, use_fused_mlp=True, use_fused_block_attention=False)),
    (["--fused-block-attention"], dict(use_fused_block_attention=True, use_fused_ln=False)),
    (["--model_name", "Multi_ResNet"], dict(model_name="Multi_ResNet", use_fused_attention=True)),
])
def test_configuration_flags(argv, flags):
    cfg = pts.config_from_args(pts.parse_args(argv))
    for name, value in flags.items():
        assert getattr(cfg.model, name) == value, name
    assert cfg.data.batch_size == 32 and cfg.model.use_bfloat16


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        pts.main([])


_WGMMA = "void (anonymous namespace)::wgmma_gemm_kernel<(anonymous namespace)::{}, 128, false, {}, 3, 2>"


@pytest.mark.parametrize("name,phases,want", [
    ("void (anonymous namespace)::layer_norm_fwd_kernel<__nv_bfloat16, 128>(const T1 *)", psl.FWD_PHASES,
     "LayerNorm"),
    ("void (anonymous namespace)::transpose_bf16_kernel<__nv_bfloat16>(const T1 *)", psl.FWD_PHASES,
     "weight transposes"),
    ("void (anonymous namespace)::sublayer_gemm_bf16_kernel<(anonymous namespace)::QkvEpilogue<__nv_bfloat16>>",
     psl.FWD_PHASES, "qkv product"),
    (_WGMMA.format("BiasEpilogue", "true"), psl.FWD_PHASES, "qkv product"),
    ("void (anonymous namespace)::attention_fwd_tc_kernel<3>(AttnParams)", psl.FWD_PHASES, "attention"),
    (_WGMMA.format("ResidualEpilogue", "true"), psl.FWD_PHASES, "proj product"),
    ("void (anonymous namespace)::attention_fwd_tc_kernel<7>(AttnParams)", psl.BWD_PHASES,
     "B2 forward (o recomputed)"),
    ("void (anonymous namespace)::attention_bwd_dkv_mma_kernel<true>(AttnBwdParams)", psl.BWD_PHASES, "B2 backward"),
    (_WGMMA.format("StoreEpilogue", "false"), psl.BWD_PHASES, "do and dxln products"),
    (_WGMMA.format("StoreF32Epilogue", "false"), psl.BWD_PHASES, "do and dxln products"),
    (_WGMMA.format("WgradEpilogue", "true"), psl.BWD_PHASES, "weight gradients"),
    ("void (anonymous namespace)::col_partials_kernel(const __nv_bfloat16 *, float *, int, int, int)",
     psl.BWD_PHASES, "bias gradients"),
    ("void (anonymous namespace)::layer_norm_bwd_kernel<__nv_bfloat16, float, true, 128>(const T1 *)", psl.BWD_PHASES,
     "LayerNorm backward (B4)"),
    ("void (anonymous namespace)::layer_norm_bwd_sums_kernel(const float4 *, float4 *, int, int)", psl.BWD_PHASES,
     "LayerNorm backward (B4)"),
    ("void (anonymous namespace)::column_sum_kernel(const float *, float *, int, int)", psl.BWD_PHASES,
     "sums of partials"),
    ("nvjet_tst_128x160_64x5_2x1_v_bz_coopA_bias_TNT", psl.BWD_PHASES, "cuBLAS products"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::float_copy_kernel>", psl.BWD_PHASES,
     "copies and casts"),
    ("some_unknown_kernel", psl.BWD_PHASES, "other"),
])
def test_sublayer_phases(name, phases, want):
    assert psl._phase(name, phases) == want


def test_sublayer_shapes_of_the_train_step():
    """24 B6 calls per forward: Swin (2, 2, 6, 2) blocks, half of each stage
    shifted where the window is smaller than the grid, and 12 ViT blocks."""
    shapes = psl.train_shapes(EDRLConfig())
    got = [(s["b"], s["w"], s["n"], s["c"], s["heads"], s["wb"], s["calls"]) for s in shapes]
    assert got == [(32, 64, 144, 128, 1, 1, 1), (32, 64, 144, 128, 1, 64, 1), (32, 16, 144, 256, 2, 1, 1),
                   (32, 16, 144, 256, 2, 16, 1), (32, 4, 144, 512, 4, 1, 3), (32, 4, 144, 512, 4, 4, 3),
                   (32, 1, 144, 1024, 8, 1, 2), (32, 1, 216, 768, 6, 1, 12)]
    assert sum(s["calls"] for s in shapes) == 24
    assert [(s["grid"], s["window"], s["vit"]) for s in shapes] == [
        (96, 12, False)] * 2 + [(48, 12, False)] * 2 + [(24, 12, False)] * 2 + [(12, 12, False), (None, None, True)]


class _FakeProfile:
    """Stands in for torch.profiler.profile: the events of one kernel, or none."""

    class _Event:
        device_type = torch.autograd.DeviceType.CUDA
        is_user_annotation = False
        name = "void (anonymous namespace)::layer_norm_fwd_kernel<__nv_bfloat16, 1>(const T1 *)"

        class time_range:
            @staticmethod
            def elapsed_us():
                return 20.0

    def __init__(self, recorded):
        self.recorded = recorded

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return [self._Event()] if self.recorded else []


@pytest.mark.parametrize("empty,raises", [(0, False), (2, False), (3, True)])
def test_sublayer_phase_ms_takes_an_empty_profile_again(monkeypatch, empty, raises):
    profiles = iter([False] * empty + [True])
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: _FakeProfile(next(profiles)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    if raises:
        with pytest.raises(SystemExit, match="no device time"):
            psl.phase_ms(lambda: calls.append(1), psl.FWD_PHASES, calls=4)
        return
    assert psl.phase_ms(lambda: calls.append(1), psl.FWD_PHASES, calls=4) == {"LayerNorm": 0.005, "total": 0.005}
    assert len(calls) == 2 + 4 * (empty + 1)


def test_sublayer_inputs_take_a_given_bias():
    s = psl.train_shapes(EDRLConfig(), batch=2)[0]
    bias = torch.zeros((1, s["heads"], s["n"], s["n"]))
    (x, *_, got), scale = psl.sublayer_inputs(s, torch.bfloat16, torch.Generator().manual_seed(0), bias)
    assert got is bias and x.shape == (2, 64, 144, 128) and x.dtype == torch.bfloat16 and scale == 128 ** -0.5
    drawn = psl.sublayer_inputs(s, torch.float32, torch.Generator().manual_seed(0))[0][-1]
    assert drawn.shape == (1, 1, 144, 144) and drawn.abs().max() < 0.2


def test_truncate_to_bf16_rounds_toward_zero():
    """The dbias control's do: each element the bf16 neighbour on zero's side,
    at most one bf16 ulp off, and bf16 values kept as they are."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    t = sd.truncate_to_bf16(x).float()
    assert (t.abs() <= x.abs()).all() and (torch.sign(t) == torch.sign(x)).all()
    assert ((x - t).abs() < x.abs() * 2.0 ** -7).all()
    assert ((x - t).abs() > 0).float().mean() > 0.9  # most f32 draws are not bf16 values
    nearest = x.bfloat16().float()
    assert torch.equal(sd.truncate_to_bf16(nearest).float(), nearest)
    assert ((nearest - t).abs() > 0).any() and (nearest.abs() >= t.abs()).all()


def test_sublayer_dbias_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        sd.main([])


def test_sublayer_profile_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        psl.main()


def test_layer_norm_profile_shapes_of_the_train_step():
    """54 B4 calls per forward of the use_fused_ln configuration, and one
    residual-form call per B6 sublayer (24) of the use_fused_block_attention
    configuration's backward."""
    cfg = EDRLConfig()
    assert sum(pln.ln_shapes(cfg).values()) == 54
    assert pln.ln_shapes(cfg)[(294912, 128)] == 5 and pln.ln_shapes(cfg)[(6912, 768)] == 25
    assert dict(pln.residual_shapes(cfg)) == {(294912, 128): 2, (73728, 256): 2, (18432, 512): 6, (4608, 1024): 2,
                                              (6912, 768): 12}


@pytest.mark.parametrize("kind,want", [("forward", 2 * 10 * 128 * 2 + 2 * 128 * 4),
                                       ("backward", 3 * 10 * 128 * 2 + 3 * 128 * 4),
                                       ("residual", 10 * 128 * (3 * 2 + 4) + 3 * 128 * 4)])
def test_layer_norm_profile_counts_each_byte_once(kind, want):
    assert pln.call_bytes(10, 128, kind) == want


def test_layer_norm_profile_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        pln.main()


def test_v1_mmd_profile_shapes_of_the_train_step():
    """v1 at the four Swin stages of a batch-32 step (one window of 144
    tokens, heads of 128), B3 over two [32, 3072] feature batches."""
    cfg = EDRLConfig()
    assert pv.v1_shapes(cfg) == [(32, 64, 1, 144, 128), (32, 16, 2, 144, 128), (32, 4, 4, 144, 128),
                                 (32, 1, 8, 144, 128)]
    assert pv.mmd_shape(cfg) == (32, 3072)


def test_v1_mmd_profile_steps_are_v1s_and_sdpas_on_the_cpu():
    """The timed calls compute v1's forward and backward (the plain versions
    on the CPU) and SDPA's on the same tensors, the bias as a mask."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, bias, do = pv.v1_inputs((2, 3, 2, 16, 8), gen)
    q, k, v, do = (t.float() for t in (q, k, v, do))
    want = wa.window_attention_bwd_reference(q, k, v, bias, do)
    for got, w in zip(pv.v1_step(q, k, v, bias, do), want):
        torch.testing.assert_close(got, w)
    sdpa = pv.sdpa_step(q, k, v, bias, do)
    for got, w in zip(sdpa[:3], want[:3]):
        torch.testing.assert_close(got.reshape(w.shape), w, atol=1e-5, rtol=1e-4)


def test_v1_mmd_profile_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        pv.main()


# The parallel tool's step-1 rule: B5's readings on 4 cards against one card
# (grads 75.8 of the bars, probabilities 0.49) beside its one-card witness
# (119.25, 1.0085), and readings made up around them.
B5_WORLD4 = {"replicated_spread": 0.0, "loss": 1e-4, "mmd": 1e-3, "probs": 0.49, "grads": 75.8,
             "ulp_loss": 0.047, "ulp_mmd": 3.8e-4, "ulp_probs": 1.0085, "ulp_grads": 119.25}


@pytest.mark.parametrize("change,want", [
    ({}, True),                                   # within 3x the witness
    ({"grads": 400.0}, False),                    # beyond 3x the witness
    ({"replicated_spread": 1e-9}, False),         # replicas differ
    ({"ulp_grads": 0.08, "grads": 1.2}, False),   # a witness inside the bars leaves the bars
    ({"ulp_grads": 0.08, "grads": 0.9}, True),
])
def test_parallel_check_passes_within_the_bars_or_its_witness(change, want):
    assert pdp.passes({**B5_WORLD4, **change}) is want


def test_nudged_moves_every_float_by_one_ulp_and_nothing_else():
    batch = {"view": torch.tensor([1.0, 0.0, -2.5]), "label": torch.tensor([1, 0])}
    got = pdp.nudged(batch)
    assert torch.equal(got["label"], batch["label"])
    assert (got["view"] > batch["view"]).all()
    assert torch.equal(torch.nextafter(got["view"], torch.full((3,), -float("inf"))), batch["view"])


@pytest.mark.parametrize("label,shape,want", [
    ("zero1", (4, 1), True), ("zero1", (1, 4), False), ("zero1", (2, 2), True),
    ("fused_mlp", (4, 1), True), ("fused_mlp", (2, 2), False), ("fused_block_attention", (1, 4), False),
    ("fused_ln", (2, 2), True), ("replicated", (1, 4), True),
])
def test_parallel_checks_run_where_the_port_takes_them(label, shape, want):
    class Mesh:
        def size(self, dim):
            return shape[dim]

    _, train, model = next(c for c in pdp.CHECKS if c[0] == label)
    assert pdp.applies(train, model, Mesh()) is want
