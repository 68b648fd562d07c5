"""The serving half of the port's ``Predictor`` on the CPU: int8 (dynamic and
calibrated) against the JAX ``Predictor(quantize_int8=True)``, chunked
serving, the calibration set's checks, the export round trip
(``serve.export``) and the forward kernels' operators (``torch.library``).

The int8 predictors are held at 1e-4 on probabilities, or within three
times JAX's own change under a two-ulp change of its inputs and float
parameters (``test_torch_quantization.close_or_within_jax_spread``: an
activation next to a boundary of its int8 grid lands on the other level in
the other stack).  The port gets the uint8 requests (dequantized on the
device) and JAX the same values in f32, so one compiled JAX program serves the
request and its perturbations.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.serve import predictor as jpredictor
from edrl_tpu.train.trainer import init_state
from edrl_tpu_torch.config import tiny_test_config
from edrl_tpu_torch.kernels import block_attention, fused_mlp, layer_norm, window_attention
from edrl_tpu_torch.ops import quantization
from edrl_tpu_torch.serve import export, predictor
from test_torch_quantization import close_or_within_jax_spread, perturbed, perturbed_float_leaves

BATCH = 4
MIN_DIM = 32


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _request(cfg, n, seed):
    rng = np.random.default_rng(seed)
    d = cfg.data
    return (rng.integers(0, 256, (n, d.fundus_size, d.fundus_size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, *d.oct_size, 1), dtype=np.uint8))


def _f32(x):
    """uint8 -> f32 as the device dequantizes it (an f32 division)."""
    return x.astype(np.float32) / np.float32(255)


@pytest.fixture(scope="module")
def served():
    cfg = jax_tiny_config(BATCH)
    _, state = init_state(cfg, 0)
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    m = cfg.model
    ku1, ku2 = jax.random.split(jax.random.key(1))
    u = tuple(np.asarray(jax.random.uniform(k, (BATCH, m.num_classes, m.z_dim))) for k in (ku1, ku2))
    return cfg, state, variables, u


def _jax_probs_and_spread(jpred, f, o):
    """JAX's probabilities on the request and on three perturbations of its
    inputs and float parameters (the same compiled program)."""
    want = jpred.predict_probs(_f32(f), _f32(o))
    variables = jpred.variables
    spread = []
    for seed in range(3):
        jpred.variables = perturbed_float_leaves(variables, seed)
        spread.append(jpred.predict_probs(perturbed(_f32(f), seed), perturbed(_f32(o), seed)))
    jpred.variables = variables
    return want, spread


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_predictor_matches_jax(served, static):
    cfg, state, variables, u = served
    f, o = _request(cfg, 7, 0)  # 7 pads its tail batch
    calibration = _request(cfg, 6, 1) if static else None  # two chunks, the last wraps around
    jpred = jpredictor.Predictor(cfg, state, quantize_int8=True, min_dim=MIN_DIM, transport="f32",
                                 int8_calibration=calibration)
    want, spread = _jax_probs_and_spread(jpred, f, o)
    pred = predictor.Predictor(tiny_test_config(BATCH), variables, device="cpu", guided_uniform=u,
                               quantize_int8=True, min_dim=MIN_DIM, int8_calibration=calibration)
    assert pred.quant_report == {**jpred.quant_report, "quantized_paths": pred.quant_report["quantized_paths"]}
    assert len(pred.quant_report["quantized_paths"]) == len(jpred.quant_report["quantized_paths"]) == 60
    got = pred.predict_probs(f, o)
    assert got.shape == (7, cfg.model.num_classes)
    close_or_within_jax_spread(got, want, spread)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_chunked_matches_per_batch(served, int8):
    """13 pairs, C = 3: one chunk of three batches and a tail of one (padded)."""
    _, _, variables, u = served
    cfg = tiny_test_config(BATCH)
    f, o = _request(cfg, 13, 2)
    kw = dict(device="cpu", guided_uniform=u, quantize_int8=int8, min_dim=MIN_DIM)
    per_batch = predictor.Predictor(cfg, variables, **kw).predict_probs(f, o)
    chunked = predictor.Predictor(cfg, variables, chunk_batches=3, **kw).predict_probs(f, o)
    np.testing.assert_allclose(chunked, per_batch, atol=2e-5, rtol=0)


def test_calibration_set_is_checked(served):
    _, _, variables, _ = served
    cfg = tiny_test_config(BATCH)
    f, o = _request(cfg, 5, 3)
    with pytest.raises(ValueError, match="5 fundus images but 4 OCT volumes"):
        predictor.Predictor(cfg, variables, device="cpu", quantize_int8=True, min_dim=MIN_DIM,
                            int8_calibration=(f, o[:4]))
    with pytest.raises(ValueError, match="empty"):
        predictor.Predictor(cfg, variables, device="cpu", quantize_int8=True, min_dim=MIN_DIM,
                            int8_calibration=(f[:0], o[:0]))
    with pytest.raises(ValueError, match="requires quantize_int8"):
        predictor.Predictor(cfg, variables, device="cpu", int8_calibration=(f, o))


def test_quantized_weights_come_from_the_float32_masters(served):
    """int8 quantizes before the serving cast: the float Dense layers that
    remain are stored in the compute dtype, the int8 ones hold the f32
    masters' int8 values."""
    _, _, variables, _ = served
    cfg = tiny_test_config(BATCH)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_bfloat16=True))
    pred = predictor.Predictor(cfg, variables, device="cpu", quantize_int8=True, min_dim=MIN_DIM)
    master = torch.tensor(variables["params"]["transformer_3d"]["patch_embed"]["kernel"]).T
    w_q, w_scale = quantization.quantize_weight(master)
    dense = pred.model.transformer_3d.patch_embed
    assert isinstance(dense, quantization.Int8Dense) and dense.dtype == torch.bfloat16
    assert torch.equal(dense.weight, w_q) and torch.equal(dense.w_scale, w_scale)
    assert pred.model.head2.weight.dtype == torch.float32  # f32 Dense layers stay f32


# ---------------------------------------------------------------------------
# Export.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fused_cfg():
    cfg = tiny_test_config(BATCH)
    return cfg.replace(model=dataclasses.replace(cfg.model, use_fused_attention=True, vit_fused_attention=True))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    d = cfg.data
    return (torch.tensor(rng.random((BATCH, d.fundus_size, d.fundus_size, 3), dtype=np.float32)),
            torch.tensor(rng.random((BATCH, *d.oct_size, 1), dtype=np.float32)))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_export_round_trip(fused_cfg, int8):
    """The loaded program reproduces the live forward exactly."""
    pred = predictor.Predictor(fused_cfg, device="cpu", quantize_int8=int8, min_dim=MIN_DIM)
    assert export.roundtrip_check(pred, *_batch(fused_cfg, 4)) == (True, 0.0)


def test_exported_program_calls_the_operators_and_takes_the_weights(fused_cfg, tmp_path):
    """From a file: the program calls the port's B1 and B2 operators, holds
    no weight, and serves another seed's weights as a live predictor of them
    does."""
    kw = dict(device="cpu", quantize_int8=True, min_dim=MIN_DIM)
    pred = predictor.Predictor(fused_cfg, **kw)
    path = str(tmp_path / "forward.pt2")
    export.export_forward(pred, path)
    loaded = export.ExportedForward.load(path)
    # Swin's two blocks (B2) and the ViT's two (B1).
    ops = export.program_ops(loaded.program)
    assert sorted(ops) == ["self_attention_fwd"] * 2 + ["window_attention_v2_fwd"] * 2
    assert not loaded.program.state_dict and loaded.program.example_inputs is None
    f, o = _batch(fused_cfg, 5)
    other = predictor.Predictor(fused_cfg, seed=1, **kw)
    with torch.inference_mode():
        live = other._forward(f, o)
    served_other = loaded(other.serving_state(), f, o)
    assert torch.equal(served_other, live)
    assert not torch.equal(served_other, loaded(pred.serving_state(), f, o))


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    c = 32
    return {
        "self_attention_fwd": (window_attention.self_attention_fwd, (r(2, 8, 16), r(2, 8, 16), r(2, 8, 16), 2, 0.25)),
        "window_attention_v2_fwd": (window_attention.window_attention_v2_fwd, (r(2, 3, 8, 48), r(3, 2, 8, 8), 2, 0.25)),
        "layer_norm_fwd": (layer_norm.layer_norm_fwd, (r(6, 128), r(128), r(128), 1e-6)),
        "fused_mlp_fwd": (fused_mlp.fused_mlp_fwd, (r(6, 128), r(128, 256), r(256), r(256, 128), r(128))),
        "attention_sublayer_fwd": (block_attention.attention_sublayer_fwd,
                                   (r(2, 3, 8, c), r(c), r(c), r(c, 3 * c), r(3 * c), r(c, c), r(c), r(1, 2, 8, 8),
                                    2, c ** -0.5)),
    }


@pytest.mark.parametrize("name", ["self_attention_fwd", "window_attention_v2_fwd", "layer_norm_fwd", "fused_mlp_fwd",
                                  "attention_sublayer_fwd"])
def test_forward_operator_passes_opcheck(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    assert str(op._opoverload).startswith("edrl_tpu_torch.")
