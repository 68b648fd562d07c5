"""Port's Predictor against the JAX Predictor on uint8 requests (CPU, f32)."""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from edrl_tpu.config import tiny_test_config
from edrl_tpu.serve import predictor as jpredictor
from edrl_tpu.train.trainer import init_state
from edrl_tpu_torch.models.layers import cast_dense_weights_, init_parameters
from edrl_tpu_torch.models.medfusion import MedFusion
from edrl_tpu_torch.serve import predictor


@pytest.fixture(scope="module")
def served():
    """Tiny JAX state with non-trivial BN statistics, and the JAX predictor."""
    cfg = tiny_test_config(batch_size=4)
    _, state = init_state(cfg, 0)
    rng = np.random.default_rng(1)
    state = state.replace(batch_stats=jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state.batch_stats
    ))
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}
    )
    m = cfg.model
    ku1, ku2 = jax.random.split(jax.random.key(1))
    u = tuple(np.asarray(jax.random.uniform(k, (4, m.num_classes, m.z_dim))) for k in (ku1, ku2))
    return cfg, variables, u, jpredictor.Predictor(cfg, state)


def _request(cfg, n, seed):
    rng = np.random.default_rng(seed)
    d = cfg.data
    return (rng.integers(0, 256, (n, d.fundus_size, d.fundus_size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, *d.oct_size, 1), dtype=np.uint8))


def test_probs_match_jax(served):
    cfg, variables, u, jpred = served
    pred = predictor.Predictor(cfg, variables, device="cpu", guided_uniform=u)
    for n, seed in ((4, 0), (7, 1)):  # 7 pads its tail batch
        f, o = _request(cfg, n, seed)
        got = pred.predict_probs(f, o)
        want = jpred.predict_probs(f, o)
        assert got.shape == (n, cfg.model.num_classes)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(pred.predict_labels(f, o), got.argmax(-1))


def test_f32_transport_and_empty_request(served):
    cfg, variables, u, _ = served
    f, o = _request(cfg, 5, 2)
    as_uint8 = predictor.Predictor(cfg, variables, device="cpu", guided_uniform=u)
    as_f32 = predictor.Predictor(cfg, variables, device="cpu", guided_uniform=u, transport="f32")
    np.testing.assert_allclose(
        as_f32.predict_probs(f / 255.0, o / 255.0), as_uint8.predict_probs(f, o), atol=1e-5
    )
    assert as_f32.predict_probs(f[:0], o[:0]).shape == (0, cfg.model.num_classes)


def test_uint8_transport_warns_on_clipping():
    x = np.array([-0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
    with pytest.warns(RuntimeWarning, match="clipped 2 input values"):
        got = predictor._to_uint8_transport(x)
    np.testing.assert_array_equal(got, jpredictor._to_uint8_transport(x))
    inside = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(
            predictor._to_uint8_transport(inside), jpredictor._to_uint8_transport(inside)
        )


class _TwoDataRanks:
    """What the Predictor reads of a 2-rank data mesh before it serves."""

    def size(self, dim=None):
        return 2


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=_TwoDataRanks()), "not divisible by the mesh data axis"),
])
def test_unported_options_raise(kwargs, item):
    """A serving batch (3) that does not split over the mesh's data ranks
    raises ValueError, as the JAX package's mesh Predictor does
    (``tests/test_torch_parallel.py`` serves over a real mesh)."""
    with pytest.raises(ValueError, match=item):
        predictor.Predictor(tiny_test_config(batch_size=3), device="meta", **kwargs)


@pytest.mark.parametrize("kwargs", [dict(quantize_int8=True, min_dim=32), dict(chunk_batches=2)],
                         ids=["int8", "chunked"])
def test_serving_options_run(served, kwargs):
    """int8 and chunked serving (A10's serving half; ``test_torch_serve.py``
    holds them against JAX and the per-batch forward) serve a request."""
    cfg, variables, u, _ = served
    f, o = _request(cfg, 9, 5)
    probs = predictor.Predictor(cfg, variables, device="cpu", guided_uniform=u, **kwargs).predict_probs(f, o)
    assert probs.shape == (9, cfg.model.num_classes) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


def test_ensemble_averages_member_logits(served):
    """Two members (the served variables, and the same with perturbed Dense
    kernels): the softmax of the mean of their logits, one member at a time."""
    cfg, variables, u, _ = served
    other = jax.tree_util.tree_map_with_path(
        lambda p, a: a * np.float32(1.1) if p[-1].key == "kernel" else a, variables)
    pred = predictor.Predictor(cfg, [variables, other], device="cpu", guided_uniform=u)
    assert pred.num_members == 2
    f, o = _request(cfg, 5, 4)
    logits = [predictor.Predictor(cfg, v, device="cpu", guided_uniform=u) for v in (variables, other)]
    want = []
    for p in logits:
        fu, ou = (torch.tensor(x / 255.0, dtype=torch.float32) for x in (f, o))
        with torch.no_grad():
            want.append(torch.cat([p.model(fu[i:i + 4], ou[i:i + 4], guided_uniform=tuple(
                t[: len(fu[i:i + 4])] for t in p.guided_uniform))[0] for i in range(0, 5, 4)]))
    np.testing.assert_allclose(pred.predict_probs(f, o), torch.softmax((want[0] + want[1]) / 2, -1).numpy(),
                               atol=1e-5)


def test_dense_weight_cast_is_exact_in_bf16():
    cfg = tiny_test_config(batch_size=2)
    m = dataclasses.replace(cfg.model, use_bfloat16=True, use_fused_attention=True)
    d = cfg.data
    model = MedFusion(m, d.fundus_size, d.oct_size, device="cpu").eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    f, o = (torch.tensor(x / 255.0, dtype=torch.float32) for x in _request(cfg, 2, 3))
    with torch.no_grad():
        before = model(f, o)[0]
        cast_dense_weights_(model)
        after = model(f, o)[0]
    assert model.head1.weight.dtype == torch.float32  # f32 Dense layers stay f32
    assert model.transformer_3d.patch_embed.weight.dtype == torch.bfloat16
    assert torch.equal(before, after)
