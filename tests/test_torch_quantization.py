"""W8A8 int8 quantization (``edrl_tpu_torch.ops.quantization``) against the
JAX package's (``edrl_tpu.ops.quantization``), on the CPU.

On the same float32 weights (converted with ``convert.load_flax_variables``):
the discovered Dense modules (the port's names mapped onto JAX's paths by
``convert.flax_key_map``), the int8 weights and scales (bit for bit), one
int8 Dense against JAX's interceptor (f32 atol 1e-6, dynamic and static
scales, padded and unpadded shapes), calibrated activation scales (rtol
1e-6, percentile 100 and 99.9), the percentile helper against numpy beyond
``torch.quantile``'s 2^24 elements, and the tiny config's int8 eval forward.

The eval forward's probabilities are held at 1e-4, or else within three times
JAX's own change when its inputs move by two f32 ulps (the rule of the
baseline tests): one activation a few ulps from a rounding boundary of its
int8 grid lands on the other level in the other stack, which moves the next
Dense's output by one level (~1e-2 of it) and the probabilities by ~1e-3.
JAX's own int8 forward moves by as much when its inputs move by two ulps.
Read on the tiny config: the port against JAX 1.7e-2 in the logits through
Swin's second block (the first level flip: its first MLP's Dense_1).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.ops import quantization as jq
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.convert import flax_key_map, load_flax_variables
from edrl_tpu_torch.models.layers import Dense, Mlp, init_parameters
from edrl_tpu_torch.models.medfusion import MedFusion
from edrl_tpu_torch.ops import quantization as tq

ATOL_DENSE = 1e-6
PROBS_ATOL = 1e-4
SPREAD_FACTOR = 3.0
BATCH = 4
# A small MedFusion whose widths are multiples of 128, so that B4, B5 and B6
# take their layers (the fused-model tests' slice).
SLICE = dict(swin_embed_dim=128, swin_heads=(1, 2), fundus_embed_dim=256, oct_embed_dim=128, vit3d_heads=2)
FLAG_CASES = {
    "shipped": dict(use_fused_attention=True, vit_fused_attention=True),
    "ln_mlp": dict(use_fused_attention=True, vit_fused_attention=True, use_fused_ln=True, use_fused_mlp=True),
    "block_attention": dict(use_fused_block_attention=True),
}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_path(key_map, name):
    """The JAX package's path of the port's Dense ``name``."""
    return tuple(key_map[name + ".weight"].split("/")[1:-1])


def _examples(d, batch=2):
    shapes = ((batch, d.fundus_size, d.fundus_size, 3), (batch, *d.oct_size, 1))
    jax_ex = (*(jnp.zeros(s, jnp.float32) for s in shapes), jnp.zeros((batch,), jnp.int32))
    torch_ex = (*(torch.zeros(s) for s in shapes), torch.zeros((batch,), dtype=torch.long))
    return jax_ex, torch_ex


# ---------------------------------------------------------------------------
# JAX's _Toy (tests/test_quantization.py), rebuilt.
# ---------------------------------------------------------------------------


class _JaxToy(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        table = self.param("table", fnn.initializers.normal(1.0), (256, 256))
        x = fnn.relu(fnn.Dense(256, name="big1")(x))
        x = x + jnp.mean(table) * 0.0
        x = fnn.relu(fnn.Dense(256, name="big2")(x))
        return fnn.Dense(8, name="small")(x)


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.table = torch.nn.Parameter(torch.empty(256, 256))
        self.big1, self.big2, self.small = Dense(256, 256), Dense(256, 256), Dense(256, 8)

    def forward(self, x):
        x = F.relu(self.big1(x))
        x = x + self.table.mean() * 0.0
        return self.small(F.relu(self.big2(x)))


@pytest.fixture(scope="module")
def toy():
    jm = _JaxToy()
    x = np.random.default_rng(0).normal(size=(4, 256)).astype(np.float32)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    tm = load_flax_variables(_Toy(), _np(v["params"]))
    return jm, v, tm, x


def test_toy_discovery_and_weights_match_jax(toy):
    jm, v, tm, x = toy
    jpaths = jq.discover_dense_paths(jm, v, jnp.asarray(x))
    tpaths = tq.discover_dense_paths(tm, torch.tensor(x))
    assert tuple((p,) for p in tpaths) == jpaths == (("big1",), ("big2",), ("small",))
    for min_dim, quantized in ((128, {"big1", "big2"}), (512, set())):
        qparams, jscales = jq.quantize_dense_params(v["params"], jpaths, min_dim=min_dim)
        weights, scales = tq.quantize_dense_params(tm, tpaths, min_dim=min_dim)
        assert set(scales) == set(weights) == set(jscales) == quantized
        for name in quantized:
            assert weights[name].dtype == torch.int8
            np.testing.assert_array_equal(weights[name].numpy(), np.asarray(qparams[name]["kernel"]).T)
            np.testing.assert_array_equal(scales[name].numpy(), np.asarray(jscales[name]))
    assert tm.table.dtype == torch.float32 and isinstance(tm.small, Dense)


def test_toy_serving_report_and_output_match_jax(toy):
    jm, v, tm, x = toy
    qv, jscales, jreport = jq.quantize_for_serving(jm, v, jnp.asarray(x))
    weights, scales, report = tq.quantize_for_serving(tm, torch.tensor(x))
    assert report == jreport
    want = np.asarray(jq.quantized_apply(jm, qv, jscales, jnp.asarray(x)))
    model = tq.apply_int8_(load_flax_variables(_Toy(), _np(v["params"])), weights, scales)
    assert isinstance(model.big1, tq.Int8Dense) and isinstance(model.small, Dense)
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_DENSE, rtol=0)


class _JaxOne(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(self.features, name="d")(x)


class _One(torch.nn.Module):
    def __init__(self, k, n):
        super().__init__()
        self.d = Dense(k, n)

    def forward(self, x):
        return self.d(x)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("lead,k,n", [((4,), 256, 256), ((3,), 100, 36), ((2, 5), 64, 48)],
                         ids=["aligned", "padded", "three_d"])
def test_int8_dense_matches_the_interceptor(static, lead, k, n):
    """One int8 Dense on one input, as JAX's interceptor computes it.  The
    padded case pads K (100 -> 104), N (36 -> 40) and M (3 -> 17)."""
    rng = np.random.default_rng(k + n)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    calib = np.ascontiguousarray(x[..., ::-1] * np.float32(0.8))  # values past its range saturate
    jm = _JaxOne(n)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    v = {"params": {"d": {"kernel": v["params"]["d"]["kernel"],
                          "bias": jnp.asarray(rng.normal(size=(n,)).astype(np.float32))}}}
    qparams, jscales = jq.quantize_dense_params(v["params"], (("d",),), min_dim=1)
    if static:
        jscales = jq.calibrate_activation_scales(jm, v, jscales, jnp.asarray(calib))
    want = np.asarray(jq.quantized_apply(jm, {"params": qparams}, jscales, jnp.asarray(x)))

    holder = load_flax_variables(_One(k, n), _np(v["params"]))
    weights, scales = tq.quantize_dense_params(holder, ("d",), min_dim=1)
    if static:
        scales = tq.calibrate_activation_scales(holder, scales, torch.tensor(calib))
        np.testing.assert_array_equal(scales["d" + tq.ACT_SUFFIX].numpy(), np.asarray(jscales["d" + jq.ACT_SUFFIX]))
    tq.apply_int8_(holder, weights, scales)
    tq.reset_launch_counts()
    with torch.no_grad():
        got = holder.d(torch.tensor(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL_DENSE, rtol=0)
    rows = int(np.prod(lead))
    assert tq.INT8_MATMULS == {tq.INT_MM: 1, tq.INT_MM_PADDED: int(rows < tq.INT_MM_MIN_ROWS)}


def test_int8_matmul_refuses_unaligned_operands():
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int8_matmul(torch.zeros((32, 100), dtype=torch.int8), torch.zeros((64, 100), dtype=torch.int8))


# ---------------------------------------------------------------------------
# The percentile helper.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def big_sample():
    """More elements than ``torch.quantile`` takes (2^24)."""
    return np.random.default_rng(3).normal(size=(2 ** 24 + 5,)).astype(np.float32)


@pytest.mark.parametrize("q", [99.9, 50.0, 0.0, 100.0, 37.3])
def test_linear_percentile_matches_numpy_beyond_quantiles_limit(big_sample, q):
    got = tq.linear_percentile(torch.from_numpy(big_sample), q)
    np.testing.assert_allclose(float(got), np.percentile(big_sample, q), rtol=1e-6)


def test_quantile_refuses_the_sample():
    """Why the helper exists: Swin's first-stage Dense input at batch 16 has
    16 * 9216 * 128 = 18.9M elements."""
    with pytest.raises(RuntimeError):
        torch.quantile(torch.zeros(2 ** 24 + 5), 0.999)


# ---------------------------------------------------------------------------
# MedFusion: discovery in each kernel configuration (the slice's widths).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_discovered_paths_and_counts_match_jax(case):
    jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, **SLICE, **FLAG_CASES[case]))
                  for c in (jax_tiny_config(BATCH), tconfig.tiny_test_config(BATCH)))
    d = jcfg.data
    shapes = jax.eval_shape(lambda: jtrainer.init_state(jcfg, 0)[1])
    jm = jtrainer.make_model(jcfg)
    jax_ex, torch_ex = _examples(d)
    jpaths = jq.discover_dense_paths(jm, {"params": shapes.params, "batch_stats": shapes.batch_stats},
                                     *jax_ex, train=False)
    tm = MedFusion(tcfg.model, d.fundus_size, d.oct_size, device="cpu").eval()
    init_parameters(tm, torch.Generator().manual_seed(0))
    tpaths = tq.discover_dense_paths(tm, *torch_ex, train=False)
    key_map = flax_key_map(tm, shapes.params, shapes.batch_stats)
    assert tuple(_jax_path(key_map, p) for p in tpaths) == jpaths
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes.params)
    for min_dim in (32, 128):
        _, jscales = jq.quantize_dense_params(zeros, jpaths, min_dim=min_dim)
        _, scales = tq.quantize_dense_params(tm, tpaths, min_dim=min_dim)
        assert {"/".join(_jax_path(key_map, p)) for p in scales} == set(jscales)
    if case != "shipped":  # the case's fused layers exist, and own no Dense module
        assert any((isinstance(m, Mlp) and m.fused) or getattr(m, "fused_block", False) for m in tm.modules())


# ---------------------------------------------------------------------------
# MedFusion at the tiny config, on the same converted weights and requests.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jax_tiny_config(BATCH), tconfig.tiny_test_config(BATCH)
    _, state = jtrainer.init_state(jcfg, 0)
    variables = {"params": _np(state.params), "batch_stats": _np(state.batch_stats)}
    jm = jtrainer.make_model(jcfg)
    d, m = jcfg.data, jcfg.model
    jax_ex, torch_ex = _examples(d)
    jpaths = jq.discover_dense_paths(jm, variables, *jax_ex, train=False)
    qparams, jscales = jq.quantize_dense_params(variables["params"], jpaths, min_dim=32)

    def port():
        tm = MedFusion(tcfg.model, d.fundus_size, d.oct_size, device="cpu").eval()
        return load_flax_variables(tm, variables["params"], variables["batch_stats"])

    tm = port()
    tpaths = tq.discover_dense_paths(tm, *torch_ex, train=False)
    rng = np.random.default_rng(5)
    f = (rng.integers(0, 256, (BATCH, d.fundus_size, d.fundus_size, 3)).astype(np.float32) / np.float32(255))
    o = (rng.integers(0, 256, (BATCH, *d.oct_size, 1)).astype(np.float32) / np.float32(255))
    ku1, ku2 = jax.random.split(jax.random.key(1))  # JAX's eval guided uniforms
    u = tuple(np.asarray(jax.random.uniform(k, (BATCH, m.num_classes, m.z_dim))) for k in (ku1, ku2))
    return dict(jm=jm, variables=variables, qparams=qparams, jscales=jscales, port=port, tm=tm, tpaths=tpaths,
                key_map=flax_key_map(tm, variables["params"], variables["batch_stats"]), f=f, o=o, u=u)


def _torch_inputs(t):
    return (torch.tensor(t["f"]), torch.tensor(t["o"]), torch.zeros((BATCH,), dtype=torch.long))


def _draws(t):
    return dict(guided_uniform=tuple(torch.tensor(a) for a in t["u"]))


def test_tiny_int8_weights_and_scales_are_bit_equal(tiny):
    weights, scales = tq.quantize_dense_params(tiny["tm"], tiny["tpaths"], min_dim=32)
    flat = traverse_util.flatten_dict(tiny["qparams"])
    assert len(scales) == len(tiny["jscales"]) == 60
    for name, w in weights.items():
        path = _jax_path(tiny["key_map"], name)
        np.testing.assert_array_equal(w.numpy(), np.asarray(flat[path + ("kernel",)]).T)
        np.testing.assert_array_equal(scales[name].numpy(), np.asarray(tiny["jscales"]["/".join(path)]))


@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_tiny_calibrated_scales_match_jax(tiny, percentile):
    f, o = jnp.asarray(tiny["f"]), jnp.asarray(tiny["o"])
    want = jq.calibrate_activation_scales(tiny["jm"], tiny["variables"], tiny["jscales"], f, o,
                                          jnp.zeros((BATCH,), jnp.int32), percentile=percentile, train=False)
    _, scales = tq.quantize_dense_params(tiny["tm"], tiny["tpaths"], min_dim=32)
    got = tq.calibrate_activation_scales(tiny["tm"], scales, *_torch_inputs(tiny), percentile=percentile,
                                         train=False, **_draws(tiny))
    act = [k for k in got if k.endswith(tq.ACT_SUFFIX)]
    assert len(act) == len(scales)
    for name in act:
        key = "/".join(_jax_path(tiny["key_map"], name[: -len(tq.ACT_SUFFIX)])) + jq.ACT_SUFFIX
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[key]), rtol=1e-6, err_msg=name)


def perturbed(x: np.ndarray, seed: int) -> np.ndarray:
    """x moved by two f32 ulps, each element up or down at random."""
    toward = np.where(np.random.default_rng(seed).random(x.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
    return np.nextafter(np.nextafter(x, toward), toward).astype(np.float32)


def perturbed_float_leaves(tree, seed: int):
    """Every f32 leaf of a flax tree moved by two ulps (int8 kernels kept):
    with static activation scales the input's own quantization absorbs a
    change of the inputs alone."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        perturbed(np.asarray(a), seed + i) if np.asarray(a).dtype == np.float32 else a
        for i, a in enumerate(leaves)])


def close_or_within_jax_spread(got, want, want_perturbed, atol=PROBS_ATOL) -> str:
    """Assert ``got`` is within ``atol`` of ``want``, or within
    SPREAD_FACTOR times JAX's own largest change under two-ulp input
    perturbations; returns the rule that held."""
    diff = float(np.abs(got - want).max())
    if diff <= atol:
        return "atol"
    spread = max(float(np.abs(p - want).max()) for p in want_perturbed)
    assert diff <= SPREAD_FACTOR * spread, (diff, spread)
    return "spread"


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_tiny_int8_eval_forward_matches_jax(tiny, static):
    jm, jscales = tiny["jm"], tiny["jscales"]
    y = jnp.zeros((BATCH,), jnp.int32)
    if static:
        jscales = jq.calibrate_activation_scales(jm, tiny["variables"], jscales, jnp.asarray(tiny["f"]),
                                                 jnp.asarray(tiny["o"]), y, train=False)
    qv = dict(tiny["variables"], params=tiny["qparams"])
    forward = jax.jit(lambda v, f, o: jax.nn.softmax(jq.quantized_apply(jm, v, jscales, f, o, y, train=False)[0]))
    want = np.asarray(forward(qv, tiny["f"], tiny["o"]))
    spread = [np.asarray(forward(perturbed_float_leaves(qv, s), perturbed(tiny["f"], s), perturbed(tiny["o"], s)))
              for s in range(3)]

    tm = tiny["port"]()
    weights, scales, _ = tq.quantize_for_serving(tm, *_examples(jax_tiny_config(BATCH).data)[1], min_dim=32,
                                                 train=False)
    if static:
        scales = tq.calibrate_activation_scales(tm, scales, *_torch_inputs(tiny), train=False, **_draws(tiny))
    tq.apply_int8_(tm, weights, scales)
    with torch.no_grad():
        got = torch.softmax(tm(*_torch_inputs(tiny), train=False, **_draws(tiny))[0], -1).numpy()
    close_or_within_jax_spread(got, want, spread)
