"""flax -> torch converter: full-width coverage (shapes only) and strictness."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.config import EDRLConfig, tiny_test_config
from edrl_tpu.train.trainer import make_model
from edrl_tpu_torch.convert import flax_key_map, load_flax_variables
from edrl_tpu_torch.models.layers import Dense, init_parameters
from edrl_tpu_torch.models.medfusion import MedFusion


def _flax_shapes(cfg):
    """Every flax leaf of MedFusion.init at this config, as shapes (no compute)."""
    d = cfg.data
    args = (
        jnp.zeros((2, d.fundus_size, d.fundus_size, 3)),
        jnp.zeros((2, *d.oct_size, 1)),
        jnp.zeros((2,), jnp.int32),
    )
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "sample", "dropout"))}
    return jax.eval_shape(lambda: make_model(cfg).init(rngs, *args, train=True))


def _n_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_full_width_every_leaf_maps():
    cfg = EDRLConfig()
    shapes = _flax_shapes(cfg)
    model = MedFusion(cfg.model, cfg.data.fundus_size, cfg.data.oct_size, device="meta")
    mapping = flax_key_map(model, shapes["params"], shapes["batch_stats"])
    n_flax = _n_leaves(shapes)
    assert len(mapping) == n_flax == len(model.state_dict())
    assert len(set(mapping.values())) == n_flax
    assert mapping["transformer_2d.SwinBlock_11.WindowAttention_0.qkv.weight"] == (
        "params/transformer_2d/SwinBlock_11/WindowAttention_0/qkv/kernel"
    )
    assert mapping["dilr.bn1.running_var"] == "batch_stats/dilr/bn1/var"
    n_params = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_params == sum(p.numel() for p in model.parameters())


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = tiny_test_config()
    shapes = _flax_shapes(cfg)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    return cfg, tree


def _tiny_model(cfg):
    return MedFusion(cfg.model, cfg.data.fundus_size, cfg.data.oct_size, device="cpu")


def test_load_values_and_layouts(tiny_tree):
    cfg, tree = tiny_tree
    model = load_flax_variables(_tiny_model(cfg), tree["params"], tree["batch_stats"])
    p = tree["params"]["transformer_3d"]["SelfAttentionBlock_0"]["MultiHeadAttention_0"]["q"]
    mha = model.transformer_3d.SelfAttentionBlock_0.MultiHeadAttention_0
    np.testing.assert_array_equal(mha.q.weight.detach().numpy(), p["kernel"].T)
    np.testing.assert_array_equal(mha.q.bias.detach().numpy(), p["bias"])
    ln = tree["params"]["transformer_2d"]["final_norm"]
    np.testing.assert_array_equal(model.transformer_2d.final_norm.weight.detach().numpy(), ln["scale"])
    np.testing.assert_array_equal(
        model.dilr.bn2.running_mean.numpy(), tree["batch_stats"]["dilr"]["bn2"]["mean"]
    )
    assert model.eprl_oct.alpha.shape == ()


def test_strict_extra_leaf(tiny_tree):
    cfg, tree = tiny_tree
    params = copy.deepcopy(tree["params"])
    params["poe"]["psi"] = np.ones(2, np.float32)
    with pytest.raises(KeyError, match="params/poe/psi"):
        load_flax_variables(_tiny_model(cfg), params, tree["batch_stats"])


def test_strict_missing_leaf(tiny_tree):
    cfg, tree = tiny_tree
    stats = copy.deepcopy(tree["batch_stats"])
    del stats["dilr"]["bn1"]["var"]
    with pytest.raises(KeyError, match="dilr.bn1.running_var"):
        load_flax_variables(_tiny_model(cfg), tree["params"], stats)


def test_strict_shape(tiny_tree):
    cfg, tree = tiny_tree
    params = copy.deepcopy(tree["params"])
    params["head2"]["kernel"] = params["head2"]["kernel"].T
    with pytest.raises(ValueError, match="params/head2/kernel"):
        load_flax_variables(_tiny_model(cfg), params, tree["batch_stats"])


def test_seeded_init_is_deterministic_and_flax_like():
    cfg = tiny_test_config()

    def init(seed):
        return init_parameters(_tiny_model(cfg), torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = init(0), init(0), init(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head1.weight"], c["head1.weight"])
    assert torch.equal(a["dilr.bn1.running_var"], torch.ones(128))
    assert float(a["eprl_fundus.alpha"]) == 0.5
    assert torch.equal(a["transformer_2d.final_norm.weight"], torch.ones(64))
    # lecun_normal: std sqrt(1 / fan_in), truncated at 2 std of the untruncated normal.
    dense = Dense(512, 2048)
    init_parameters(dense, torch.Generator().manual_seed(0))
    w = dense.weight.detach()
    assert abs(float(w.std()) - 512 ** -0.5) < 0.02 * 512 ** -0.5
    assert float(w.abs().max()) <= 2 * 512 ** -0.5 / 0.87962566103423978 + 1e-6
    table = a["transformer_2d.SwinBlock_0.WindowAttention_0.rel_bias_table"]
    assert float(table.abs().max()) <= 0.04 + 1e-7
