"""The port's tensor-parallel rules (``edrl_tpu_torch.parallel.mesh``) against
the JAX package's (``edrl_tpu/parallel/mesh.py``), with no process group.

- ``param_shardings`` gives every parameter the split dimension that JAX's
  ``infer_param_shardings`` gives its flax leaf (a kernel's split axis
  transposed), at model axes 2 and 4, on ``tiny_test_config`` and on the
  full-width depth-1 config of ``tests/test_parallel.py``'s
  ``TestFullTokenDimsUnderTP``.  JAX's side comes from ``jax.eval_shape``
  of its init, the port's from a model built on the ``meta`` device.
- ``sharded_byte_fraction`` equals JAX's on its toy case (0.5) and on both
  configs; on the shipped model it is 0.9818, JAX's figure.
- Swin's packed qkv, sharded head-major (``head_major_permutation``) over M
  ranks and put back together as ``parallel.tensor.gather_full`` does,
  is the original weight, and each rank's block holds q, k and v of its own
  heads; a row-parallel weight likewise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.config import DataConfig as JaxDataConfig
from edrl_tpu.config import EDRLConfig as JaxEDRLConfig
from edrl_tpu.config import ModelConfig as JaxModelConfig
from edrl_tpu.config import TrainConfig as JaxTrainConfig
from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.parallel import make_mesh
from edrl_tpu.parallel import sharded_byte_fraction as jax_sharded_byte_fraction
from edrl_tpu.parallel.mesh import infer_param_shardings
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.convert import flax_key_map
from edrl_tpu_torch.models.layers import Dense
from edrl_tpu_torch.parallel.mesh import ModelAxis, param_shardings, sharded_byte_fraction
from edrl_tpu_torch.parallel.tensor import ColumnParallelDense, RowParallelDense, head_major_permutation
from edrl_tpu_torch.train import trainer


def _full_width_depth1(cfg_module):
    """``TestFullTokenDimsUnderTP``'s config: the shipped widths and token
    geometry at one block per stage, f32, kernels off."""
    m = cfg_module
    return m.EDRLConfig(
        data=m.DataConfig(dataset="synthetic", batch_size=4, eval_batch_size=4, num_synthetic_samples=8),
        model=m.ModelConfig(swin_depths=(1, 1, 1, 1), vit3d_depth=1, sample_num=16, proxy_topk=8, use_bfloat16=False,
                            use_fused_attention=False, vit_fused_attention=False, use_fused_mlp=False,
                            use_fused_ln=False, remat_attention=False),
        train=m.TrainConfig(lr=1e-4))


class _JaxConfigs:
    EDRLConfig, DataConfig, ModelConfig, TrainConfig = JaxEDRLConfig, JaxDataConfig, JaxModelConfig, JaxTrainConfig


CONFIGS = {"tiny": (lambda: jax_tiny_config(4), lambda: tconfig.tiny_test_config(4)),
           "full_width_depth1": (lambda: _full_width_depth1(_JaxConfigs), lambda: _full_width_depth1(tconfig))}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """``(JAX's parameter and statistics shapes, the port's model on meta)``
    for config ``name``."""
    jcfg, tcfg = (make() for make in CONFIGS[name])
    d = jcfg.data
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "sample", "dropout"))}
    shapes = jax.eval_shape(functools.partial(jtrainer.make_model(jcfg).init, train=True), rngs,
                            jnp.zeros((2, d.fundus_size, d.fundus_size, 3)), jnp.zeros((2, *d.oct_size, 1)),
                            jnp.zeros((2,), jnp.int32))
    return shapes, trainer.make_model(tcfg, "meta")


def _jax_mesh(m):
    return make_mesh(num_data=1, num_model=m, devices=jax.devices()[:m])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_param_shardings_match_jax(name, m):
    shapes, model = _pair(name)
    params = shapes["params"]
    key_map = flax_key_map(model, params, shapes["batch_stats"])
    jax_specs = {"/".join(str(k.key) for k in path): s.spec for path, s in jax.tree_util.tree_flatten_with_path(
        infer_param_shardings(params, _jax_mesh(m)), is_leaf=lambda x: hasattr(x, "spec"))[0]}
    mine = param_shardings(model, m)
    assert set(mine) == {n for n, _ in model.named_parameters()}
    split = 0
    for torch_name, dim in mine.items():
        spec = tuple(jax_specs[key_map[torch_name][len("params/"):]])
        if spec in ((), (None, None)):
            assert dim is None, torch_name
            continue
        flax_axis = spec.index("model")
        want = 1 - flax_axis if key_map[torch_name].endswith("/kernel") else flax_axis
        assert dim == want, (torch_name, spec)
        split += 1
    assert split > 20


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_byte_fraction_matches_jax(name):
    params, model = _pair(name)[0]["params"], _pair(name)[1]
    for m in (2, 4):
        want = jax_sharded_byte_fraction(params, infer_param_shardings(params, _jax_mesh(m)))
        assert sharded_byte_fraction(model, param_shardings(model, m)) == pytest.approx(want, rel=1e-12)


def test_sharded_byte_fraction_toy_and_shipped():
    """JAX's toy case (one ``Mlp_0/Dense_0`` kernel split, one ``head`` kernel
    not: 0.5), and the shipped model's 0.9818 at model axes 2 and 4."""
    toy = torch.nn.Module()
    toy.Mlp_0 = torch.nn.Module()
    toy.Mlp_0.Dense_0 = Dense(8, 16, use_bias=False, device="meta")
    toy.head = Dense(8, 16, use_bias=False, device="meta")
    jax_toy = {"Mlp_0": {"Dense_0": {"kernel": jnp.zeros((8, 16))}}, "head": {"kernel": jnp.zeros((8, 16))}}
    want = jax_sharded_byte_fraction(jax_toy, infer_param_shardings(jax_toy, _jax_mesh(2)))
    assert sharded_byte_fraction(toy, param_shardings(toy, 2)) == pytest.approx(want) == pytest.approx(0.5)
    assert param_shardings(toy, 2) == {"Mlp_0.Dense_0.weight": 0, "head.weight": None}
    shipped = trainer.make_model(tconfig.EDRLConfig(), "meta")
    assert sum(p.numel() for p in shipped.parameters()) == 187_433_512
    for m in (1, 2, 4):
        fraction = sharded_byte_fraction(shipped, param_shardings(shipped, m))
        assert round(fraction, 4) == (0.0 if m == 1 else 0.9818), m


@pytest.mark.parametrize("heads,m", [(1, 2), (2, 2), (4, 2), (8, 4), (4, 4)])
def test_qkv_head_major_shards_gather_back(heads, m):
    """Each rank's block of the permuted qkv holds its heads' q, k and v
    columns (where the heads divide the axis), and the blocks concatenated
    with the permutation undone are the original weight and bias."""
    dim, d = 16 * heads, 16
    gen = torch.Generator().manual_seed(heads * 10 + m)
    dense = Dense(dim, 3 * dim)
    with torch.no_grad():
        dense.weight.copy_(torch.randn(dense.weight.shape, generator=gen))
        dense.bias.copy_(torch.randn(dense.bias.shape, generator=gen))
    perm = head_major_permutation(dim, heads, m) if heads % m == 0 else None
    ranks = [ColumnParallelDense(dense, ModelAxis(None, r, m), gather_output=False, permutation=perm)
             for r in range(m)]
    for name in ("weight", "bias"):
        full = torch.cat([getattr(r, name).detach() for r in ranks])
        if perm is not None:
            full = full[torch.argsort(perm)]
        assert torch.equal(full, getattr(dense, name).detach())
    if perm is not None:
        local = heads // m
        for r, rank in enumerate(ranks):
            for t in range(3):  # q, k, v
                cols = slice(t * dim + r * local * d, t * dim + (r + 1) * local * d)
                assert torch.equal(rank.weight.detach()[t * local * d:(t + 1) * local * d], dense.weight.detach()[cols])
    row = Dense(dim, dim)
    with torch.no_grad():
        row.weight.copy_(torch.randn(row.weight.shape, generator=gen))
    shards = [RowParallelDense(row, ModelAxis(None, r, m), input_split=True) for r in range(m)]
    assert torch.equal(torch.cat([s.weight.detach() for s in shards], dim=1), row.weight.detach())
    assert all(torch.equal(s.bias, row.bias) for s in shards)
    np.testing.assert_array_equal(shards[0].local(row.weight.detach()).numpy(), shards[0].weight.detach().numpy())
