"""The baseline zoo's backbones and their building blocks against flax, on the CPU.

- The SAME-padded ``Conv``, ``max_pool`` and ``avg_pool`` against flax's
  ``nn.Conv``, ``nn.max_pool`` and ``nn.avg_pool``: 2-D and 3-D, stride 1
  and 2, odd and even sizes, and the asymmetric pads of the backbones'
  stride-2 layers, which a symmetric pad gets wrong.
- ``BatchNorm`` in train mode: outputs and running statistics after one and
  two calls, and the gradients of the closed-form backward.
- ``Res2Net2D`` (26w4s and 14w8s) and ``ResNet3D`` (ResNet-10 and -18): the
  feature map and the pooled vector in eval and train mode, and the updated
  BN statistics.

Bars: a single layer at f32 1e-5 absolute; a whole backbone, whose
activations grow through its residual stages to ~1e1-1e3, at 1e-5 of the
largest magnitude in eval mode (the readings sit at ~1e-7 of it), and in
train mode as ``test_backbone_matches_flax`` says.
"""

import copy

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.models import resnet2d as jresnet2d
from edrl_tpu.models import resnet3d as jresnet3d
from edrl_tpu_torch.convert import load_flax_variables
from edrl_tpu_torch.models import conv
from edrl_tpu_torch.models.resnet2d import Res2Net2D
from edrl_tpu_torch.models.resnet3d import ResNet3D

ATOL = 1e-5
# How far past the f32 spread flax's train-mode result may read against the
# port's f64 one (tests/test_torch_baselines.py's factor).
WITNESS = 3.0


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the test workers share the host's cores with JAX's own threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("size,kernel,stride,want", [
    (384, 3, 2, (0, 1)), (192, 3, 2, (0, 1)), (96, 7, 2, (2, 3)), (48, 3, 2, (0, 1)), (24, 3, 2, (0, 1)),
    (99, 7, 2, (3, 3)), (15, 3, 2, (1, 1)), (16, 1, 2, (0, 0)), (16, 3, 1, (1, 1)), (16, 7, 1, (3, 3)),
])
def test_same_padding_is_flax_s(size, kernel, stride, want):
    assert conv.same_padding(size, kernel, stride) == want


# (ndim, size, kernel, stride): odd and even sizes, stride 1 and 2, the
# backbones' stride-2 layers (asymmetric pads) among them.
CASES = [
    (2, 16, 3, 2), (2, 15, 3, 2), (2, 16, 3, 1), (2, 15, 7, 1), (2, 12, 1, 2), (2, 13, 5, 2),
    (3, 12, 7, 2), (3, 9, 3, 2), (3, 8, 3, 2), (3, 8, 3, 1), (3, 7, 1, 2),
]


def _input(ndim, size, channels, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, *(size,) * ndim, channels)).astype(np.float32)


@pytest.mark.parametrize("ndim,size,kernel,stride", CASES)
@pytest.mark.parametrize("use_bias", [False, True])
def test_conv_matches_flax(ndim, size, kernel, stride, use_bias):
    x = _input(ndim, size, 3, 0)
    jm = fnn.Conv(5, (kernel,) * ndim, strides=(stride,) * ndim, use_bias=use_bias, padding="SAME")
    variables = _np(jm.init(jax.random.key(0), x))
    if use_bias:
        variables["params"]["bias"] = np.random.default_rng(1).normal(size=(5,)).astype(np.float32)
    want = np.asarray(jm.apply(variables, x))
    tm = load_flax_variables(conv.Conv(3, 5, (kernel,) * ndim, stride=stride, use_bias=use_bias),
                             variables["params"])
    got = tm(torch.tensor(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("ndim,size,kernel,stride", CASES)
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pools_match_flax(ndim, size, kernel, stride, kind):
    # All-positive inputs: a pad of zeros where flax pads -inf would show.
    x = np.abs(_input(ndim, size, 4, 2)) + 0.5
    k, s = (kernel,) * ndim, (stride,) * ndim
    fn = (fnn.max_pool, conv.max_pool) if kind == "max" else (fnn.avg_pool, conv.avg_pool)
    want = np.asarray(fn[0](jnp.asarray(x), k, strides=s, padding="SAME"))
    got = fn[1](torch.tensor(x), k, s).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_a_symmetric_pad_would_fail():
    """The stride-2 avg-pool on an even size pads (0, 1): padding 1 on both
    sides gives the same shape and other numbers."""
    x = torch.tensor(np.abs(_input(2, 16, 4, 3)) + 0.5)
    want = np.asarray(fnn.avg_pool(jnp.asarray(x.numpy()), (3, 3), strides=(2, 2), padding="SAME"))
    sym = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1, count_include_pad=True)
    sym = sym.permute(0, 2, 3, 1).numpy()
    assert sym.shape == want.shape
    assert np.abs(sym - want).max() > 1e-2
    np.testing.assert_allclose(conv.avg_pool(x, (3, 3), (2, 2)).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("shape", [(4, 6, 6, 5), (2, 4, 5, 3, 7)])
def test_batch_norm_train_matches_flax(shape):
    rng = np.random.default_rng(4)
    c = shape[-1]
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.float32)
    x1 = (rng.normal(size=shape) * 2.0 + 0.7).astype(np.float32)
    x2 = (rng.normal(size=shape) * 0.5 - 0.3).astype(np.float32)
    variables = _np(jm.init(jax.random.key(0), x1))
    variables["params"] = {"scale": rng.uniform(0.5, 1.5, size=c).astype(np.float32),
                           "bias": rng.normal(size=c).astype(np.float32)}
    tm = load_flax_variables(conv.BatchNorm(c), variables["params"], variables["batch_stats"])
    stats = variables["batch_stats"]
    dy = rng.normal(size=shape).astype(np.float32)
    for x in (x1, x2):  # two calls: the running statistics compound
        def loss(params, x=x, stats=stats):
            y, upd = jm.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
            return jnp.sum(y * dy), (y, upd["batch_stats"])

        (_, (want, stats)), grads = jax.value_and_grad(loss, has_aux=True, argnums=0)(variables["params"])
        xt = torch.tensor(x, requires_grad=True)
        got = tm(xt, train=True)
        (got * torch.tensor(dy)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)
        np.testing.assert_allclose(tm.weight.grad.numpy(), np.asarray(grads["scale"]), atol=2e-4, rtol=1e-5)
        np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(grads["bias"]), atol=2e-4, rtol=1e-5)
        dx = jax.grad(lambda x: jnp.sum(jm.apply({"params": variables["params"], "batch_stats": stats}, x,
                                                 mutable=["batch_stats"])[0] * dy))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=1e-5)
        tm.weight.grad = tm.bias.grad = None
    # Eval mode normalises with the running statistics.
    jeval = fnn.BatchNorm(use_running_average=True, momentum=0.9, dtype=jnp.float32)
    want = jeval.apply({"params": variables["params"], "batch_stats": stats}, x1)
    np.testing.assert_allclose(tm(torch.tensor(x1)).detach().numpy(), np.asarray(want), atol=ATOL)


def _perturbed_stats(stats, seed):
    """Running statistics that are not the init's (mean 0, var 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key == "mean":
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


BACKBONES = {
    "res2net_26w4s": (lambda: jresnet2d.Res2Net2D(), lambda: Res2Net2D(), (32, 32, 3)),
    "res2net_14w8s": (lambda: jresnet2d.Res2Net2D(base_width=14, scales=8),
                      lambda: Res2Net2D(base_width=14, scales=8), (32, 32, 3)),
    "resnet10": (lambda: jresnet3d.ResNet3D(blocks=(1, 1, 1, 1)), lambda: ResNet3D(blocks=(1, 1, 1, 1)),
                 (16, 16, 16, 1)),
    "resnet18": (lambda: jresnet3d.ResNet3D(blocks=(2, 2, 2, 2)), lambda: ResNet3D(blocks=(2, 2, 2, 2)),
                 (18, 16, 16, 1)),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_matches_flax(name):
    """Eval mode at batch 2, 1e-5 of the largest magnitude.  Train mode at
    batch 8, held against the port's backbone made f64: Res2Net-50's
    train-mode BatchNorms amplify f32 rounding (see
    ``test_torch_baselines.py``), so flax's result is within 1e-5 of it, or
    else within ``WITNESS`` times the f32 spread, the larger of the port's
    own f32 error and flax's own change when each input element moves by
    two ulps at random; the updated BN statistics likewise."""
    make_j, make_t, shape = BACKBONES[name]
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, *shape)).astype(np.float32)
    jm = make_j()
    variables = _np(jax.jit(lambda: jm.init(jax.random.key(0), x, train=True))())
    variables["batch_stats"] = _perturbed_stats(variables["batch_stats"], 6)
    tm = load_flax_variables(make_t(), variables["params"], variables["batch_stats"])
    tm64 = copy.deepcopy(tm).double()

    fmap_j, pooled_j = jax.jit(lambda v: jm.apply(v, x, train=False))(variables)
    fmap_t, pooled_t = tm(torch.tensor(x), train=False)
    assert fmap_t.shape == fmap_j.shape and pooled_t.shape == pooled_j.shape
    assert _rel_err(fmap_t.detach().numpy(), fmap_j) < 1e-5
    assert _rel_err(pooled_t.detach().numpy(), pooled_j) < 1e-5

    x8 = rng.uniform(size=(8, *shape)).astype(np.float32)
    x8_p = (x8 * (1.0 + 2.0 ** -22 * rng.choice(np.array([-1.0, 1.0], np.float32), x8.shape))).astype(np.float32)
    train = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))
    (fmap_j, pooled_j), upd = train(variables, x8)
    (fmap_p, pooled_p), upd_p = train(variables, x8_p)
    fmap_t, pooled_t = tm(torch.tensor(x8), train=True)
    fmap_64, pooled_64 = tm64(torch.tensor(x8), train=True)

    def check(want, want_p, got, got_64, bar, what):
        want, want_p, got, got_64 = (np.asarray(a, np.float64) for a in (want, want_p, got, got_64))
        spread = max(np.abs(want_p - want).max(), np.abs(got - got_64).max())
        err = np.abs(want - got_64).max()
        assert err <= max(bar, WITNESS * spread), (what, err, spread)

    for want, want_p, got, got_64, what in ((fmap_j, fmap_p, fmap_t, fmap_64, "map"),
                                            (pooled_j, pooled_p, pooled_t, pooled_64, "pooled")):
        check(want, want_p, got.detach(), got_64.detach(), 1e-5 * float(np.abs(want).max()), what)
    stats, stats_64 = dict(tm.named_buffers()), dict(tm64.named_buffers())
    flat_p = dict(jax.tree_util.tree_flatten_with_path(_np(upd_p["batch_stats"]))[0])
    for path, want in jax.tree_util.tree_flatten_with_path(_np(upd["batch_stats"]))[0]:
        keys = [p.key for p in path]
        name_t = ".".join(keys[:-1] + [{"mean": "running_mean", "var": "running_var"}[keys[-1]]])
        check(want, flat_p[path], stats[name_t], stats_64[name_t], 1e-5 * max(float(np.abs(want).max()), 1.0),
              "/".join(keys))
