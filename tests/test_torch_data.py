"""The port's input path against the JAX package's, on the CPU.

The host path is numpy on both sides (the synthetic datasets, ``kfold_split``,
``BatchLoader``, the host noise and augmentations): the same seeds give the
same bytes, held by ``np.array_equal``.  The on-device augmentation and
noise are torch here and threefry-keyed JAX there: JAX's draws are recorded
as they are made (``test_torch_train.record_jax_draws``) and fed to the
port's apply functions, whose outputs are held at f32 atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.config import NoiseConfig as JaxNoiseConfig
from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.data import device_augment as jaug
from edrl_tpu.data import device_noise as jnoise
from edrl_tpu.data import loader as jloader
from edrl_tpu.data import noise as jhost_noise
from edrl_tpu.data import synthetic as jsynthetic
from edrl_tpu.data import transforms as jtransforms
from edrl_tpu_torch.config import NoiseConfig, tiny_test_config
from edrl_tpu_torch.data import device_augment as aug
from edrl_tpu_torch.data import device_noise as noise
from edrl_tpu_torch.data import loader, synthetic, transforms
from edrl_tpu_torch.data import noise as host_noise
from test_torch_train import record_jax_draws

ATOL = 1e-6
NOISE = {
    "gaussian": dict(condition_name="Gaussian", gaussian_low=0.1, gaussian_high=0.5),
    "salt_pepper": dict(condition_name="SaltPepper", salt_pepper_low=0.01, salt_pepper_high=0.05),
    "all": dict(condition_name="All", gaussian_low=0.1, gaussian_high=0.5, salt_pepper_low=0.01,
                salt_pepper_high=0.05),
    "sigma_0": dict(condition_name="Gaussian", gaussian_low=0.0, gaussian_high=0.0),
    "all_sigma_0": dict(condition_name="All", gaussian_low=0.0, gaussian_high=0.3, salt_pepper_low=0.0,
                        salt_pepper_high=0.02),
    "normal": dict(condition="normal"),
}


def _data_configs(**kw):
    jd, td = jax_tiny_config().data, tiny_test_config().data
    return dataclasses.replace(jd, **kw), dataclasses.replace(td, **kw)


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key


# ---------------------------------------------------------------------------
# The host path: copies of numpy code, byte for byte.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_noise", [True, False], ids=["device_noise", "host_noise"])
@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("name", sorted(synthetic.SYNTHETIC_DATASETS))
def test_synthetic_datasets_match(name, mode, device_noise):
    jd, td = _data_configs(device_noise=device_noise, noise=JaxNoiseConfig(**NOISE["all"]))
    td = dataclasses.replace(td, noise=NoiseConfig(**NOISE["all"]))
    want_ds = jsynthetic.SYNTHETIC_DATASETS[name](jd, mode=mode)
    got_ds = synthetic.SYNTHETIC_DATASETS[name](td, mode=mode)
    assert len(got_ds) == len(want_ds)
    for index, epoch in ((0, 0), (3, 1), (5, 2)):
        _assert_same(got_ds.get(index, epoch), want_ds.get(index, epoch))


def test_kfold_split_matches():
    items = [f"{i:04d}" for i in range(23)]
    for (gt, gv), (wt, wv) in zip(loader.kfold_split(items, 5, 10), jloader.kfold_split(items, 5, 10)):
        assert np.array_equal(gt, wt) and np.array_equal(gv, wv)


@pytest.mark.parametrize("shuffle,drop_last,uint8", [(True, True, True), (False, False, True), (True, False, False)])
def test_batch_loader_epochs_match(shuffle, drop_last, uint8):
    """Epoch-indexed shuffles, drop_last and the remainder, uint8 transport:
    the same batches from both loaders over the same samples."""
    jd, td = _data_configs(device_noise=uint8, num_synthetic_samples=10)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3, num_workers=2, uint8_transport=uint8)
    want = jloader.BatchLoader(jsynthetic.SyntheticGammaDataset(jd), 4, **kw)
    got = loader.BatchLoader(synthetic.SyntheticGammaDataset(td), 4, **kw)
    assert len(got) == len(want) == (2 if drop_last else 3)
    for epoch in (0, 1):
        gb, wb = list(got.epoch(epoch)), list(want.epoch(epoch))
        assert len(gb) == len(wb) == len(want)
        for g, w in zip(gb, wb):
            _assert_same(g, w)
    if uint8:
        assert gb[0]["fundus"].dtype == np.uint8 and gb[0]["oct"].shape[-1] == 1


@pytest.mark.parametrize("case", sorted(NOISE))
def test_host_noise_views_match(case):
    rng = np.random.default_rng(0)
    fundus = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    oct_vol = rng.uniform(size=(8, 8, 8)).astype(np.float32)
    got = host_noise.make_noise_views(fundus, oct_vol, NoiseConfig(**NOISE[case]), host_noise.sample_rng(1, 2, 3))
    want = jhost_noise.make_noise_views(fundus, oct_vol, JaxNoiseConfig(**NOISE[case]),
                                        jhost_noise.sample_rng(1, 2, 3))
    _assert_same(got, want)


def test_host_augmentations_match():
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    vol = rng.uniform(size=(8, 8, 8)).astype(np.float32)
    for seed in range(6):
        for fn, jfn, x in ((transforms.fundus_train_augment, jtransforms.fundus_train_augment, img),
                           (transforms.oct_train_augment, jtransforms.oct_train_augment, vol)):
            got, want = fn(x, np.random.default_rng(seed)), jfn(x, np.random.default_rng(seed))
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for name in ("adjust_brightness", "adjust_contrast", "adjust_saturation", "adjust_hue"):
        assert np.array_equal(getattr(transforms, name)(img, 0.93), getattr(jtransforms, name)(img, 0.93))
    assert np.array_equal(transforms.to_grayscale(img), jtransforms.to_grayscale(img))


# ---------------------------------------------------------------------------
# The device path: JAX's recorded draws through the port's apply.
# ---------------------------------------------------------------------------


def _new_rec():
    return {"uniform": [], "normal": [], "dropout": []}


def _t(a):
    return torch.tensor(np.asarray(a))


def fundus_draws(uniforms):
    """JAX's seven recorded fundus draws, in call order, as the port's mapping."""
    return dict(zip(aug.FUNDUS_DRAWS, map(_t, uniforms)))


def view_draws(rec, cfg: NoiseConfig, fundus_shape, oct_shape, views=("low", "high")):
    """JAX's recorded noise draws, taken in order from ``rec``, as
    ``device_noise.draw_views``' mapping (or one view's)."""
    normals, uniforms = iter(rec["normal"]), iter(rec["uniform"])
    sizes = {"low": (cfg.gaussian_low, cfg.salt_pepper_low), "high": (cfg.gaussian_high, cfg.salt_pepper_high)}
    out = {}
    for view in views:
        # The port's own draw, to learn which tensors a view takes.
        like = noise.draw_corruption(fundus_shape, oct_shape, cfg, *sizes[view], torch.Generator(), "cpu")
        out[view] = {k: _t(next(normals if k.endswith("gaussian") else uniforms)) for k in like}
    assert next(normals, None) is None and next(uniforms, None) is None
    return out


def _images(seed, b=6, h=16, d=8):
    rng = np.random.default_rng(seed)
    # Gray, saturated and out-of-[0, 1]-after-jitter pixels all occur.
    fundus = rng.uniform(size=(b, h, h, 3)).astype(np.float32)
    fundus[0, :4] = fundus[0, :4, :, :1]
    fundus[1, :2, :, 0] = 1.0
    oct_vol = rng.uniform(size=(b, d, d, d, 1)).astype(np.float32)
    return fundus, oct_vol


@pytest.mark.parametrize("jitter_prob,grayscale_prob", [(0.8, 0.2), (1.0, 0.0), (1.0, 1.0)])
def test_augment_fundus_batch_matches(jitter_prob, grayscale_prob):
    fundus, _ = _images(2)
    rec = _new_rec()
    kw = dict(jitter_prob=jitter_prob, grayscale_prob=grayscale_prob, hflip_prob=0.5)
    with record_jax_draws(rec):
        want = jaug.augment_fundus_batch(jnp.asarray(fundus), jax.random.key(4), **kw)
    assert len(rec["uniform"]) == 7 and not rec["normal"]
    got = aug.augment_fundus_batch(torch.tensor(fundus), None, draws=fundus_draws(rec["uniform"]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_augment_fundus_hue_wraps_as_jax():
    """Large hue shifts of both signs: the floor-mod wrap and every HSV sector."""
    fundus, _ = _images(3, b=8)
    f_h = np.array([-0.5, -0.45, -0.2, -0.01, 0.01, 0.2, 0.45, 0.499], np.float32)
    jx = jnp.asarray(fundus)
    # JAX's own arithmetic on the same factors, through its helpers.
    h, s, v = jaug._rgb_to_hsv(jx[..., 0], jx[..., 1], jx[..., 2])
    want = jnp.clip(jnp.stack(jaug._hsv_to_rgb((h + f_h[:, None, None]) % 1.0, s, v), axis=-1), 0.0, 1.0)
    th, ts, tv = aug._rgb_to_hsv(*torch.tensor(fundus).unbind(-1))
    got = torch.clamp(torch.stack(aug._hsv_to_rgb(torch.remainder(th + _t(f_h)[:, None, None], 1.0), ts, tv), -1),
                      0.0, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_augment_oct_batch_matches():
    _, oct_vol = _images(4)
    rec = _new_rec()
    with record_jax_draws(rec):
        want = jaug.augment_oct_batch(jnp.asarray(oct_vol), jax.random.key(5), 0.5)
    assert len(rec["uniform"]) == 1
    got = aug.augment_oct_batch(torch.tensor(oct_vol), None, 0.5, draws={"flip": _t(rec["uniform"][0])})
    assert np.array_equal(got.numpy(), np.asarray(want))
    flipped = (np.asarray(rec["uniform"][0]) < 0.5)
    assert 0 < flipped.sum() < len(flipped), "the case must flip some samples and not others"


@pytest.mark.parametrize("case", sorted(NOISE))
def test_make_views_device_matches(case):
    fundus, oct_vol = _images(6)
    rec = _new_rec()
    with record_jax_draws(rec):
        want = jnoise.make_views_device(jnp.asarray(fundus), jnp.asarray(oct_vol), JaxNoiseConfig(**NOISE[case]),
                                        jax.random.key(8))
    cfg = NoiseConfig(**NOISE[case])
    draws = view_draws(rec, cfg, fundus.shape, oct_vol.shape)
    got = noise.make_views_device(torch.tensor(fundus), torch.tensor(oct_vol), cfg, None, draws=draws)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0, err_msg=key)
    if case == "sigma_0":
        assert draws == {"low": {}, "high": {}}
        assert all(np.array_equal(got[k].numpy(), fundus if k.startswith("fundus") else oct_vol) for k in got)


@pytest.mark.parametrize("case", ["gaussian", "salt_pepper", "all", "sigma_0"])
def test_make_low_view_device_matches(case):
    fundus, oct_vol = _images(7)
    rec = _new_rec()
    with record_jax_draws(rec):
        want = jnoise.make_low_view_device(jnp.asarray(fundus), jnp.asarray(oct_vol), JaxNoiseConfig(**NOISE[case]),
                                           jax.random.key(9))
    cfg = NoiseConfig(**NOISE[case])
    draws = view_draws(rec, cfg, fundus.shape, oct_vol.shape, views=("low",))["low"]
    got = noise.make_low_view_device(torch.tensor(fundus), torch.tensor(oct_vol), cfg, None, draws=draws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_salt_pepper_shares_one_mask_over_channels():
    cfg = NoiseConfig(**NOISE["salt_pepper"])
    x = torch.full((2, 8, 8, 3), 0.5)
    u = torch.rand((2, 8, 8, 1), generator=torch.Generator().manual_seed(0))
    u[0, 0, 0], u[0, 0, 1] = 0.001, 0.999
    out, _ = noise.apply_corruption(x, torch.full((2, 4, 4, 4, 1), 0.5), cfg, 0.0, 0.05,
                                    {"fundus_salt_pepper": u, "oct_salt_pepper": torch.rand(2, 4, 4, 4, 1)})
    assert torch.equal(out[0, 0, 0], torch.ones(3)) and torch.equal(out[0, 0, 1], torch.zeros(3))
    assert ((out == 0.5).all(-1) | (out == 0.0).all(-1) | (out == 1.0).all(-1)).all()


def test_draws_follow_the_generator_and_zero_draws_nothing():
    """A seeded generator gives the same views twice; sigma 0 and amount 0
    draw nothing, so the generator's state does not move."""
    cfg = NoiseConfig(**NOISE["all"])
    fundus, oct_vol = (torch.tensor(a) for a in _images(8))
    a = noise.make_views_device(fundus, oct_vol, cfg, torch.Generator().manual_seed(3))
    b = noise.make_views_device(fundus, oct_vol, cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    gen = torch.Generator().manual_seed(4)
    state = gen.get_state()
    zero = NoiseConfig(**NOISE["sigma_0"])
    assert noise.draw_views(fundus.shape, oct_vol.shape, zero, gen, "cpu") == {"low": {}, "high": {}}
    assert torch.equal(gen.get_state(), state)
    fa = aug.draw_fundus_augment(6, gen, "cpu")
    assert list(fa) == list(aug.FUNDUS_DRAWS)
    assert ((fa["f_b"] >= 0.8) & (fa["f_b"] < 1.2)).all() and ((fa["f_h"] >= -0.1) & (fa["f_h"] < 0.1)).all()
