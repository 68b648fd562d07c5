"""Host-side input-corruption noise (``edrl_tpu/data/noise.py``, copied).

The dual-view construction of the reference's ``GAMMA_dataset.__getitem__``
(``code/data_harvard.py:24-48,701-814``) in numpy: every low/high knob is a
``NoiseConfig`` field, and each (sample, epoch) pair gets its own
``np.random.Generator``.  A copy of the JAX package's module, so the host
noise path gives the same bytes from the same seeds.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from edrl_tpu_torch.config import NoiseConfig


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Per-(sample, epoch) generator — the JAX-style keyed-PRNG discipline
    applied to the host pipeline."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, index]))


def add_gaussian(img: np.ndarray, sigma: float, rng: np.random.Generator) -> np.ndarray:
    """Additive Gaussian noise, clipped to [0, 1] (``code/data_harvard.py:716-728``)."""
    if sigma <= 0.0:
        return img
    noisy = img + rng.normal(0.0, sigma, img.shape)
    return np.clip(noisy, 0.0, 1.0).astype(np.float32)


def add_salt_pepper(
    img: np.ndarray, amount: float, rng: np.random.Generator
) -> np.ndarray:
    """Salt-and-pepper corruption (``code/data_harvard.py:24-48``).

    A fraction ``amount`` of pixels is set to 1 (salt) and another fraction
    ``amount`` to 0 (pepper), applied across the full array (2-D slice or
    3-D volume alike — the reference's per-slice loop collapses to one
    vectorized mask).
    """
    if amount <= 0.0:
        return img
    u = rng.random(img.shape[:2] if img.ndim == 3 and img.shape[-1] == 3 else img.shape)
    if img.ndim == 3 and img.shape[-1] == 3:
        u = u[..., None]  # corrupt whole RGB pixels together
    out = img.copy()
    out = np.where(u < amount, 1.0, out)
    out = np.where(u > 1.0 - amount, 0.0, out)
    return out.astype(np.float32)


def _corrupt(
    fundus: np.ndarray,
    oct_vol: np.ndarray,
    cfg: NoiseConfig,
    g_sigma: float,
    sp_amount: float,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    if cfg.condition != "noise":
        return fundus, oct_vol
    if cfg.condition_name == "Gaussian":
        return (
            add_gaussian(fundus, g_sigma, rng),
            add_gaussian(oct_vol, g_sigma, rng),
        )
    if cfg.condition_name == "SaltPepper":
        return (
            add_salt_pepper(fundus, sp_amount, rng),
            add_salt_pepper(oct_vol, sp_amount, rng),
        )
    # "All": Gaussian then salt-pepper on both modalities
    f = add_salt_pepper(add_gaussian(fundus, g_sigma, rng), sp_amount, rng)
    o = add_salt_pepper(add_gaussian(oct_vol, g_sigma, rng), sp_amount, rng)
    return f, o


def make_noise_views(
    fundus: np.ndarray,
    oct_vol: np.ndarray,
    cfg: NoiseConfig,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """Build the (low, high) corruption views of one sample.

    fundus: [H, W, 3] float32 in [0, 1]; oct_vol: [D, H, W] float32 in [0, 1].
    """
    f_low, o_low = _corrupt(
        fundus, oct_vol, cfg, cfg.gaussian_low, cfg.salt_pepper_low, rng
    )
    f_high, o_high = _corrupt(
        fundus, oct_vol, cfg, cfg.gaussian_high, cfg.salt_pepper_high, rng
    )
    return {
        "fundus_low": f_low,
        "oct_low": o_low,
        "fundus_high": f_high,
        "oct_high": o_high,
    }
