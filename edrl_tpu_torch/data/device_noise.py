"""The dual noise views on the batch's device (``edrl_tpu/data/device_noise.py``).

With ``DataConfig.device_noise`` on, the loader ships one clean batch and the
train and eval steps build the low- and high-noise views where the batch
lies: additive Gaussian noise clipped to [0, 1], salt-and-pepper by pixel
(one mask over the channel axis).  The two views share one augmentation
draw and differ only by their corruption, as in the JAX package.

As in ``device_augment``, each view is a *draw* (``draw_corruption``: a
mapping of noise tensors from a ``torch.Generator``) and an *apply*
(``apply_corruption``).  A zero sigma or amount draws nothing, as in the JAX
package, so a list of JAX's recorded draws maps onto the same keys in order:
per view, the fundus's normal (``"fundus_gaussian"``) and uniform
(``"fundus_salt_pepper"``), then the OCT's; the low view before the high.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from edrl_tpu_torch.config import NoiseConfig


def _kinds(cfg: NoiseConfig, sigma: float, amount: float) -> Tuple[str, ...]:
    """The corruptions a view applies, in the JAX package's order."""
    if cfg.condition != "noise":
        return ()
    kinds = {"Gaussian": ("gaussian",), "SaltPepper": ("salt_pepper",)}.get(
        cfg.condition_name, ("gaussian", "salt_pepper"))
    return tuple(k for k in kinds if (sigma if k == "gaussian" else amount) > 0.0)


def draw_corruption(fundus_shape, oct_shape, cfg: NoiseConfig, sigma: float, amount: float,
                    generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One view's noise: a standard normal of each input's shape for the
    Gaussian, a uniform of its shape less the channel axis (kept as 1) for
    salt-and-pepper."""
    out = {}
    for name, shape in (("fundus", tuple(fundus_shape)), ("oct", tuple(oct_shape))):
        for kind in _kinds(cfg, sigma, amount):
            if kind == "gaussian":
                out[f"{name}_gaussian"] = torch.randn(shape, generator=generator, device=device)
            else:
                out[f"{name}_salt_pepper"] = torch.rand(shape[:-1] + (1,), generator=generator, device=device)
    return out


def _gaussian(x: torch.Tensor, sigma: float, noise: Optional[torch.Tensor]) -> torch.Tensor:
    if sigma <= 0.0:
        return x
    return torch.clamp(x + sigma * noise, 0.0, 1.0)


def _salt_pepper(x: torch.Tensor, amount: float, u: Optional[torch.Tensor]) -> torch.Tensor:
    if amount <= 0.0:
        return x
    x = torch.where(u < amount, 1.0, x)
    return torch.where(u > 1.0 - amount, 0.0, x)


def apply_corruption(fundus: torch.Tensor, oct_vol: torch.Tensor, cfg: NoiseConfig, sigma: float,
                     amount: float, draws: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view from the clean ``[B,H,W,3]`` / ``[B,D,H,W,1]`` and its draws."""
    kinds = _kinds(cfg, sigma, amount)
    out = []
    for name, x in (("fundus", fundus), ("oct", oct_vol)):
        if "gaussian" in kinds:
            x = _gaussian(x, sigma, draws[f"{name}_gaussian"])
        if "salt_pepper" in kinds:
            x = _salt_pepper(x, amount, draws[f"{name}_salt_pepper"])
        out.append(x)
    return out[0], out[1]


def draw_views(fundus_shape, oct_shape, cfg: NoiseConfig, generator: torch.Generator,
               device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The draws of both views: ``{"low": ..., "high": ...}``."""
    return {
        "low": draw_corruption(fundus_shape, oct_shape, cfg, cfg.gaussian_low, cfg.salt_pepper_low,
                               generator, device),
        "high": draw_corruption(fundus_shape, oct_shape, cfg, cfg.gaussian_high, cfg.salt_pepper_high,
                                generator, device),
    }


def apply_views(fundus: torch.Tensor, oct_vol: torch.Tensor, cfg: NoiseConfig,
                draws: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The four view tensors from the clean batch and ``draw_views``' draws."""
    f_low, o_low = apply_corruption(fundus, oct_vol, cfg, cfg.gaussian_low, cfg.salt_pepper_low, draws["low"])
    f_high, o_high = apply_corruption(fundus, oct_vol, cfg, cfg.gaussian_high, cfg.salt_pepper_high,
                                      draws["high"])
    return {"fundus_low": f_low, "oct_low": o_low, "fundus_high": f_high, "oct_high": o_high}


def make_views_device(fundus: torch.Tensor, oct_vol: torch.Tensor, cfg: NoiseConfig,
                      generator: Optional[torch.Generator], *,
                      draws: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None) -> Dict[str, torch.Tensor]:
    """Clean ``[B,H,W,3]`` / ``[B,D,H,W,1]`` -> the four views, from ``draws``
    or else from what ``draw_views`` draws from ``generator``."""
    if draws is None:
        draws = draw_views(fundus.shape, oct_vol.shape, cfg, generator, fundus.device)
    return apply_views(fundus, oct_vol, cfg, draws)


def make_low_view_device(fundus: torch.Tensor, oct_vol: torch.Tensor, cfg: NoiseConfig,
                         generator: Optional[torch.Generator], *,
                         draws: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The low view only (``fusion_train.py:277``), from ``draws`` or else
    from what ``draw_corruption`` draws from ``generator``: the eval path's
    view, and the train step's when it skips the second forward."""
    if draws is None:
        draws = draw_corruption(fundus.shape, oct_vol.shape, cfg, cfg.gaussian_low, cfg.salt_pepper_low,
                                generator, fundus.device)
    return apply_corruption(fundus, oct_vol, cfg, cfg.gaussian_low, cfg.salt_pepper_low, draws)
