"""The train augmentations on the batch's device (``edrl_tpu/data/device_augment.py``).

With device noise on, the host ships one clean batch and the train step
augments it where it lies: the reference's ColorJitter(0.2, 0.2, 0.2,
0.1) @ p=0.8, RandomGrayscale @ p=0.2 and RandomHorizontalFlip on the fundus
(``code/data_harvard.py:621-634``), the horizontal flip on the OCT.  As in
the JAX package, the jitter's order is fixed (brightness, contrast,
saturation, hue) and every draw is per sample.

Each augmentation is a *draw* (``draw_fundus_augment``, ``draw_oct_augment``:
``[B]`` tensors from a ``torch.Generator``; under a data axis, this rank's
rows of the global batch's, ``parallel.draw_rows``) and an *apply* that
takes the draws.  The JAX package draws from threefry keys, which torch cannot replay;
its draws, recorded in call order (``apply``, ``f_b``, ``f_c``, ``f_s``,
``f_h``, ``to_gray``, ``flip``, then the OCT's ``flip``), go into the apply
unchanged, which is how the tests hold the two to each other.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from edrl_tpu_torch.parallel.mesh import draw_rows

FUNDUS_DRAWS = ("apply", "f_b", "f_c", "f_s", "f_h", "to_gray", "flip")
_GRAY = (0.299, 0.587, 0.114)


def _bc(v: torch.Tensor) -> torch.Tensor:
    """A ``[B]`` factor broadcast over ``[B, H, W, C]``."""
    return v[:, None, None, None]


def _gray(x: torch.Tensor) -> torch.Tensor:
    """``x @ _GRAY`` in f32: ``[..., 3]`` -> ``[...]``."""
    return x @ torch.tensor(_GRAY, dtype=torch.float32, device=x.device)


def _rgb_to_hsv(r, g, b):
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    spread = maxc - minc
    s = torch.where(maxc > 0, spread / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(spread, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    # jnp's % on floats is the floor modulo: torch.remainder, not fmod.
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(spread == 0, 0.0, h)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # jnp.select over the six sectors; exactly one matches, so a gather
    # picks what its first match picks.
    i = torch.remainder(i.to(torch.int32), 6).long()[..., None]
    r = torch.stack([v, q, p, p, t, v], -1).gather(-1, i)[..., 0]
    g = torch.stack([t, v, v, q, p, p], -1).gather(-1, i)[..., 0]
    b = torch.stack([p, p, t, v, v, q], -1).gather(-1, i)[..., 0]
    return r, g, b


def draw_fundus_augment(batch: int, generator: torch.Generator, device,
                        jitter_strength: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.1),
                        ) -> Dict[str, torch.Tensor]:
    """The fundus augmentation's draws, ``[B]`` each, in the JAX package's
    order: the jitter's gate, its four factors (uniform in ``[1 - s, 1 + s)``,
    the hue's in ``[-s, s)``), the grayscale and the flip gates."""
    br, ct, sat, hue = jitter_strength
    bounds = {"apply": (0.0, 1.0), "f_b": (1 - br, 1 + br), "f_c": (1 - ct, 1 + ct),
              "f_s": (1 - sat, 1 + sat), "f_h": (-hue, hue), "to_gray": (0.0, 1.0), "flip": (0.0, 1.0)}
    out = {}
    for name in FUNDUS_DRAWS:
        lo, hi = bounds[name]
        out[name] = draw_rows(torch.rand, (batch,), generator, device) * (hi - lo) + lo
    return out


def apply_fundus_augment(x: torch.Tensor, draws: Dict[str, torch.Tensor], jitter_prob: float = 0.8,
                         grayscale_prob: float = 0.2, hflip_prob: float = 0.5) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 1] -> augmented, with the given draws."""
    x = x.float()
    apply = draws["apply"] < jitter_prob
    f_b = torch.where(apply, draws["f_b"], 1.0)
    f_c = torch.where(apply, draws["f_c"], 1.0)
    f_s = torch.where(apply, draws["f_s"], 1.0)
    f_h = torch.where(apply, draws["f_h"], 0.0)

    # brightness
    x = torch.clamp(x * _bc(f_b), 0.0, 1.0)
    # contrast: blend toward the image's gray mean
    mean = _gray(x).mean(dim=(1, 2))[:, None, None, None]
    x = torch.clamp(_bc(f_c) * x + (1.0 - _bc(f_c)) * mean, 0.0, 1.0)
    # saturation: blend toward each pixel's gray
    gray = _gray(x)[..., None]
    x = torch.clamp(_bc(f_s) * x + (1.0 - _bc(f_s)) * gray, 0.0, 1.0)
    # hue rotation
    h, s, v = _rgb_to_hsv(x[..., 0], x[..., 1], x[..., 2])
    h = torch.remainder(h + f_h[:, None, None], 1.0)
    x = torch.clamp(torch.stack(_hsv_to_rgb(h, s, v), dim=-1), 0.0, 1.0)

    # random grayscale
    to_gray = draws["to_gray"] < grayscale_prob
    x = torch.where(_bc(to_gray), _gray(x)[..., None].expand_as(x), x)
    # horizontal flip: W is axis 2 of [B, H, W, 3]
    flip = draws["flip"] < hflip_prob
    return torch.where(_bc(flip), torch.flip(x, dims=(2,)), x)


def augment_fundus_batch(x: torch.Tensor, generator: Optional[torch.Generator], jitter_prob: float = 0.8,
                         jitter_strength: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.1),
                         grayscale_prob: float = 0.2, hflip_prob: float = 0.5, *,
                         draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """``augment_fundus_batch`` of the JAX package: apply ``draws``, or else
    what ``draw_fundus_augment`` draws from ``generator``."""
    if draws is None:
        draws = draw_fundus_augment(x.shape[0], generator, x.device, jitter_strength)
    return apply_fundus_augment(x, draws, jitter_prob, grayscale_prob, hflip_prob)


def draw_oct_augment(batch: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The OCT flip's gate, ``[B]``."""
    return {"flip": draw_rows(torch.rand, (batch,), generator, device)}


def apply_oct_augment(x: torch.Tensor, draws: Dict[str, torch.Tensor], hflip_prob: float = 0.5) -> torch.Tensor:
    """``[B, D, H, W, 1]`` -> flipped along W (axis 3) where the gate is below ``hflip_prob``."""
    flip = (draws["flip"] < hflip_prob)[:, None, None, None, None]
    return torch.where(flip, torch.flip(x, dims=(3,)), x)


def augment_oct_batch(x: torch.Tensor, generator: Optional[torch.Generator], hflip_prob: float = 0.5, *,
                      draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """``augment_oct_batch`` of the JAX package: apply ``draws``, or else
    what ``draw_oct_augment`` draws from ``generator``."""
    if draws is None:
        draws = draw_oct_augment(x.shape[0], generator, x.device)
    return apply_oct_augment(x, draws, hflip_prob)
