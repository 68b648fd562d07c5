"""Host-side augmentations in numpy (``edrl_tpu/data/transforms.py:17-128``, copied).

The torchvision transform stacks of the reference's ``GAMMA_dataset``
(``code/data_harvard.py:621-645``): fundus train = ColorJitter(0.2, 0.2,
0.2, 0.1) @ p=0.8, RandomGrayscale @ p=0.2, RandomHorizontalFlip; OCT train =
RandomHorizontalFlip; val = identity.  All randomness flows through an
explicit ``np.random.Generator``.  The resizes the real-data readers need
(``resize_image``, ``resize_volume``) come with those readers.
"""

from __future__ import annotations

import numpy as np

_GRAY = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 1.0).astype(np.float32)


def adjust_brightness(img, factor):
    return _blend(img, 0.0, factor)


def adjust_contrast(img, factor):
    mean = (img @ _GRAY).mean()
    return _blend(img, mean, factor)


def adjust_saturation(img, factor):
    gray = (img @ _GRAY)[..., None]
    return _blend(img, gray, factor)


def adjust_hue(img, delta):
    """Hue rotation by ``delta`` (in turns, [-0.5, 0.5]) via HSV round-trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    spread = maxc - minc
    s = np.where(maxc > 0, spread / np.maximum(maxc, 1e-12), 0.0)
    spread_safe = np.maximum(spread, 1e-12)
    rc = (maxc - r) / spread_safe
    gc = (maxc - g) / spread_safe
    bc = (maxc - b) / spread_safe
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = (h / 6.0) % 1.0
    h = np.where(spread == 0, 0.0, h)
    h = (h + delta) % 1.0
    # HSV -> RGB
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([v, t, p], -1),
            np.stack([q, v, p], -1),
            np.stack([p, v, t], -1),
            np.stack([p, q, v], -1),
            np.stack([t, p, v], -1),
            np.stack([v, p, q], -1),
        ],
    )
    return out.astype(np.float32)


def color_jitter(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.2,
    contrast: float = 0.2,
    saturation: float = 0.2,
    hue: float = 0.1,
) -> np.ndarray:
    """torchvision-style ColorJitter: each factor uniform around 1 (hue
    around 0), applied in a random order."""
    ops = []
    if brightness > 0:
        ops.append(lambda x: adjust_brightness(x, rng.uniform(1 - brightness, 1 + brightness)))
    if contrast > 0:
        ops.append(lambda x: adjust_contrast(x, rng.uniform(1 - contrast, 1 + contrast)))
    if saturation > 0:
        ops.append(lambda x: adjust_saturation(x, rng.uniform(1 - saturation, 1 + saturation)))
    if hue > 0:
        ops.append(lambda x: adjust_hue(x, rng.uniform(-hue, hue)))
    for idx in rng.permutation(len(ops)):
        img = ops[idx](img)
    return img


def to_grayscale(img: np.ndarray) -> np.ndarray:
    gray = (img @ _GRAY)[..., None]
    return np.repeat(gray, 3, axis=-1).astype(np.float32)


def fundus_train_augment(
    img: np.ndarray,
    rng: np.random.Generator,
    jitter_prob: float = 0.8,
    grayscale_prob: float = 0.2,
    hflip_prob: float = 0.5,
    jitter_strength=(0.2, 0.2, 0.2, 0.1),
) -> np.ndarray:
    """[H, W, 3] in [0,1] -> augmented, same shape."""
    if rng.random() < jitter_prob:
        img = color_jitter(img, rng, *jitter_strength)
    if rng.random() < grayscale_prob:
        img = to_grayscale(img)
    if rng.random() < hflip_prob:
        img = img[:, ::-1].copy()
    return img


def oct_train_augment(
    vol: np.ndarray, rng: np.random.Generator, hflip_prob: float = 0.5
) -> np.ndarray:
    """[D, H, W] -> horizontally flipped with prob 0.5."""
    if rng.random() < hflip_prob:
        vol = vol[:, :, ::-1].copy()
    return vol
