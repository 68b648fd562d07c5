"""Host-side augmentations in numpy (``edrl_tpu/data/transforms.py:17-128``, copied).

The torchvision transform stacks of the reference's ``GAMMA_dataset``
(``code/data_harvard.py:621-645``): fundus train = ColorJitter(0.2, 0.2,
0.2, 0.1) @ p=0.8, RandomGrayscale @ p=0.2, RandomHorizontalFlip; OCT train =
RandomHorizontalFlip; val = identity.  All randomness flows through an
explicit ``np.random.Generator``.

The resizes of the real-data readers (``:130-172``): ``resize_image`` is
OpenCV's ``INTER_CUBIC`` in numpy (the JAX package calls ``cv2.resize``),
``_zoom_indices`` and ``resize_volume`` are copied.
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


def _cubic_taps(src: int, dst: int, dtype) -> tuple:
    """OpenCV's ``INTER_CUBIC`` taps for one axis: the source indices [dst, 4]
    (clamped to the border) and their weights [dst, 4] in ``dtype``.

    Output i samples source x = (i + 0.5) * src / dst - 0.5; the weights are
    the cubic convolution kernel with A = -0.75 at the four nearest samples,
    computed in float64 and rounded to ``dtype``."""
    x = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    left = np.floor(x)
    t = (x - left)[:, None] + np.array([1.0, 0.0, -1.0, -2.0])  # distance to each tap
    d = np.abs(t)
    a = -0.75
    w = np.where(d <= 1.0, ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0,
                 ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a)
    idx = np.clip(left.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, w.astype(dtype)


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """Square resize of an [H, W, C] float image, as ``cv2.resize(img, (size,
    size), interpolation=cv2.INTER_CUBIC)`` gives it (parity with
    ``scale_image``, ``code/data_harvard.py:169-174``): separable, the
    horizontal pass first, each pass's four products summed in order in the
    image's float type (float32 unless it is float64).  Not
    ``torch.nn.functional.interpolate(mode="bicubic")``, whose results are
    not OpenCV's."""
    dtype = np.float64 if img.dtype == np.float64 else np.float32
    img = np.asarray(img, dtype)
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img.copy()
    for axis, n in ((1, w), (0, h)):
        idx, wt = _cubic_taps(n, size, dtype)
        shape = (-1,) + (1,) * (img.ndim - 1 - axis)
        out = np.take(img, idx[:, 0], axis=axis) * wt[:, 0].reshape(shape)
        for k in range(1, 4):
            out += np.take(img, idx[:, k], axis=axis) * wt[:, k].reshape(shape)
        img = out
    return img


def _zoom_indices(d: int, od: int) -> np.ndarray:
    """ndimage.zoom(order=0)'s exact source-index map for one axis.

    scipy samples at ``round_half_up(i * (d-1)/(od-1))`` — verified
    empirically against scipy for up/downsampling and half-way cases
    (``tests/test_data.py``).  A plain ``floor(i*d/od)`` map picks a
    different source voxel for ~99.98% of outputs on a 256->96 downsample
    and never samples the last input slices.
    """
    if od <= 1:
        return np.zeros(max(od, 0), dtype=np.int64)
    x = np.arange(od) * ((d - 1) / (od - 1))
    return np.minimum(np.floor(x + 0.5).astype(np.int64), d - 1)


def resize_volume(vol: np.ndarray, out_shape) -> np.ndarray:
    """Nearest-neighbor zoom of a [D, H, W] volume to ``out_shape`` — parity
    with ``resize_oct_data_trans``/``ndimage.zoom(order=0)``
    (``code/data_harvard.py:176-183``), dependency-free."""
    d, h, w = vol.shape
    od, oh, ow = out_shape
    di, hi, wi = _zoom_indices(d, od), _zoom_indices(h, oh), _zoom_indices(w, ow)
    return vol[np.ix_(di, hi, wi)].astype(np.float32)
