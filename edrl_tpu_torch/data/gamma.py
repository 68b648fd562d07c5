"""GAMMA / Harvard-30K style on-disk dataset (``edrl_tpu/data/gamma.py``).

Rebuilds the active ``GAMMA_dataset`` (``code/data_harvard.py:598-857``):

- fundus: ``{root}/{id}/data_{id}_fundus.png`` (``:663-668``)
- OCT: ``{root}/{id}/data_{id}.nii`` with ``processed_data_{id}.nii``
  fallback (``:671-681``), stored (H, W, D) -> transposed to (D, H, W)
- labels: xlsx/csv with a ``data`` id column and one-hot ``class_*`` columns,
  consumed as argmax (``:645-646,838``)
- transformer path resize: fundus -> 384^2 cubic, OCT -> 96^3 zoom (``:686-688``)
- normalize /255, dual noise views, train augmentations.

Decoded and resized samples are memoized as uint8 to an uncompressed
``.npz`` next to the source files, under the JAX package's file name and
keys, so one tree's caches serve both packages.

The JAX package decodes the fundus with OpenCV and reads csv labels with
pandas; the port needs neither: PNGs go through ``data/png.py`` (what
``cv2.imread`` gives), csv through the standard library with pandas'
column typing kept (``read_csv``).  Only images in other formats, and the
OCT slice stacks of ``GammaSub1Dataset``, need PIL, and say so where it is
missing.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from edrl_tpu_torch.config import DataConfig
from edrl_tpu_torch.data.nifti import read_nifti
from edrl_tpu_torch.data.noise import make_noise_views, sample_rng
from edrl_tpu_torch.data.png import read_png
from edrl_tpu_torch.data.transforms import (
    color_jitter,
    fundus_train_augment,
    oct_train_augment,
    resize_image,
    resize_volume,
    to_grayscale,
)
from edrl_tpu_torch.data.xlsx import read_xlsx_rows

# pandas.read_csv's default missing-value strings, and its true/false words.
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A",
    "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*(e[+-]?\d+)?|\.\d+(e[+-]?\d+)?|inf|infinity)\s*", re.IGNORECASE)


def _slice_sort_key(name: str):
    """Depth-order key for OCT slice filenames: '2.jpg' < '10.jpg' <
    '100.jpg' (numeric on the first digit run; non-numeric names sort
    after, lexicographically)."""
    m = re.search(r"\d+", os.path.splitext(name)[0])
    return (0, int(m.group(0)), name) if m else (1, 0, name)


def _read_image(path: str) -> np.ndarray:
    """[H, W, 3] float32 RGB: a PNG through ``png.read_png`` (what
    ``cv2.imread(path)[..., ::-1]`` gives), any other format through PIL."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: only PNG is read without PIL, and PIL does not import here") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.float32)


def _column(cells: List[str]) -> np.ndarray:
    """One csv column typed as ``pandas.read_csv`` types it: int64 (ints, none
    missing), float64 (numbers, or ints with a missing cell, as NaN), bool,
    else object (the strings, NaN where missing)."""
    missing = [c in _NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if present and all(_INT.fullmatch(c) for c in present):
        ints = [int(c) for c in present]
        if all(-(2 ** 63) <= i < 2 ** 63 for i in ints):
            if not any(missing):
                return np.array(ints, np.int64)
            return np.array([np.nan if m else float(c) for c, m in zip(cells, missing)])
    elif all(_FLOAT.fullmatch(c) for c in present):
        return np.array([np.nan if m else float(c) for c, m in zip(cells, missing)])
    elif all(c in _TRUE or c in _FALSE for c in present):
        if not any(missing):
            return np.array([c in _TRUE for c in cells])
        return np.array([np.nan if m else c in _TRUE for c, m in zip(cells, missing)], dtype=object)
    return np.array([np.nan if m else c for c, m in zip(cells, missing)], dtype=object)


def read_csv(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """(header, columns) of a csv file, each column typed as ``pandas.read_csv``
    types it (``_column``); blank lines are skipped and short rows padded
    with missing cells."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    if not rows:
        raise ValueError(f"{path}: No columns to parse from file")
    header, body = rows[0], rows[1:]
    for line, row in enumerate(body, start=2):
        if len(row) > len(header):
            raise ValueError(f"{path}: expected {len(header)} fields in line {line}, saw {len(row)}")
    return header, [_column([row[j] if j < len(row) else "" for row in body]) for j in range(len(header))]


def _data_column(header: List[str]) -> int:
    if "data" not in header:
        raise KeyError("data")
    return header.index("data")


def csv_ids(path: str) -> List[str]:
    """The ``data`` column as ``pd.read_csv(path)["data"].astype(str)`` gives it."""
    header, columns = read_csv(path)
    return [str(v) for v in columns[_data_column(header)]]


def load_labels(label_file: str) -> Dict[str, np.ndarray]:
    """id -> one-hot row, from xlsx or csv.

    csv rows are read as the JAX package's ``DataFrame.iterrows`` reads them:
    a row takes the common type of all columns, so one float column (a
    missing cell) makes every id a float ("1" -> "001.0"), and a string
    column keeps each cell's own type.
    """
    out: Dict[str, np.ndarray] = {}
    if label_file.endswith(".csv"):
        header, columns = read_csv(label_file)
        j = _data_column(header)
        kinds = {c.dtype.kind for c in columns}
        dtype = (np.int64 if kinds == {"i"} else np.float64 if kinds <= {"i", "f"}
                 else bool if kinds == {"b"} else object)
        for i in range(len(columns[0])):
            row = np.array([c[i] for c in columns], dtype=dtype)
            out[str(row[j]).zfill(5)] = row[1:].astype(np.float32)
        return out
    rows = read_xlsx_rows(label_file)
    for row in rows[1:]:
        if not row or row[0] is None:
            continue
        sid = str(row[0]).split(".")[0]  # numeric cells may read as "123.0"
        values = np.array(
            [float(v) if v is not None else 0.0 for v in row[1:]], dtype=np.float32
        )
        out[sid.zfill(5)] = values
    return out


class GammaDataset:
    def __init__(
        self,
        cfg: DataConfig,
        mode: str = "train",
        filelists: Optional[Sequence[str]] = None,
        cache: bool = True,
    ):
        self.cfg = cfg
        self.mode = mode.lower()
        self.cache = cache
        labels = load_labels(cfg.label_file)
        ids = filelists if filelists is not None else sorted(os.listdir(cfg.data_path))
        self.samples: List = []
        for sid in ids:
            name = os.path.basename(str(sid))
            key = name.zfill(5) if name.isdigit() else name
            if key not in labels and name not in labels:
                continue
            one_hot = labels.get(key, labels.get(name))
            # Resolve the on-disk directory: ids may be zero-padded in the
            # label file but unpadded on disk (or vice versa).
            candidates = [name]
            if name.isdigit():
                candidates += [name.zfill(5), str(int(name))]
            dir_name = next(
                (c for c in candidates if os.path.isdir(os.path.join(cfg.data_path, c))),
                name,
            )
            self.samples.append((dir_name, one_hot))

    def __len__(self) -> int:
        return len(self.samples)

    def cache_path(self, sid: str) -> str:
        """The sample's uint8 cache, keyed on every shape knob."""
        d, oh, ow = self.cfg.oct_size
        return os.path.join(self.cfg.data_path, sid, f"_edrl_cache8_{self.cfg.fundus_size}_{d}x{oh}x{ow}.npz")

    def _load_raw(self, sid: str):
        """Decoded + resized sample, memoized to disk as UNCOMPRESSED uint8
        (raw uint8 reads are ~1 ms and lossless for 8-bit sources)."""
        root = self.cfg.data_path
        as_uint8 = self.cfg.device_noise and self.cfg.uint8_transport
        cache_path = self.cache_path(sid)
        if self.cache and os.path.exists(cache_path):
            with np.load(cache_path) as z:
                fundus_u8, vol_u8 = z["fundus"], z["oct"]
            if as_uint8:
                return fundus_u8, vol_u8
            return fundus_u8.astype(np.float32) / 255.0, vol_u8.astype(np.float32) / 255.0
        fundus = _read_image(os.path.join(root, sid, f"data_{sid}_fundus.png"))
        nii = os.path.join(root, sid, f"data_{sid}.nii")
        if not os.path.exists(nii):
            nii = os.path.join(root, sid, f"processed_data_{sid}.nii")
        vol = read_nifti(nii)
        vol = np.transpose(vol, (2, 0, 1))  # (H, W, D) -> (D, H, W), ``:681``
        fundus = resize_image(fundus / 255.0, self.cfg.fundus_size)
        vol = resize_volume(vol, self.cfg.oct_size) / 255.0
        fundus = np.clip(fundus, 0.0, 1.0).astype(np.float32)
        vol = np.clip(vol, 0.0, 1.0).astype(np.float32)
        fundus_u8 = np.rint(fundus * 255.0).astype(np.uint8)
        vol_u8 = np.rint(vol * 255.0).astype(np.uint8)
        if self.cache:
            try:
                np.savez(cache_path, fundus=fundus_u8, oct=vol_u8)
            except OSError:
                pass
            # Serve the uint8 round-trip on the cache-MISS call too: the
            # first epoch must see byte-identical values to every cached
            # epoch/run (post-resize floats are not 8-bit-valued, so
            # returning the raw floats here would make fresh != cached).
            fundus = fundus_u8.astype(np.float32) / 255.0
            vol = vol_u8.astype(np.float32) / 255.0
        if as_uint8:
            return fundus_u8, vol_u8
        return fundus, vol

    def get(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        sid, one_hot = self.samples[index]
        fundus, vol = self._load_raw(sid)
        rng = sample_rng(self.cfg.seed, epoch, index)
        if self.cfg.device_noise:
            # Augmentation + noise happen on the card in the train step.
            return {
                "fundus": fundus,
                "oct": vol,
                "label": np.int32(np.argmax(one_hot)),
            }
        views = make_noise_views(fundus, vol, self.cfg.noise, rng)
        if self.mode == "train":
            for key in ("fundus_low", "fundus_high"):
                views[key] = fundus_train_augment(
                    views[key],
                    rng,
                    jitter_prob=self.cfg.color_jitter_prob,
                    grayscale_prob=self.cfg.grayscale_prob,
                    hflip_prob=self.cfg.hflip_prob,
                    jitter_strength=self.cfg.color_jitter_strength,
                )
            for key in ("oct_low", "oct_high"):
                views[key] = oct_train_augment(views[key], rng, self.cfg.hflip_prob)
        views["label"] = np.int32(np.argmax(one_hot))
        return views


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Center crop of an [H, W, C] image (pads if smaller)."""
    h, w = img.shape[:2]
    if h < size or w < size:
        pad_h = max(size - h, 0)
        pad_w = max(size - w, 0)
        img = np.pad(
            img,
            ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
        )
        h, w = img.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[top : top + size, left : left + size]


class GammaSub1Dataset:
    """Legacy single-view GAMMA dataset (``GAMMA_sub1_dataset``,
    ``code/data_harvard.py:50-167``): fundus ``{root}/{id}/{id}.png`` plus an
    OCT slice-image directory ``{root}/{id}/{id}/``; 2000-px fundus scans get
    the reference's fixed clip window; train transforms add CenterCrop(600) +
    resize and per-channel normalization.  Returns ONE view (no noise pair):
    ``{"fundus": [H,W,3], "oct": [D,H,W], "label": int}``.  The slices are
    read with PIL, as in the JAX package (they are often JPEGs).
    """

    # Reference normalization constants (``code/data_harvard.py:64-65``).
    MEAN = np.array([0.3163843, 0.86174834, 0.3641431], dtype=np.float32)
    STD = np.array([0.24608557, 0.11123227, 0.26710403], dtype=np.float32)

    def __init__(self, cfg: DataConfig, mode: str = "train", filelists=None):
        self.cfg = cfg
        self.mode = mode.lower()
        labels = load_labels(cfg.label_file)
        ids = filelists if filelists is not None else sorted(os.listdir(cfg.data_path))
        self.samples = []
        for sid in ids:
            name = os.path.basename(str(sid))
            key = name.zfill(5) if name.isdigit() else name
            if key in labels:
                self.samples.append((name, labels[key]))

    def __len__(self):
        return len(self.samples)

    def get(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        sid, one_hot = self.samples[index]
        root = self.cfg.data_path
        fundus = _read_image(os.path.join(root, sid, f"{sid}.png"))
        slice_dir = os.path.join(root, sid, sid)
        # Numeric-aware order: lexicographic sorting stacks 1,10,100,...,2
        # and scrambles the volume's depth axis for unpadded filenames.
        slices = sorted(os.listdir(slice_dir), key=_slice_sort_key)
        try:
            from PIL import Image
        except ImportError:
            raise ImportError(f"{slice_dir}: GammaSub1Dataset reads its OCT slices with PIL, "
                              "which does not import here") from None

        stack = []
        for p in slices:
            with Image.open(os.path.join(slice_dir, p)) as im:
                stack.append(np.asarray(im.convert("L"), dtype=np.float32))
        oct_img = np.stack(stack)  # [D, H, W]

        # Fixed clip window for 2000-px scans (``code/data_harvard.py:135``).
        if fundus.shape[0] == 2000:
            fundus = fundus[1000 - 967 : 1000 + 967, 1496 - 978 : 1496 + 978, :]

        oct_img = resize_volume(oct_img, self.cfg.oct_size) / 255.0
        fundus = fundus / 255.0
        rng = sample_rng(self.cfg.seed, epoch, index)
        if self.mode == "train":
            if rng.random() < self.cfg.color_jitter_prob:
                fundus = color_jitter(fundus, rng, *self.cfg.color_jitter_strength)
            if rng.random() < self.cfg.grayscale_prob:
                fundus = to_grayscale(fundus)
            fundus = center_crop(fundus, 600)
            fundus = np.clip(resize_image(fundus, self.cfg.fundus_size), 0.0, 1.0)
            if rng.random() < self.cfg.hflip_prob:
                fundus = fundus[:, ::-1].copy()
            fundus = (fundus - self.MEAN) / self.STD
        else:
            # The cubic resize can overshoot [0, 1]; clip back.
            fundus = np.clip(resize_image(fundus, self.cfg.fundus_size), 0.0, 1.0)
        return {
            "fundus": fundus.astype(np.float32),
            "oct": np.clip(oct_img, 0.0, 1.0).astype(np.float32),
            "label": np.int32(np.argmax(one_hot)),
        }
