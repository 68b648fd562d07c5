"""The input path (``edrl_tpu.data`` counterparts): the synthetic datasets,
the GAMMA / Harvard readers (``gamma.py`` over ``png.py``, ``nifti.py`` and
``xlsx.py``, with no cv2, PIL or pandas on the ``dr2`` / ``glu2`` path) and
their preflight verifier (``verify.py``), the host loader, the host noise
and augmentations, and the on-device augmentation and dual-view noise."""

from edrl_tpu_torch.data.gamma import GammaDataset, GammaSub1Dataset
from edrl_tpu_torch.data.loader import BatchLoader, kfold_split
from edrl_tpu_torch.data.noise import add_gaussian, add_salt_pepper, make_noise_views
from edrl_tpu_torch.data.synthetic import (
    SYNTHETIC_DATASETS,
    ComplementarySyntheticGammaDataset,
    HardSyntheticGammaDataset,
    SyntheticGammaDataset,
)

__all__ = [
    "add_gaussian",
    "add_salt_pepper",
    "make_noise_views",
    "SyntheticGammaDataset",
    "HardSyntheticGammaDataset",
    "ComplementarySyntheticGammaDataset",
    "SYNTHETIC_DATASETS",
    "GammaDataset",
    "GammaSub1Dataset",
    "BatchLoader",
    "kfold_split",
]
