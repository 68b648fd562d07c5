"""The input path (``edrl_tpu.data`` counterparts): the synthetic datasets,
the host loader, the host noise and augmentations, and the on-device
augmentation and dual-view noise.  The real-data readers (GAMMA layout,
NIfTI, xlsx) are ROADMAP item A7's second half."""

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
    "BatchLoader",
    "kfold_split",
]
