"""Robustness evaluation: noise sweeps over the missing-modality grid
(``edrl_tpu/train/robustness.py``).

The reference's robustness axis is input corruption
(``Condition_G_Variance``, ``fusion_train.py:548``), evaluated on the
low-noise view, so the sweep sets ``gaussian_low`` (or ``salt_pepper_low``)
to the probe level, rebuilds the eval step for it and evaluates each cell of
the modality grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.data import SYNTHETIC_DATASETS, BatchLoader
from edrl_tpu_torch.train.trainer import TrainState, make_eval_step, require_device, run_eval

DEFAULT_SIGMAS = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
# Salt-pepper fractions bracketing the reference default (0.005).
DEFAULT_SP_LEVELS = (0.0, 0.001, 0.005, 0.01, 0.05)

MODALITY_GRID = {
    "both": None,
    "fundus-only": np.array([True, False]),
    "oct-only": np.array([False, True]),
}


def _cfg_for(cfg: EDRLConfig, level: float, kind: str = "gaussian") -> EDRLConfig:
    """The probe config of one corruption level: ``kind`` "gaussian" or
    "salt_pepper", with ``condition_name`` set so the probe corrupts with
    exactly one mechanism."""
    if kind == "gaussian":
        noise = dataclasses.replace(cfg.data.noise, condition="noise", condition_name="Gaussian",
                                    gaussian_low=level)
    elif kind == "salt_pepper":
        noise = dataclasses.replace(cfg.data.noise, condition="noise", condition_name="SaltPepper",
                                    salt_pepper_low=level)
    else:
        raise ValueError(f"unknown probe kind: {kind!r}")
    return cfg.replace(data=dataclasses.replace(cfg.data, noise=noise))


def _dataset_for(cfg: EDRLConfig, level: float, kind: str = "gaussian"):
    if cfg.data.dataset not in SYNTHETIC_DATASETS:
        raise NotImplementedError(
            f"dataset {cfg.data.dataset!r}: the real-data readers are ROADMAP item A7's second half")
    return SYNTHETIC_DATASETS[cfg.data.dataset](_cfg_for(cfg, level, kind).data, mode="val")


def noise_sweep(cfg: EDRLConfig, state: TrainState, sigmas: Sequence[float] = DEFAULT_SIGMAS,
                modalities: Optional[Sequence[str]] = None, mesh=None, kind: str = "gaussian", *,
                device="cuda") -> Dict[str, Dict[float, dict]]:
    """``{modality: {level: metrics as a dict, with num_samples}}``.  The eval
    step is rebuilt per level (its low view reads the level from the config);
    every sample is scored (the remainder batch is kept).  ``device``: where
    ``state`` is (the card unless the caller asks for the CPU)."""
    if mesh is not None:
        raise NotImplementedError("a sharded sweep is ROADMAP item A11 (data parallel)")
    require_device(state, device)
    modalities = list(modalities or MODALITY_GRID)
    results: Dict[str, Dict[float, dict]] = {m: {} for m in modalities}
    for sigma in sigmas:
        eval_step = make_eval_step(_cfg_for(cfg, sigma, kind))
        loader = BatchLoader(_dataset_for(cfg, sigma, kind), cfg.data.eval_batch_size, shuffle=False,
                             drop_last=False, num_workers=4)
        for modality in modalities:
            m, targets, _ = run_eval(state, eval_step, loader, modality_mask=MODALITY_GRID[modality])
            cell = m.as_dict()
            cell["num_samples"] = int(targets.shape[0])
            results[modality][sigma] = cell
    return results


def format_sweep(results: Dict[str, Dict[float, dict]]) -> str:
    lines = ["modality\tsigma\taccuracy\tauc\tf1"]
    for modality, by_sigma in results.items():
        for sigma, m in sorted(by_sigma.items()):
            # %g: the salt-pepper grid (0.001, 0.005...) stays distinct.
            lines.append(f"{modality}\t{sigma:g}\t{m['accuracy']:.4f}\t{m['auc']:.4f}\t{m['f1']:.4f}")
    return "\n".join(lines)
