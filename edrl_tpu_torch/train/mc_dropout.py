"""MC-dropout uncertainty sampling (``edrl_tpu/train/mc_dropout.py``).

A model whose ``forward`` takes ``mc`` (``MultiDropoutResNet``, the dropout
feature extractors) keeps its dropout active at inference with ``mc=True``;
``mc_dropout_predict`` runs K such forwards per eval batch and returns the
mean of the K softmax distributions and their standard deviation, the
per-sample epistemic uncertainty.  A model without ``mc`` gives K equal
passes (std 0), MedFusion among them: its eval draws are fixed.

The K passes of a batch run one after another on the device, each with its
own ``torch.Generator`` seeded from ``(seed, batch, k)``; means and stds stay
on the device until the pass over the loader ends (one host sync).
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.train.trainer import (
    TrainState,
    _normalize_output,
    eval_low_view,
    require_device,
    seed_step_generator,
    to_device,
)


def model_supports_mc(model) -> bool:
    """True if the model's ``forward`` takes the ``mc`` keyword."""
    return "mc" in inspect.signature(type(model).forward).parameters


def make_mc_predict(model, num_samples: int):
    """``predict(fundus, oct_vol, y, generators=None, masks=None) -> (mean, std)``:
    ``num_samples`` stochastic forwards in eval mode, ``mean`` and ``std``
    ``[B, C]`` of their softmax probabilities (std over the K passes, ddof 0).

    Pass k draws its dropout masks from ``generators[k]``, or takes
    ``masks[k]`` (the model's ``dropout_masks``), as the tests inject JAX's.
    """
    use_mc = model_supports_mc(model)

    @torch.no_grad()
    def predict(fundus, oct_vol, y, generators: Optional[Sequence[torch.Generator]] = None,
                masks: Optional[Sequence] = None):
        kwargs = {"mc": True} if use_mc else {}
        probs = []
        for k in range(num_samples):
            out = model(fundus, oct_vol, y, train=False, generator=None if generators is None else generators[k],
                        dropout_masks=None if masks is None else masks[k], **kwargs)
            probs.append(torch.softmax(_normalize_output(out)[0].float(), dim=-1))
        probs = torch.stack(probs)  # [K, B, C]
        return probs.mean(dim=0), probs.std(dim=0, correction=0)

    return predict


def mc_dropout_predict(cfg: EDRLConfig, state: TrainState, loader, num_samples: int = 10, seed: int = 0, *,
                       device="cuda") -> Dict[str, np.ndarray]:
    """MC-dropout over an eval loader, on the low-noise view: the targets, the
    K-averaged probabilities and the per-sample predictive std.  ``device``:
    where ``state`` is (the card unless the caller asks for the CPU)."""
    device = require_device(state, device)
    predict = make_mc_predict(state.model, num_samples)
    gens = [torch.Generator(device=device) for _ in range(num_samples)]
    targets: List[np.ndarray] = []
    means, stds = [], []
    for i, batch in enumerate(loader.epoch(0)):
        arrays = to_device(batch, device)
        fundus, oct_vol = eval_low_view(arrays, cfg, device)
        for k, g in enumerate(gens):
            seed_step_generator(g, seed, i, k)
        mean, std = predict(fundus, oct_vol, arrays["label"].long(), gens)
        targets.append(np.asarray(batch["label"]))
        means.append(mean)
        stds.append(std)
    return {
        "targets": np.concatenate(targets),
        "probs": torch.cat(means).cpu().numpy(),
        "predictive_std": torch.cat(stds).cpu().numpy(),
    }
