"""Deep-ensemble evaluation (``edrl_tpu/train/ensemble.py``; the reference's
``test_ensemble``, ``fusion_train.py:392-502``).

Restores the member checkpoints (the ``Multi_DE{i}_ResNet`` members: one
architecture trained at different learning rates), averages their logits per
sample, computes the 10-metric uncertainty suite and writes ``Metric.txt``.
Per batch the members run one after another on the device, their logits
summed there; the probabilities are read once the loader is done.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.models.medfusion import MedFusion
from edrl_tpu_torch.train import metrics as metrics_lib
from edrl_tpu_torch.train.checkpoint import CheckpointManager
from edrl_tpu_torch.train.trainer import _normalize_output, eval_low_view, make_model, resolve_device, to_device


def restore_members(cfg: EDRLConfig, checkpoint_dirs: Sequence[str], name: Optional[str] = None, *,
                    device="cuda") -> List[nn.Module]:
    """One model per member checkpoint directory, in eval mode, each a copy
    of one template (``make_model(cfg)``) with the weights of checkpoint
    ``name`` (``None``: ``best``, else ``latest``); the optimizer's state is
    not read."""
    template = make_model(cfg, resolve_device(device))
    members = []
    for directory in checkpoint_dirs:
        mgr = CheckpointManager(directory)
        which = name or ("best" if mgr.best_info() is not None else "latest")
        members.append(mgr.restore_model(copy.deepcopy(template), which).eval())
    return members


def member_logits_mean(models: Sequence[nn.Module], fundus, oct_vol, y=None, *,
                       guided_uniform=None, eprl_eps=None) -> torch.Tensor:
    """The mean of the members' f32 eval logits, summed on the device one
    member at a time.  ``guided_uniform`` and ``eprl_eps`` go to MedFusion
    members only (``Predictor``'s fixed eval draws)."""
    total = None
    for model in models:
        kwargs = dict(guided_uniform=guided_uniform, eprl_eps=eprl_eps) if isinstance(model, MedFusion) else {}
        logits = _normalize_output(model(fundus, oct_vol, y, train=False, **kwargs))[0].float()
        total = logits if total is None else total + logits
    return total / len(models)


@torch.no_grad()
def ensemble_predict(cfg: EDRLConfig, models: Sequence[nn.Module], loader, *,
                     device="cuda") -> Dict[str, np.ndarray]:
    """The softmax of the members' mean logits over the eval set (low-noise
    view): targets, probabilities and the seconds per sample of the whole
    pass.  ``device``: where the members are (the card unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    for model in models:
        where = next(model.parameters()).device
        if where.type != device.type:
            raise ValueError(f"a member is on {where}, not on {device}")
        model.eval()
    targets, dev_probs = [], []
    t0 = time.perf_counter()
    for batch in loader.epoch(0):
        arrays = to_device(batch, device)
        fundus, oct_vol = eval_low_view(arrays, cfg, device)
        y = arrays["label"].long()
        dev_probs.append(torch.softmax(member_logits_mean(models, fundus, oct_vol, y), dim=-1))
        targets.append(np.asarray(batch["label"]))
    probs = torch.cat(dev_probs).cpu().numpy()  # the one host sync
    total = time.perf_counter() - t0
    n = int(sum(len(t) for t in targets))
    return {"targets": np.concatenate(targets), "probs": probs, "latency_per_sample": total / max(n, 1)}


def evaluate_ensemble(cfg: EDRLConfig, checkpoint_dirs: Sequence[str], loader, output_path: str = "Metric.txt",
                      *, device="cuda") -> Dict[str, float]:
    """Restore the members, run the suite, write ``Metric.txt``."""
    models = restore_members(cfg, checkpoint_dirs, device=device)
    pred = ensemble_predict(cfg, models, loader, device=device)
    suite = metrics_lib.compute_uncertainty_metrics(pred["targets"], pred["probs"])
    suite["latency_per_sample_s"] = pred["latency_per_sample"]
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        for k, v in suite.items():
            f.write(f"{k}: {v:.6f}\n")
    return suite
