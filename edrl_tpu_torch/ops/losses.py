"""Classification losses (``edrl_tpu/ops/losses.py``)."""

from __future__ import annotations

import torch

from edrl_tpu_torch.ops import at_least_f32


def label_smoothing_cross_entropy(logits, labels, smoothing: float = 0.1):
    """Mean label-smoothed CE over the batch.

    The target puts ``1 - smoothing`` on the true class and
    ``smoothing / (num_classes - 1)`` on every other class.
    """
    logits = at_least_f32(logits)
    num_classes = logits.shape[-1]
    off_value = smoothing / max(num_classes - 1, 1)
    true_dist = torch.full_like(logits, off_value)
    true_dist.scatter_(-1, labels.long()[..., None], 1.0 - smoothing)
    log_probs = torch.log_softmax(logits, dim=-1)
    return torch.sum(-true_dist * log_probs, dim=-1).mean()
