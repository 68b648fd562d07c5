"""The two helpers of ``edrl_tpu/train/trainer.py`` that serving uses.

The rest of the trainer (the dual-view step, MK-MMD, Adam, the fit loop) is
ROADMAP items A6-A8.
"""

from __future__ import annotations

import torch


def _normalize_output(out):
    """(logits, loss, features[, aux]) -> (logits, loss, features, aux)."""
    if len(out) == 3:
        return out[0], out[1], out[2], {}
    return out


def _dequantize(x: torch.Tensor) -> torch.Tensor:
    """uint8-transported batches -> float32 in [0, 1] (no-op for floats)."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x
