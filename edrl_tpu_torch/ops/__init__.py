"""Loss and statistics ops of the port (``edrl_tpu.ops`` counterparts)."""

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 where the JAX package casts to f32, or left in f64: a
    CNN baseline made f64 (``model.double()``) is the reference its f32
    checks are held to, and stays f64 throughout."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
