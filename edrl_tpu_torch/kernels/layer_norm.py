"""LayerNorm math of the port.

Only the plain version of ``edrl_tpu/kernels/layer_norm.py`` is ported: the
fused kernel (``fused_layer_norm``) is off by default in the shipped config
and waits in ROADMAP queue B.
"""

from __future__ import annotations

import torch.nn.functional as F


def layer_norm_reference(x, gamma, beta, eps: float = 1e-6):
    """Row LayerNorm with f32 statistics; the result has x's dtype.

    (x - mean) * rsqrt(var + eps) * gamma + beta over the last axis, all in
    f32, as the JAX reference computes it; ``F.layer_norm`` on the f32 input
    does that in one pass instead of ten elementwise launches.
    """
    y = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(), eps)
    return y.to(x.dtype)
