"""Ahead-of-time export of the serving forward (``edrl_tpu/serve/export.py``),
through ``torch.export``.

The exported program is the ``Predictor``'s forward of one serving batch:
``(state, fundus, oct_vol) -> probs``, fundus ``[B, H, W, 3]`` and OCT
``[B, D, H, W, 1]`` f32 in [0, 1] at the serving batch B, probabilities f32.
It pins the program apart from the Python model code: a server loads it
and calls it without building a model.

Weights are *arguments* of the program, not constants in it, so one artifact
serves every checkpoint of the same architecture (and the same int8 layout):
``state`` is ``Predictor.serving_state()``, one dict of every member's
parameters and buffers, int8 weights and their scales included (the JAX
export takes the pair ``(variables, scales)``).  The eval draws (MedFusion's
guided uniforms and EPRL's eps) are constants of the program.

The hand kernels stay in the program: each forward kernel the serving
forward can launch (B1, B2, B4, B5, B6) is an operator of the
``edrl_tpu_torch`` namespace (``torch.ops.edrl_tpu_torch.*``) with a
shape-only version for tracing, which the kernel modules register as they
are imported.  So, unlike ``jax.export``'s StableHLO, loading needs those
registrations first: importing this module makes them (it imports the
kernel modules, not the models).  On the card the loaded program launches
the kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import io
from typing import Mapping, Tuple

import torch
from torch import nn

# The operators' registrations (the kernel modules register them on import).
from edrl_tpu_torch.kernels import block_attention, build, fused_mlp, layer_norm, window_attention  # noqa: F401

class _StateAsArgument(nn.Module):
    """``forward(state, fundus, oct_vol)``: the serving forward with the
    weights taken from ``state`` (``torch.func.functional_call``).  The
    serving module is held outside the module tree, so that export lifts
    none of its tensors into the program."""

    def __init__(self, serving: nn.Module):
        super().__init__()
        self._serving = (serving,)

    def forward(self, state, fundus, oct_vol):
        return torch.func.functional_call(self._serving[0], state, (fundus, oct_vol))


def export_program(predictor) -> torch.export.ExportedProgram:
    """``torch.export`` of the predictor's forward of one serving batch."""
    d = predictor.cfg.data
    b, device = predictor.batch_size, predictor.device
    args = (predictor.serving_state(),
            torch.zeros((b, d.fundus_size, d.fundus_size, 3), device=device),
            torch.zeros((b, *d.oct_size, 1), device=device))
    with torch.no_grad():
        program = torch.export.export(_StateAsArgument(predictor.serving), args, strict=False)
    # The example inputs hold the weights: a saved program keeps no copy of them.
    program.example_inputs = None
    return program


def export_forward(predictor, path: str | None = None) -> bytes:
    """Serialize the predictor's forward of one serving batch
    (``torch.export.save``); returns the bytes and also writes them to
    ``path`` when given."""
    buf = io.BytesIO()
    torch.export.save(export_program(predictor), buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def program_ops(program: torch.export.ExportedProgram) -> Tuple[str, ...]:
    """The ``edrl_tpu_torch`` operators a program calls, one name per call."""
    return tuple(str(node.target).split(".")[1] for node in program.graph.nodes
                 if node.op == "call_function" and str(node.target).startswith(f"{build.OP_NAMESPACE}."))


class ExportedForward:
    """A loaded serving program: ``call(state, fundus, oct_vol) -> probs``.
    Needs no model code, only the weights (``Predictor.serving_state()`` of
    a predictor of the same architecture, or the same dict from anywhere)."""

    def __init__(self, blob: bytes):
        self.program = torch.export.load(io.BytesIO(blob))
        self._module = self.program.module()

    @classmethod
    def load(cls, path: str) -> "ExportedForward":
        with open(path, "rb") as f:
            return cls(f.read())

    def __call__(self, state: Mapping[str, torch.Tensor], fundus: torch.Tensor, oct_vol: torch.Tensor):
        with torch.no_grad():
            return self._module(dict(state), fundus, oct_vol)


def roundtrip_check(predictor, fundus: torch.Tensor, oct_vol: torch.Tensor) -> Tuple[bool, float]:
    """Export, serialize, load, and compare the loaded program with the live
    forward on one batch (f32 on the predictor's device).  Returns
    ``(same shape and dtype, max |difference|)``."""
    loaded = ExportedForward(export_forward(predictor))
    with torch.inference_mode():
        live = predictor._forward(fundus, oct_vol)
    replay = loaded(predictor.serving_state(), fundus, oct_vol)
    same = live.shape == replay.shape and live.dtype == replay.dtype
    return same, float((live.float() - replay.float()).abs().max())
