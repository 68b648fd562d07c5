"""Batched serving front-end (``edrl_tpu/serve/predictor.py``).

Any registry model (``cfg.model.model_name``) in eval mode on one device;
a list of members is a deep ensemble, whose logits are averaged on the
device (the reference's ``test_ensemble``), one member after another.
Requests of any size are padded on the host to the serving batch
(``eval_batch_size``) by repeating their last pair, so every batch has one
shape, and the results are sliced back.  Inputs travel as uint8 by default
and are dequantized on the device.

What the JAX predictor also offers and the port has not got (each raises
``NotImplementedError`` naming its ROADMAP item): int8 quantization and
``chunk_batches > 1`` (A10's serving half; CUDA graphs are the tool here),
and mesh serving (A11).
"""

from __future__ import annotations

import warnings
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.convert import load_flax_variables
from edrl_tpu_torch.models.layers import cast_dense_weights_, init_parameters
from edrl_tpu_torch.train.ensemble import member_logits_mean, restore_members
from edrl_tpu_torch.train.trainer import TrainState, _dequantize, make_model, resolve_device, set_conv_precision


def _to_uint8_transport(x: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8 for transport (uint8 passes through).

    Values outside [0, 1] are clipped, with a warning (the JAX predictor
    clips them silently).
    """
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    scaled = np.round(x * 255.0)
    clipped = int(np.count_nonzero((scaled < 0.0) | (scaled > 255.0)))
    if clipped:
        warnings.warn(
            f"uint8 transport clipped {clipped} input values outside [0, 1]",
            RuntimeWarning, stacklevel=3,
        )
    return np.clip(scaled, 0.0, 255.0).astype(np.uint8)


class Predictor:
    """Serve class probabilities for fundus+OCT pairs.

    Parameters
    ----------
    cfg: full config (model name and architecture, eval batch size).
    variables: one member, or a list of members for a deep ensemble.  A
        member is ``{"params": ..., "batch_stats": ...}``, flax trees of numpy
        arrays (e.g. a JAX ``TrainState``'s) loaded with
        ``convert.load_flax_variables``; the port's ``TrainState``, whose
        model is copied; or a model on ``device``, served as it is (what
        ``train.ensemble.restore_members`` returns; its Dense weights are
        cast in place).  ``None`` gives the seeded flax-style init from
        ``seed``.
    device: where the model runs: ``"cuda"`` (the default) or ``"cpu"``.
    transport: ``"uint8"`` (default) ships requests as uint8 and dequantizes
        on the device; ``"f32"`` ships floats unmodified.
    guided_uniform: MedFusion only: optional ``(u_f, u_o)``, each
        ``[eval_batch_size, C, z]``, the eval guided uniforms every batch
        uses.  ``None`` lets the model draw them from a generator seeded with
        1, which is not the JAX package's draw (see ``models.medfusion``).

    Each member's Dense weights are stored in the compute dtype
    (``layers.cast_dense_weights_``): the same products, fewer launches.
    Constructing one settles the card's f32 convolutions to full f32
    (``trainer.set_conv_precision``).
    """

    def __init__(
        self,
        cfg: EDRLConfig,
        variables: Union[None, Mapping, TrainState, Sequence] = None,
        *,
        device="cuda",
        seed: int = 0,
        transport: str = "uint8",
        guided_uniform: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        quantize_int8: bool = False,
        chunk_batches: int = 1,
        mesh=None,
    ):
        if quantize_int8:
            raise NotImplementedError("int8 serving is ROADMAP item A10 (its serving half)")
        if int(chunk_batches) > 1:
            raise NotImplementedError("chunk_batches > 1 is ROADMAP item A10 (its serving half)")
        if mesh is not None:
            raise NotImplementedError("mesh serving is ROADMAP item A11")
        if transport not in ("uint8", "f32"):
            raise ValueError(f"transport must be 'uint8' or 'f32', got {transport!r}")
        self.device = resolve_device(device)
        set_conv_precision()
        self.cfg = cfg
        self.transport = transport
        self.batch_size = cfg.data.eval_batch_size
        members = list(variables) if isinstance(variables, (list, tuple)) else [variables]
        if not members:
            raise ValueError("an ensemble needs at least one member")
        self.members = [self._member(m, seed) for m in members]
        self.model = self.members[0]
        self.num_members = len(self.members)
        self.guided_uniform = None
        if guided_uniform is not None:
            shape = (self.batch_size, cfg.model.num_classes, cfg.model.z_dim)
            self.guided_uniform = tuple(
                torch.tensor(np.array(u, np.float32), device=self.device)
                for u in guided_uniform
            )
            if any(tuple(u.shape) != shape for u in self.guided_uniform):
                raise ValueError(f"guided_uniform entries must be {shape}")

    def _member(self, variables, seed: int) -> torch.nn.Module:
        if isinstance(variables, torch.nn.Module):
            where = next(variables.parameters()).device
            if where.type != self.device.type:
                raise ValueError(f"a member is on {where}, not on {self.device}")
            return cast_dense_weights_(variables.eval())
        model = make_model(self.cfg, self.device).eval()
        if variables is None:
            init_parameters(model, torch.Generator(device=self.device).manual_seed(seed))
        elif isinstance(variables, TrainState):
            model.load_state_dict(variables.model.state_dict())
        else:
            load_flax_variables(model, variables["params"], variables.get("batch_stats"))
        return cast_dense_weights_(model)

    @classmethod
    def from_checkpoint(cls, cfg: EDRLConfig, checkpoint_dir: str, name: Optional[str] = None,
                        **kwargs) -> "Predictor":
        """One member from the port's checkpoint ``name`` in ``checkpoint_dir``
        (``None``: ``best``, else ``latest``); its weights only."""
        return cls(cfg, restore_members(cfg, [checkpoint_dir], name, device=kwargs.get("device", "cuda"))[0],
                   **kwargs)

    @classmethod
    def from_checkpoints(cls, cfg: EDRLConfig, checkpoint_dirs: Sequence[str], **kwargs) -> "Predictor":
        """A deep ensemble of the members' checkpoints (``best``, else
        ``latest``), the serving counterpart of ``train.ensemble.evaluate_ensemble``."""
        return cls(cfg, restore_members(cfg, checkpoint_dirs, device=kwargs.get("device", "cuda")), **kwargs)

    def _forward(self, fundus: torch.Tensor, oct_vol: torch.Tensor) -> torch.Tensor:
        fundus, oct_vol = _dequantize(fundus), _dequantize(oct_vol)
        logits = member_logits_mean(self.members, fundus, oct_vol, guided_uniform=self.guided_uniform)
        return torch.softmax(logits, dim=-1)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        if x.dtype != np.uint8:
            x = x.astype(np.float32, copy=False)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def predict_probs(self, fundus: np.ndarray, oct_vol: np.ndarray) -> np.ndarray:
        """Probabilities ``[N, num_classes]`` for N pairs.

        ``fundus``: ``[N, H, W, 3]`` float in [0, 1] or uint8; ``oct_vol``:
        ``[N, D, H, W, 1]`` likewise.  Any N: inputs are padded to the
        serving batch on the host and the results sliced back.
        """
        fundus, oct_vol = np.asarray(fundus), np.asarray(oct_vol)
        n = fundus.shape[0]
        if oct_vol.shape[0] != n:
            raise ValueError("fundus/oct batch mismatch")
        if n == 0:
            return np.zeros((0, self.cfg.model.num_classes), np.float32)
        if self.transport == "uint8":
            fundus = _to_uint8_transport(fundus)
            oct_vol = _to_uint8_transport(oct_vol)
        b = self.batch_size
        pad = (-n) % b
        if pad:
            fundus = np.concatenate([fundus, np.repeat(fundus[-1:], pad, 0)])
            oct_vol = np.concatenate([oct_vol, np.repeat(oct_vol[-1:], pad, 0)])
        probs = []
        with torch.inference_mode():
            for i in range(0, n + pad, b):
                probs.append(self._forward(
                    self._to_device(fundus[i : i + b]), self._to_device(oct_vol[i : i + b])
                ))
            out = torch.cat(probs).cpu().numpy()  # one host sync per request
        return out[:n]

    def predict_labels(self, fundus: np.ndarray, oct_vol: np.ndarray) -> np.ndarray:
        return self.predict_probs(fundus, oct_vol).argmax(axis=-1)
