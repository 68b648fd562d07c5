"""Batched serving front-end (``edrl_tpu/serve/predictor.py``).

Any registry model (``cfg.model.model_name``) in eval mode on one device;
a list of members is a deep ensemble, whose logits are averaged on the
device (the reference's ``test_ensemble``), one member after another.
Requests of any size are padded on the host to the serving batch
(``eval_batch_size``) by repeating their last pair, so every batch has one
shape, and the results are sliced back.  Inputs travel as uint8 by default
and are dequantized on the device.

- ``quantize_int8``: W8A8 int8 Dense layers (``ops.quantization``), each
  member quantized on its own from its float32 weights; with
  ``int8_calibration``, static activation scales calibrated over the whole
  calibration set in chunks of the serving batch (the last chunk wraps
  around), the chunks' scales combined with max.
- ``chunk_batches = C > 1``: while C batches remain, they run as one chunk;
  the rest batch by batch (the JAX predictor's dispatch rule).  On the card
  a chunk is one replay of a CUDA graph of C consecutive eval forwards (the
  members, their mean and the softmax), captured once at the first chunk
  from a static ``[C, B, ...]`` input buffer: the counterpart of the JAX
  predictor's ``lax.scan`` in one dispatch.  A capture that fails raises.
  On the CPU a chunk is a loop of the eager forward.

The eval draws of a MedFusion member (its guided uniforms and EPRL's eps)
are drawn once, as the model would draw them, and passed to every forward,
so that a graph replays them and an exported program holds them.

With ``mesh`` (data parallelism, ``parallel.make_mesh``; one process per
card, each given the whole request) every rank runs its rows of each padded
serving batch, its rows of the eval draws with them, and the
probabilities are all-gathered once per request: every rank returns the
whole result.  int8 (each rank calibrates on the whole calibration set, so
the scales agree) and chunks (a rank's graph holds its rows) compose with
it, as with the JAX package's mesh predictor.  A mesh with a model axis
above 1 shards every member over it (``parallel.tensor``; the ranks of a
data row serve the same rows), in bf16 and in int8 (quantized from the full
f32 weights, then sliced).  There a chunk graph would have to hold the
model axis's collectives: ``chunk_batches > 1`` refuses by name, as
``serve.export`` does.
"""

from __future__ import annotations

import warnings
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.convert import load_flax_variables
from edrl_tpu_torch.kernels import block_attention, fused_mlp, layer_norm, mmd, window_attention
from edrl_tpu_torch.models.eprl import eval_eps
from edrl_tpu_torch.models.layers import cast_dense_weights_, init_parameters
from edrl_tpu_torch.models.medfusion import MedFusion, eval_guided_uniform
from edrl_tpu_torch.ops import quantization
from edrl_tpu_torch.parallel import tensor
from edrl_tpu_torch.parallel.mesh import data_axis_of, gather_batches, rows_of
from edrl_tpu_torch.train.ensemble import member_logits_mean, restore_members
from edrl_tpu_torch.train.trainer import (
    TrainState, _dequantize, check_tensor_parallel, make_model, resolve_device, set_conv_precision)


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


def launch_counters() -> Tuple[dict, ...]:
    """Every launch counter of the port's kernel wrappers and of the int8
    products: what a CUDA graph's replays add to."""
    return (window_attention.LAUNCHES, window_attention.FWD_ROUTES, window_attention.BWD_ROUTES,
            window_attention.TP_ROUTES, mmd.LAUNCHES, mmd.MMD_ROUTES, layer_norm.LAUNCHES, fused_mlp.LAUNCHES, fused_mlp.MLP_ROUTES,
            block_attention.LAUNCHES, block_attention.SUBLAYER_ROUTES, quantization.INT8_MATMULS)


class ServingForward(nn.Module):
    """The serving forward of a batch: dequantize, the members' mean eval
    logits, softmax.  Holds the members as submodules and the eval draws (the
    predictor's dict, shared) as plain tensors, so they are not in its state
    dict."""

    def __init__(self, members: Sequence[nn.Module], draws: dict):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.draws = draws

    def forward(self, fundus: torch.Tensor, oct_vol: torch.Tensor) -> torch.Tensor:
        fundus, oct_vol = _dequantize(fundus), _dequantize(oct_vol)
        logits = member_logits_mean(list(self.members), fundus, oct_vol, **self.draws)
        return torch.softmax(logits, dim=-1)


class ChunkGraph:
    """``forward`` on C consecutive batches, captured once as a CUDA graph.

    Built from the first chunk: the static ``[C, B, ...]`` input buffers are
    filled with it, one pass of the C forwards runs on a side stream (the
    kernels' build, cuBLAS handles and other first-call work happen there,
    outside the graph), then the C forwards, stacked, are captured.  The
    kernel wrappers count launches in Python, which a replay does not reach:
    the counts of the capture are taken back (nothing launched then) and
    added again at every replay (:attr:`launches`)."""

    def __init__(self, forward, fundus: torch.Tensor, oct_vol: torch.Tensor):
        self.fundus, self.oct_vol = fundus.clone(), oct_vol.clone()
        chunk = fundus.shape[0]
        device = fundus.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for i in range(chunk):
                forward(self.fundus[i], self.oct_vol[i])
        torch.cuda.current_stream(device).wait_stream(side)
        before = [dict(c) for c in launch_counters()]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.probs = torch.stack([forward(self.fundus[i], self.oct_vol[i]) for i in range(chunk)])
        self.launches = []
        for counts, was in zip(launch_counters(), before):
            self.launches.append({k: counts[k] - was[k] for k in counts})
            counts.update(was)
        self.replays = 0

    def replay(self, fundus: torch.Tensor, oct_vol: torch.Tensor) -> torch.Tensor:
        """The probabilities ``[C, B, classes]`` of one chunk, copied out of
        the graph's output before the next replay can overwrite it."""
        self.fundus.copy_(fundus)
        self.oct_vol.copy_(oct_vol)
        self.graph.replay()
        self.replays += 1
        for counts, added in zip(launch_counters(), self.launches):
            for k, n in added.items():
                counts[k] += n
        return self.probs.clone()


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
        cast, or quantized, in place).  ``None`` gives the seeded flax-style
        init from ``seed``.
    device: where the model runs: ``"cuda"`` (the default) or ``"cpu"``.
    transport: ``"uint8"`` (default) ships requests as uint8 and dequantizes
        on the device; ``"f32"`` ships floats unmodified.
    guided_uniform: MedFusion only: optional ``(u_f, u_o)``, each
        ``[eval_batch_size, C, z]``, the eval guided uniforms every batch
        uses.  ``None`` draws them from a generator seeded with 1, as the
        model does, which is not the JAX package's draw (see
        ``models.medfusion``).
    quantize_int8: W8A8 int8 for every Dense layer with both sides at least
        ``min_dim`` (``quant_report`` says which and the bytes saved).
    int8_calibration: with ``quantize_int8``, an optional ``(fundus,
        oct_vol)`` calibration set (f32 in [0, 1] or uint8, any N, equal
        counts): static per-tensor activation scales at the
        ``int8_calib_percentile``-th percentile of |x| (100: the abs-max).
    chunk_batches: batches per chunk (1: batch by batch).
    mesh: data- and tensor-parallel serving (see the module docstring); the
        serving batch must split over the data ranks (``ValueError``).

    Dense weights that stay float are stored in the compute dtype
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
        int8_calibration=None,
        int8_calib_percentile: float = 100.0,
        min_dim: int = 128,
        chunk_batches: int = 1,
        mesh=None,
    ):
        if transport not in ("uint8", "f32"):
            raise ValueError(f"transport must be 'uint8' or 'f32', got {transport!r}")
        if int8_calibration is not None and not quantize_int8:
            raise ValueError("int8_calibration requires quantize_int8=True")
        self.device = resolve_device(device)
        set_conv_precision()
        self.cfg = cfg
        self.transport = transport
        self.batch_size = cfg.data.eval_batch_size
        self.chunk_batches = max(1, int(chunk_batches))
        self.mesh = mesh
        if mesh is not None and self.batch_size % mesh.size(0):
            raise ValueError(f"eval_batch_size {self.batch_size} not divisible by the mesh data axis "
                             f"({mesh.size(0)})")
        sharded = mesh is not None and mesh.size(1) > 1
        if sharded:
            check_tensor_parallel(cfg, mesh.size(1))
            if self.chunk_batches > 1:
                raise NotImplementedError(
                    f"chunk_batches={self.chunk_batches} over a model axis of {mesh.size(1)}: a chunk graph that "
                    "holds the model axis's collectives is ROADMAP item A14 (whole-step capture)")
        # This rank's rows of each serving batch (all of it without a mesh).
        self.rows = slice(None) if mesh is None else rows_of(self.batch_size, data_axis_of(mesh))
        members = list(variables) if isinstance(variables, (list, tuple)) else [variables]
        if not members:
            raise ValueError("an ensemble needs at least one member")
        models = [self._member(m, seed) for m in members]
        self.num_members = len(models)
        self.draws = self._eval_draws(models, guided_uniform)
        self.quantized = bool(quantize_int8)
        self.quant_report: dict = {}
        self.scales: list = [{} for _ in models]
        quantized = self._quantize(models, int8_calibration, int8_calib_percentile, min_dim) if quantize_int8 else ()
        if sharded:
            for m in models:
                tensor.shard_model_(m, mesh)
        for model, (weights, scales, _) in zip(models, quantized):
            quantization.apply_int8_(model, weights, scales)
        self.members = [cast_dense_weights_(m) for m in models]
        self.model = self.members[0]
        self.serving = ServingForward(self.members, self.draws if mesh is None else self._rank_draws())
        self.chunk_graph: Optional[ChunkGraph] = None

    @property
    def guided_uniform(self):
        return self.draws.get("guided_uniform")

    @guided_uniform.setter
    def guided_uniform(self, u):
        """Serve with other guided uniforms (tensors on the device); a chunk
        graph captured with the old ones is dropped."""
        self.draws["guided_uniform"] = tuple(u)
        if self.mesh is not None:
            self.serving.draws = self._rank_draws()
        self.chunk_graph = None

    def _rank_draws(self) -> dict:
        """The eval draws of this rank's rows (EPRL's eps is not per row)."""
        draws = dict(self.draws)
        if "guided_uniform" in draws:
            draws["guided_uniform"] = tuple(u[self.rows] for u in draws["guided_uniform"])
        return draws

    def _member(self, variables, seed: int) -> nn.Module:
        """A member's model on the device, in eval mode, with float32 weights
        (a given model as it is)."""
        if isinstance(variables, nn.Module):
            where = next(variables.parameters()).device
            if where.type != self.device.type:
                raise ValueError(f"a member is on {where}, not on {self.device}")
            return variables.eval()
        model = make_model(self.cfg, self.device).eval()
        if variables is None:
            init_parameters(model, torch.Generator(device=self.device).manual_seed(seed))
        elif isinstance(variables, TrainState):
            # A sharded state is gathered to full shapes (its model group's ranks all serve).
            model.load_state_dict(tensor.gather_full(variables.model, variables.model.state_dict()))
        else:
            load_flax_variables(model, variables["params"], variables.get("batch_stats"))
        return model

    def _eval_draws(self, models, guided_uniform) -> dict:
        """MedFusion's eval draws at the serving batch: the given guided
        uniforms, else the model's own (seed 1), and EPRL's eval eps."""
        if not any(isinstance(m, MedFusion) for m in models):
            return {}
        m = self.cfg.model
        shape = (self.batch_size, m.num_classes, m.z_dim)
        if guided_uniform is None:
            u = eval_guided_uniform(*shape, self.device)
        else:
            u = tuple(torch.tensor(np.array(a, np.float32), device=self.device) for a in guided_uniform)
            if any(tuple(a.shape) != shape for a in u):
                raise ValueError(f"guided_uniform entries must be {shape}")
        return {"guided_uniform": u, "eprl_eps": eval_eps(m.num_classes, m.sample_num, m.z_dim, self.device)}

    def _quantize(self, models, calibration, percentile: float, min_dim: int) -> list:
        """Each member's ``(int8 weights, scales, report)`` from its float32
        weights at full shape (calibrated first, on the float model, where a
        calibration set is given); :func:`quantization.apply_int8_` applies
        them."""
        d = self.cfg.data
        example = (torch.zeros((2, d.fundus_size, d.fundus_size, 3), device=self.device),
                   torch.zeros((2, *d.oct_size, 1), device=self.device),
                   torch.zeros((2,), dtype=torch.long, device=self.device))
        quantized = [quantization.quantize_for_serving(m, *example, min_dim=min_dim, train=False) for m in models]
        self.quant_report = quantized[0][2]
        if calibration is not None:
            chunks = self._calibration_chunks(calibration)
            for i, (model, (_, scales, _)) in enumerate(zip(models, quantized)):
                combined = None
                for cf, co, cy in chunks:
                    sc = quantization.calibrate_activation_scales(
                        model, scales, cf, co, cy, percentile=percentile, train=False, **self._draws_for(model))
                    combined = sc if combined is None else {k: torch.maximum(combined[k], v) for k, v in sc.items()}
                quantized[i] = (quantized[i][0], combined, quantized[i][2])
            self.quant_report = dict(self.quant_report, static_activation_scales=sum(
                k.endswith(quantization.ACT_SUFFIX) for k in quantized[0][1]))
        self.scales = [q[1] for q in quantized]
        return quantized

    def _calibration_chunks(self, calibration):
        """The calibration set as batches of the serving size (the last wraps
        around), each on the device once for all members."""
        cal_f, cal_o = (np.asarray(a) for a in calibration)
        if len(cal_f) != len(cal_o):
            raise ValueError(f"int8_calibration: {len(cal_f)} fundus images but {len(cal_o)} OCT volumes")
        if len(cal_f) == 0:
            raise ValueError("int8_calibration batch is empty")
        n = self.batch_size
        y = torch.zeros((n,), dtype=torch.long, device=self.device)
        chunks = []
        for c in range(-(-len(cal_f) // n)):
            ids = np.arange(c * n, (c + 1) * n) % len(cal_f)
            chunks.append((_dequantize(self._to_device(cal_f[ids])), _dequantize(self._to_device(cal_o[ids])), y))
        return chunks

    def _draws_for(self, model) -> dict:
        return self.draws if isinstance(model, MedFusion) else {}

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

    def serving_state(self) -> dict:
        """The served weights (every member's parameters and buffers, the
        int8 weights and scales included) by name: what an exported forward
        (``serve.export``) takes as its first argument."""
        return {k: v.detach() for k, v in self.serving.state_dict().items()}

    def _forward(self, fundus: torch.Tensor, oct_vol: torch.Tensor) -> torch.Tensor:
        return self.serving(fundus, oct_vol)

    def _forward_chunk(self, fundus: torch.Tensor, oct_vol: torch.Tensor) -> torch.Tensor:
        """``[C, B, ...]`` inputs -> ``[C, B, classes]``: a replay of the
        chunk's CUDA graph on the card (captured at the first chunk), the
        eager forward batch by batch on the CPU."""
        if self.device.type != "cuda":
            return torch.stack([self._forward(f, o) for f, o in zip(fundus, oct_vol)])
        if self.chunk_graph is None:
            self.chunk_graph = ChunkGraph(self._forward, fundus, oct_vol)
        return self.chunk_graph.replay(fundus, oct_vol)

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
        b, c = self.batch_size, self.chunk_batches
        pad = (-n) % b
        if pad:
            fundus = np.concatenate([fundus, np.repeat(fundus[-1:], pad, 0)])
            oct_vol = np.concatenate([oct_vol, np.repeat(oct_vol[-1:], pad, 0)])
        num_batches = (n + pad) // b
        # [batches, B, ...] -> this rank's rows of each batch.
        fundus = fundus.reshape(num_batches, b, *fundus.shape[1:])[:, self.rows]
        oct_vol = oct_vol.reshape(num_batches, b, *oct_vol.shape[1:])[:, self.rows]
        probs = []
        with torch.inference_mode():
            i = 0
            while i < num_batches:
                if c > 1 and num_batches - i >= c:
                    probs.append(self._forward_chunk(self._to_device(fundus[i:i + c]),
                                                     self._to_device(oct_vol[i:i + c])).flatten(0, 1))
                    i += c
                else:
                    probs.append(self._forward(self._to_device(fundus[i]), self._to_device(oct_vol[i])))
                    i += 1
            out = torch.cat(probs)
            if self.mesh is not None:
                out = gather_batches(out, fundus.shape[1], self.mesh)
            out = out.cpu().numpy()  # one host sync per request
        return out[:n]

    def predict_labels(self, fundus: np.ndarray, oct_vol: np.ndarray) -> np.ndarray:
        return self.predict_probs(fundus, oct_vol).argmax(axis=-1)
