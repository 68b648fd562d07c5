"""EDRL on PyTorch and CUDA: the port of ``edrl_tpu`` to one NVIDIA H100.

``edrl_tpu`` (JAX on a TPU) stays the reference; this package mirrors its
module names and its flax parameter names, keeps its own copy of the config
dataclasses (``edrl_tpu_torch.config``) and imports nothing of ``edrl_tpu``.
Ported so far:

- the serving forward, ``serve.predictor.Predictor`` ->
  ``models.medfusion.MedFusion`` in eval mode;
- the dual-view train step, ``train.trainer.make_train_step``: two train-mode
  forwards, MK-MMD, the backward and Adam with warmup, from clean batches
  augmented and corrupted on the device (``data.device_augment``,
  ``data.device_noise``) or from ready-made views;
- the system's entry points, ``cli.train`` and ``cli.test``: the synthetic
  datasets and the host loader (``data``), ``train.trainer.fit`` (per-epoch
  train and val, the plateau schedule, resume), metrics, CSV logs and
  checkpoints (``train.metrics``, ``train.logging``, ``train.checkpoint``);
- the baseline zoo (``baselines``: every ``--model_name`` of the JAX
  registry, on ``models.resnet2d`` / ``resnet3d`` / ``conv``) and the
  evaluation surfaces over it: MC-dropout (``train.mc_dropout``), the
  robustness sweep (``train.robustness``) and deep ensembles
  (``train.ensemble``, ``cli.ensemble``, a ``Predictor`` of members);
- the serving half: W8A8 int8 Dense layers with dynamic or calibrated
  static activation scales (``ops.quantization``), ``chunk_batches > 1`` as
  a CUDA graph of the eval forward (``serve.predictor.ChunkGraph``),
  ``torch.export`` of the serving forward (``serve.export``) and the serving
  CLI ``cli.predict``.

The ViT-3D and Swin attention (forward and backward) and the fused MK-MMD
forward run on hand-written CUDA kernels (``kernels/csrc``).
"""
