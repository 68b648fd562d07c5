"""EDRL on PyTorch and CUDA: the port of ``edrl_tpu`` to one NVIDIA H100.

``edrl_tpu`` (JAX on a TPU) stays the reference; this package mirrors its
module names and its flax parameter names, keeps its own copy of the config
dataclasses (``edrl_tpu_torch.config``) and imports nothing of ``edrl_tpu``.
Ported so far:

- the serving forward, ``serve.predictor.Predictor`` ->
  ``models.medfusion.MedFusion`` in eval mode;
- the dual-view train step, ``train.trainer.make_train_step``: two train-mode
  forwards, MK-MMD, the backward and Adam with warmup.

The ViT-3D and Swin attention (forward and backward) and the fused MK-MMD
forward run on hand-written CUDA kernels (``kernels/csrc``).
"""
