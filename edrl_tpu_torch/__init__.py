"""EDRL on PyTorch and CUDA: the port of ``edrl_tpu`` to one NVIDIA H100.

``edrl_tpu`` (JAX on a TPU) stays the reference; this package mirrors its
module names and its flax parameter names, and reuses ``edrl_tpu.config``
in place (that module is plain dataclasses and pulls in no JAX).  The slice
ported so far is the serving forward: ``serve.predictor.Predictor`` ->
``models.medfusion.MedFusion`` in eval mode, with the ViT-3D and Swin
attention running on hand-written CUDA kernels (``kernels/csrc``).
"""
