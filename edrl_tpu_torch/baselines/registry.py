"""Model registry (``edrl_tpu/baselines/registry.py``): ``--model_name`` strings
-> constructors.

The ``Multi_DE{i}_ResNet`` entries are the deep-ensemble members: the same
late-fusion ``MultiResNet`` trained at the learning rates of
``ENSEMBLE_LRS``.  ``IMDR``, which the reference's run scripts pass, is
MedFusion.  The transformer baselines build the port's Swin and ViT with the
model config's kernel flags, ``remat`` and ``remat_attention`` and compute in
its dtype; the CNN baselines take no dtype and run in f32, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from edrl_tpu_torch.baselines import models as B
from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.models.medfusion import MedFusion

# Deep-ensemble member learning rates (``fusion_train.py:694-716``).
ENSEMBLE_LRS = {
    "Multi_DE1_ResNet": 1e-4,
    "Multi_DE2_ResNet": 3e-4,
    "Multi_DE3_ResNet": 1e-3,
    "Multi_DE4_ResNet": 2e-4,
    "Multi_DE5_ResNet": 1e-5,
}


def _medfusion(cfg: EDRLConfig, device) -> nn.Module:
    return MedFusion(cfg.model, cfg.data.fundus_size, cfg.data.oct_size, device=device)


def _dtype(cfg: EDRLConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.model.use_bfloat16 else torch.float32


def _swin_kwargs(cfg: EDRLConfig) -> dict:
    """The flagship's Swin layout and kernel flags, so that a baseline and
    EDRL share the kernel path."""
    m = cfg.model
    return dict(
        embed_dim=m.swin_embed_dim,
        depths=m.swin_depths,
        num_heads=m.swin_heads,
        window=m.swin_window,
        remat=m.remat,
        remat_attention=m.remat_attention,
        use_fused_attention=m.use_fused_attention,
        use_fused_mlp=m.use_fused_mlp,
        use_fused_ln=m.use_fused_ln,
        use_fused_block_attention=m.use_fused_block_attention,
    )


def _vit_kwargs(cfg: EDRLConfig) -> dict:
    m = cfg.model
    return dict(
        volume_size=cfg.data.oct_size[0],
        patch_size=m.vit3d_patch,
        dim=m.oct_embed_dim,
        depth=m.vit3d_depth,
        num_heads=m.vit3d_heads,
        remat=m.remat,
        use_fused_attention=m.vit_fused_attention,
        use_fused_mlp=m.use_fused_mlp,
        use_fused_ln=m.use_fused_ln,
        use_fused_block_attention=m.use_fused_block_attention,
    )


def _classes(cls, **kw):
    return lambda cfg, device: cls(classes=cfg.model.num_classes, device=device, **kw)


def _two_d(cfg, device):
    return B.TwoDTransformer(classes=cfg.model.num_classes, img_size=cfg.data.fundus_size,
                             swin_kwargs=_swin_kwargs(cfg), dtype=_dtype(cfg), device=device)


def _two_transformers(cls):
    return lambda cfg, device: cls(classes=cfg.model.num_classes, img_size=cfg.data.fundus_size,
                                   swin_kwargs=_swin_kwargs(cfg), vit_kwargs=_vit_kwargs(cfg), dtype=_dtype(cfg),
                                   device=device)


MODEL_REGISTRY: Dict[str, Callable[[EDRLConfig, object], nn.Module]] = {
    "MedFusion": _medfusion,
    "IMDR": _medfusion,  # the reference's run-script alias
    "Res2Net2D": _classes(B.FundusOnly2D),
    "ResNet3D": _classes(B.OctOnly3D),
    "Multi_ResNet": _classes(B.MultiResNet),
    "Multi_ResNet_cross": _classes(B.MultiResNetCross),
    "Multi_EF_ResNet": _classes(B.MultiEFResNet),
    "Multi_CBAM_ResNet": _classes(B.MultiCBAMResNet),
    "Multi_dropout_ResNet": _classes(B.MultiDropoutResNet),
    "Base_transformer": _two_d,
    "2D_transformer": _two_d,
    "3D_transformer": lambda cfg, device: B.ThreeDTransformer(
        classes=cfg.model.num_classes, vit_kwargs=_vit_kwargs(cfg), dtype=_dtype(cfg), device=device),
    "Trans_cross": _two_transformers(B.TransCross),
    "MLC": _classes(B.MLC),
    "MLC_trans": _two_transformers(B.MLCTrans),
    "Medical_2DNet": _classes(B.FeatureExtractor2D, output="logits"),
    "Medical_base_dropout_2DNet": _classes(B.FeatureExtractor2D, output="logits", dropout=0.3),
    "Medical_3DNet": _classes(B.FeatureExtractor3D, output="logits"),
    "Medical_base_dropout_3DNet": _classes(B.FeatureExtractor3D, output="logits", dropout=0.3),
    "Multi_ensemble_ResNet": _classes(B.MultiEnsembleResNet),
    "Multi_ensemble_3D_ResNet": _classes(B.MultiEnsemble3DResNet),
}
for _name in ENSEMBLE_LRS:
    MODEL_REGISTRY[_name] = _classes(B.MultiResNet)


def build_baseline(name: str, cfg: EDRLConfig, *, device="cuda") -> Tuple[nn.Module, Optional[float]]:
    """``(model, lr_override)`` on ``device``; an unknown name raises
    ``NameError``, as the reference's factory does."""
    if name not in MODEL_REGISTRY:
        raise NameError(f"There is no model named {name!r}")
    return MODEL_REGISTRY[name](cfg, device), ENSEMBLE_LRS.get(name)
