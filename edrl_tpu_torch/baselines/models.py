"""The baseline zoo (``edrl_tpu/baselines/models.py``): the comparison models of
``baseline_models.py``.

Every baseline has one interface:

    logits, loss, features = model(fundus, oct_vol, y, train=...)

Loss is plain cross-entropy; without ``y`` it is 0.  Backbone widths are the
JAX package's (Res2Net-50 -> 2048, 3-D ResNet-18 -> 512).  Modules and
parameters carry flax's names (``head_fc1``, ``fundus_backbone``...), so
``convert.load_flax_variables`` maps a flax tree onto them.

- single modality: ``FundusOnly2D``, ``OctOnly3D``, ``TwoDTransformer``,
  ``ThreeDTransformer``;
- late fusion: ``MultiResNet`` (also the deep-ensemble member);
- cross-attention fusion: ``MultiResNetCross``, ``TransCross``;
- early fusion: ``MultiEFResNet`` (the fundus pooled into extra OCT slices);
- attention fusion: ``MultiCBAMResNet`` with ``CBAM2D`` / ``CBAM3D``;
- MC-dropout fusion: ``MultiDropoutResNet``;
- intermediate + late fusion: ``MLC`` / ``MLCTrans``;
- feature extractors and the structural ensemble variants:
  ``FeatureExtractor2D``/``3D``, ``MultiEnsembleResNet``,
  ``MultiEnsemble3DResNet``.

Dropout: ``nn.Dropout`` keeps with probability 1 - rate and scales by
1 / (1 - rate) in train mode, and with ``mc=True`` in eval mode too (the
models that take ``mc``).  Its keep mask comes from ``dropout_masks`` (one
per dropout site, as tests inject JAX's) or else from ``generator``.  Every
forward takes ``generator`` and ``dropout_masks``, so the train step calls
each model alike.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.conv import Conv
from edrl_tpu_torch.models.eprl import dropout
from edrl_tpu_torch.models.layers import Dense, MultiHeadAttention
from edrl_tpu_torch.models.resnet2d import Res2Net2D
from edrl_tpu_torch.models.resnet3d import ResNet3D
from edrl_tpu_torch.models.swin2d import SwinTransformer2D
from edrl_tpu_torch.models.vit3d import ViT3D
from edrl_tpu_torch.ops import at_least_f32
from edrl_tpu_torch.ops.losses import label_smoothing_cross_entropy


def _ce(logits, y):
    if y is None:
        return torch.zeros((), device=logits.device)
    return label_smoothing_cross_entropy(logits, y, smoothing=0.0)


def _add_head(module: nn.Module, name: str, in_dim: int, classes: int, hidden: int = 64, device=None):
    """flax's ``_head``: ``{name}_fc1`` and ``{name}_fc2`` on the caller."""
    setattr(module, f"{name}_fc1", Dense(in_dim, hidden, device=device))
    setattr(module, f"{name}_fc2", Dense(hidden, classes, device=device))


def _head(module: nn.Module, name: str, x):
    h = F.relu(getattr(module, f"{name}_fc1")(F.relu(x)))
    return getattr(module, f"{name}_fc2")(h)


def _maybe_dropout(x, rate: float, active: bool, masks, generator):
    if rate <= 0 or not active:
        return x
    return dropout(x, rate, None if masks is None else masks[0], generator)


def _swin(img_size, dtype, device, kw):
    kw = dict(kw or {})
    model = SwinTransformer2D(img_size=img_size, dtype=dtype, device=device, **kw)
    depths = kw.get("depths", (2, 2, 6, 2))
    return model, kw.get("embed_dim", 128) * 2 ** (len(depths) - 1)


def _vit(dtype, device, kw):
    kw = dict(kw or {})
    return ViT3D(dtype=dtype, device=device, **kw), kw.get("dim", 768)


class _Baseline(nn.Module):
    """The shared forward surface: ``(fundus, oct_vol, y, *, train, generator,
    dropout_masks)``; the subclasses' ``_logits`` compute ``(logits, loss,
    features)``."""

    def forward(self, fundus=None, oct_vol=None, y=None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        return self._logits(fundus, oct_vol, y, train)


class FundusOnly2D(_Baseline):
    """``Res2Net2D``: a fundus-only classifier."""

    def __init__(self, classes: int = 2, *, dtype=torch.float32, device=None):
        super().__init__()
        self.backbone = Res2Net2D(dtype=dtype, device=device)
        _add_head(self, "head", self.backbone.out_channels, classes, device=device)
        self.feature_dim = self.backbone.out_channels

    def _logits(self, fundus, oct_vol, y, train):
        _, pooled = self.backbone(fundus, train)
        logits = _head(self, "head", pooled)
        return logits, _ce(logits, y), pooled


class OctOnly3D(_Baseline):
    """``ResNet3D``: an OCT-only classifier."""

    def __init__(self, classes: int = 2, *, blocks=(2, 2, 2, 2), dtype=torch.float32, device=None):
        super().__init__()
        self.backbone = ResNet3D(blocks=blocks, dtype=dtype, device=device)
        _add_head(self, "head", self.backbone.out_channels, classes, device=device)
        self.feature_dim = self.backbone.out_channels

    def _logits(self, fundus, oct_vol, y, train):
        _, pooled = self.backbone(oct_vol, train)
        logits = _head(self, "head", pooled)
        return logits, _ce(logits, y), pooled


class _TwoCNN(_Baseline):
    """Res2Net-50 fundus and 3-D ResNet OCT backbones."""

    def __init__(self, *, blocks_3d=(2, 2, 2, 2), base_width: int = 26, scales: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fundus_backbone = Res2Net2D(base_width=base_width, scales=scales, dtype=dtype, device=device)
        self.oct_backbone = ResNet3D(blocks=blocks_3d, dtype=dtype, device=device)
        self.dims = (self.fundus_backbone.out_channels, self.oct_backbone.out_channels)

    def _pooled(self, fundus, oct_vol, train):
        _, pf = self.fundus_backbone(fundus, train)
        _, po = self.oct_backbone(oct_vol, train)
        return pf, po


class MultiResNet(_TwoCNN):
    """Late fusion by concatenation; the deep-ensemble member."""

    def __init__(self, classes: int = 2, *, dtype=torch.float32, device=None):
        super().__init__(dtype=dtype, device=device)
        self.feature_dim = sum(self.dims)
        _add_head(self, "head", self.feature_dim, classes, hidden=256, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        feat = torch.cat(self._pooled(fundus, oct_vol, train), dim=1)
        logits = _head(self, "head", feat)
        return logits, _ce(logits, y), feat


class MultiResNetCross(_TwoCNN):
    """Cross-attention fusion of the two pooled features (one token each)."""

    def __init__(self, classes: int = 2, *, embed: int = 256, dtype=torch.float32, device=None):
        super().__init__(dtype=dtype, device=device)
        self.proj_f = Dense(self.dims[0], embed, device=device)
        self.proj_o = Dense(self.dims[1], embed, device=device)
        self.cross_fo = MultiHeadAttention(embed, 4, device=device)
        self.cross_of = MultiHeadAttention(embed, 4, device=device)
        self.feature_dim = 2 * embed
        _add_head(self, "head", self.feature_dim, classes, hidden=128, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        pf, po = self._pooled(fundus, oct_vol, train)
        qf, qo = self.proj_f(pf)[:, None, :], self.proj_o(po)[:, None, :]
        feat = torch.cat([self.cross_fo(qf, qo, qo)[:, 0], self.cross_of(qo, qf, qf)[:, 0]], dim=1)
        logits = _head(self, "head", feat)
        return logits, _ce(logits, y), feat


class MultiEFResNet(_Baseline):
    """Early fusion: the fundus pooled to one grayscale slab on the OCT's
    H x W grid, repeated as ``extra_slices`` leading OCT slices."""

    def __init__(self, classes: int = 2, *, extra_slices: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        self.extra_slices = extra_slices
        self.backbone = ResNet3D(blocks=(2, 2, 2, 2), dtype=dtype, device=device)
        self.feature_dim = self.backbone.out_channels
        _add_head(self, "head", self.feature_dim, classes, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        b, _, h, w, _ = oct_vol.shape
        gray = fundus.mean(dim=-1, keepdim=True)  # [B, H_f, W_f, 1]
        fh, fw = gray.shape[1], gray.shape[2]
        if fh % h == 0 and fw % w == 0:
            slab = gray.reshape(b, h, fh // h, w, fw // w, 1).mean(dim=(2, 4))
        else:  # nearest-index sampling
            hi = torch.arange(h, device=gray.device) * fh // h
            wi = torch.arange(w, device=gray.device) * fw // w
            slab = gray[:, hi][:, :, wi]
        slab = slab[:, None].expand(b, self.extra_slices, h, w, 1)
        vol = torch.cat([slab.to(oct_vol.dtype), oct_vol], dim=1)
        _, pooled = self.backbone(vol, train)
        logits = _head(self, "head", pooled)
        return logits, _ce(logits, y), pooled


class CBAM2D(nn.Module):
    """Channel then spatial attention over an NHWC map."""

    ndim = 2

    def __init__(self, channels: int, *, reduction: int = 16, device=None):
        super().__init__()
        self.ca_fc1 = Dense(channels, max(channels // reduction, 1), device=device)
        self.ca_fc2 = Dense(max(channels // reduction, 1), channels, device=device)
        self.sa_conv = Conv(2, 1, (7,) * self.ndim, device=device)

    def forward(self, x):
        dims = tuple(range(1, x.dim() - 1))
        avg, mx = x.mean(dim=dims), x.amax(dim=dims)
        ca = torch.sigmoid(self.ca_fc2(F.relu(self.ca_fc1(avg))) + self.ca_fc2(F.relu(self.ca_fc1(mx))))
        x = x * ca.reshape(ca.shape[0], *(1,) * len(dims), ca.shape[1])
        sa_in = torch.cat([x.mean(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)], dim=-1)
        return x * torch.sigmoid(self.sa_conv(sa_in))


class CBAM3D(CBAM2D):
    """CBAM over an NDHWC map."""

    ndim = 3


class MultiCBAMResNet(_TwoCNN):
    """CBAM-attended fusion: CBAM on each backbone's map, then late fusion."""

    def __init__(self, classes: int = 2, *, dtype=torch.float32, device=None):
        super().__init__(dtype=dtype, device=device)
        self.cbam2d = CBAM2D(self.dims[0], device=device)
        self.cbam3d = CBAM3D(self.dims[1], device=device)
        self.feature_dim = sum(self.dims)
        _add_head(self, "head", self.feature_dim, classes, hidden=256, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        fmap, _ = self.fundus_backbone(fundus, train)
        omap, _ = self.oct_backbone(oct_vol, train)
        pf = self.cbam2d(at_least_f32(fmap)).mean(dim=(1, 2))
        po = self.cbam3d(at_least_f32(omap)).mean(dim=(1, 2, 3))
        feat = torch.cat([pf, po], dim=1)
        logits = _head(self, "head", feat)
        return logits, _ce(logits, y), feat


class MultiDropoutResNet(_TwoCNN):
    """MC-dropout fusion: dropout on the fused feature, active at inference
    when ``mc=True``."""

    def __init__(self, classes: int = 2, *, rate: float = 0.3, dtype=torch.float32, device=None):
        super().__init__(dtype=dtype, device=device)
        self.rate = rate
        self.feature_dim = sum(self.dims)
        _add_head(self, "head", self.feature_dim, classes, hidden=256, device=device)

    def forward(self, fundus=None, oct_vol=None, y=None, *, train: bool = False, mc: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        feat = torch.cat(self._pooled(fundus, oct_vol, train), dim=1)
        feat = _maybe_dropout(feat, self.rate, train or mc, dropout_masks, generator)
        logits = _head(self, "head", feat)
        return logits, _ce(logits, y), feat


class TwoDTransformer(_Baseline):
    """Swin-only single-modality baseline."""

    def __init__(self, classes: int = 2, *, img_size: int = 384, swin_kwargs: Optional[dict] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.backbone, dim = _swin(img_size, dtype, device, swin_kwargs)
        self.fc_fundus = Dense(dim, 768, device=device)
        self.feature_dim = 768
        _add_head(self, "head", 768, classes, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        _, pooled = self.backbone(fundus)
        feat = F.relu(self.fc_fundus(pooled))
        logits = _head(self, "head", feat)
        return logits, _ce(logits, y), feat


class ThreeDTransformer(_Baseline):
    """3-D-ViT-only single-modality baseline."""

    def __init__(self, classes: int = 2, *, vit_kwargs: Optional[dict] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.backbone, dim = _vit(dtype, device, vit_kwargs)
        self.feature_dim = dim
        _add_head(self, "head", dim, classes, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        _, pooled = self.backbone(oct_vol)
        logits = _head(self, "head", pooled)
        return logits, _ce(logits, y), pooled


class _TwoTransformers(_Baseline):
    def __init__(self, *, img_size, swin_kwargs, vit_kwargs, dtype, device):
        super().__init__()
        self.fundus_backbone, df = _swin(img_size, dtype, device, swin_kwargs)
        self.oct_backbone, do = _vit(dtype, device, vit_kwargs)
        self.dims = (df, do)

    def _pooled(self, fundus, oct_vol):
        return self.fundus_backbone(fundus)[1], self.oct_backbone(oct_vol)[1]


class TransCross(_TwoTransformers):
    """Swin-2D x ViT-3D cross-attention fusion: the fundus token attends to
    the OCT token."""

    def __init__(self, classes: int = 2, *, embed: int = 512, img_size: int = 384,
                 swin_kwargs: Optional[dict] = None, vit_kwargs: Optional[dict] = None, dtype=torch.float32,
                 device=None):
        super().__init__(img_size=img_size, swin_kwargs=swin_kwargs, vit_kwargs=vit_kwargs, dtype=dtype,
                         device=device)
        self.proj_f = Dense(self.dims[0], embed, device=device)
        self.proj_o = Dense(self.dims[1], embed, device=device)
        self.cross = MultiHeadAttention(embed, 8, device=device)
        self.feature_dim = 2 * embed
        _add_head(self, "head", self.feature_dim, classes, hidden=128, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        pf, po = self._pooled(fundus, oct_vol)
        qf, qo = self.proj_f(pf)[:, None, :], self.proj_o(po)[:, None, :]
        feat = torch.cat([self.cross(qf, qo, qo)[:, 0], qo[:, 0]], dim=1)
        logits = _head(self, "head", feat)
        return logits, _ce(logits, y), feat


def _mlc(module, pf, po, y):
    """Per-modality heads and a joint head; the logits average, the loss sums
    the three CE terms."""
    logits_f, logits_o = _head(module, "head_f", pf), _head(module, "head_o", po)
    feat = torch.cat([pf, po], dim=1)
    logits_c = _head(module, "head_c", feat)
    logits = (logits_f + logits_o + logits_c) / 3.0
    loss = _ce(logits_f, y) + _ce(logits_o, y) + _ce(logits_c, y) if y is not None else _ce(logits, None)
    return logits, loss, feat


def _add_mlc_heads(module, dims, classes, device):
    _add_head(module, "head_f", dims[0], classes, device=device)
    _add_head(module, "head_o", dims[1], classes, device=device)
    _add_head(module, "head_c", sum(dims), classes, hidden=256, device=device)
    module.feature_dim = sum(dims)


class MLC(_TwoCNN):
    """Intermediate + late fusion with a combined classifier, CNN edition."""

    def __init__(self, classes: int = 2, *, dtype=torch.float32, device=None):
        super().__init__(dtype=dtype, device=device)
        _add_mlc_heads(self, self.dims, classes, device)

    def _logits(self, fundus, oct_vol, y, train):
        return _mlc(self, *self._pooled(fundus, oct_vol, train), y)


class MLCTrans(_TwoTransformers):
    """MLC, transformer edition."""

    def __init__(self, classes: int = 2, *, img_size: int = 384, swin_kwargs: Optional[dict] = None,
                 vit_kwargs: Optional[dict] = None, dtype=torch.float32, device=None):
        super().__init__(img_size=img_size, swin_kwargs=swin_kwargs, vit_kwargs=vit_kwargs, dtype=dtype,
                         device=device)
        _add_mlc_heads(self, self.dims, classes, device)

    def _logits(self, fundus, oct_vol, y, train):
        return _mlc(self, *self._pooled(fundus, oct_vol), y)


class _FeatureExtractor(_Baseline):
    """A backbone with optional dropout on its pooled vector (active under
    ``train`` or ``mc``); ``output`` "map", "pooled" or "logits"."""

    def _init(self, backbone, classes, output, rate, device):
        self.backbone, self.output, self.rate = backbone, output, rate
        self.feature_dim = backbone.out_channels
        if output == "logits":
            _add_head(self, "head", self.feature_dim, classes, device=device)

    def forward(self, fundus=None, oct_vol=None, y=None, *, train: bool = False, mc: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        fmap, pooled = self.backbone(self._input(fundus, oct_vol), train)
        pooled = _maybe_dropout(pooled, self.rate, train or mc, dropout_masks, generator)
        if self.output == "map":
            return fmap
        if self.output == "pooled":
            return pooled
        logits = _head(self, "head", pooled)
        return logits, _ce(logits, y), pooled


class FeatureExtractor2D(_FeatureExtractor):
    """The Res2Net feature-extractor wrappers (``Medical_*_2DNet``)."""

    def __init__(self, classes: int = 2, *, output: str = "pooled", base_width: int = 26, scales: int = 4,
                 dropout: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self._init(Res2Net2D(base_width=base_width, scales=scales, dtype=dtype, device=device), classes,
                   output, dropout, device)

    @staticmethod
    def _input(fundus, oct_vol):
        return fundus


class FeatureExtractor3D(_FeatureExtractor):
    """The 3-D ResNet feature-extractor wrappers (``Medical_*_3DNet``);
    blocks (1, 1, 1, 1) is ResNet-10, (2, 2, 2, 2) ResNet-18."""

    def __init__(self, classes: int = 2, *, output: str = "pooled", blocks=(1, 1, 1, 1), dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self._init(ResNet3D(blocks=blocks, dtype=dtype, device=device), classes, output, dropout, device)

    @staticmethod
    def _input(fundus, oct_vol):
        return oct_vol


class MultiEnsembleResNet(_TwoCNN):
    """``Multi_ensemble_ResNet``: the 14w8s Res2Net, ResNet-10, and one
    Linear on the concatenation."""

    def __init__(self, classes: int = 2, *, dtype=torch.float32, device=None):
        super().__init__(blocks_3d=(1, 1, 1, 1), base_width=14, scales=8, dtype=dtype, device=device)
        self.feature_dim = sum(self.dims)
        self.fc = Dense(self.feature_dim, classes, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        feat = torch.cat(self._pooled(fundus, oct_vol, train), dim=1)
        logits = self.fc(feat)
        return logits, _ce(logits, y), feat


class MultiEnsemble3DResNet(_TwoCNN):
    """``Multi_ensemble_3D_ResNet``: the 26w4s Res2Net, a ResNet-18 (by
    default), and one Linear on the concatenation."""

    def __init__(self, classes: int = 2, *, blocks_3d=(2, 2, 2, 2), dtype=torch.float32, device=None):
        super().__init__(blocks_3d=blocks_3d, dtype=dtype, device=device)
        self.feature_dim = sum(self.dims)
        self.fc = Dense(self.feature_dim, classes, device=device)

    def _logits(self, fundus, oct_vol, y, train):
        feat = torch.cat(self._pooled(fundus, oct_vol, train), dim=1)
        logits = self.fc(feat)
        return logits, _ce(logits, y), feat
