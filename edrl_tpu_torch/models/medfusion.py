"""MedFusion, the flagship EDRL network (``edrl_tpu/models/medfusion.py``).

Swin-2D fundus and ViT-3D OCT backbones feed one EPRL head each; the proxy
Gaussians fuse through PoE into a global vector; DILR disentangles common
and unique feature blocks; a small MLP head grades the disease.

Both modes draw noise, which the JAX package takes from threefry keys:

- the guided uniforms U[0, 1) ``[B, C, z]``, one per modality.  They reach
  the logits through DILR's guided queries.
- EPRL's proxy noise ``eps`` ``[C, S, z]``.  It reaches the losses.
- train mode only: EPRL's dropout keep masks, three per modality.

Eval mode draws the uniforms and one eps for both modalities from fixed
keys there, and here from a ``torch.Generator`` seeded with 1 on the
model's device: deterministic, but not the JAX package's numbers, which
torch cannot replay.  Train mode draws all of them per call, there from the
step's keys and here from the ``generator`` the caller passes.  ``forward``
takes every draw as an optional tensor (``guided_uniform=(u_f, u_o)``,
``eprl_eps``, ``dropout_masks``), so that parity tests can inject JAX's.
Under a data axis (``parallel.use_mesh``) the per-row draws are drawn at
the global batch and each rank keeps its rows (``parallel.draw_rows``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.config import ModelConfig
from edrl_tpu_torch.models.dilr import DILR
from edrl_tpu_torch.models.eprl import EVAL_SEED, EPRL, eval_eps
from edrl_tpu_torch.models.layers import Dense
from edrl_tpu_torch.models.poe import PoE
from edrl_tpu_torch.models.swin2d import SwinTransformer2D
from edrl_tpu_torch.models.vit3d import ViT3D
from edrl_tpu_torch.ops.distributions import kl_to_standard_normal
from edrl_tpu_torch.ops.losses import label_smoothing_cross_entropy
from edrl_tpu_torch.parallel.mesh import draw_rows


def eval_guided_uniform(batch: int, num_classes: int, z_dim: int, device):
    """The eval-mode guided uniforms ``(u_f, u_o)``, each ``[B, C, z]``, from a
    generator seeded with 1 (not the JAX package's draw); under a data axis,
    this rank's rows of the global batch's."""
    gen = torch.Generator(device=device).manual_seed(EVAL_SEED)
    shape = (batch, num_classes, z_dim)
    return (draw_rows(torch.rand, shape, gen, device), draw_rows(torch.rand, shape, gen, device))


class MedFusion(nn.Module):
    """Returns ``(logits, loss, combined_features, aux)``."""

    def __init__(self, cfg: ModelConfig, fundus_size: int = 384,
                 oct_size: Tuple[int, int, int] = (96, 96, 96), *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = torch.bfloat16 if cfg.use_bfloat16 else torch.float32
        c, z = cfg.num_classes, cfg.z_dim
        self.transformer_2d = SwinTransformer2D(
            img_size=fundus_size, embed_dim=cfg.swin_embed_dim, depths=cfg.swin_depths,
            num_heads=cfg.swin_heads, window=cfg.swin_window,
            use_fused_attention=cfg.use_fused_attention, use_fused_ln=cfg.use_fused_ln,
            use_fused_mlp=cfg.use_fused_mlp, use_fused_block_attention=cfg.use_fused_block_attention,
            remat=cfg.remat, remat_attention=cfg.remat_attention, dtype=dtype, device=device,
        )
        self.transformer_3d = ViT3D(
            volume_size=oct_size[0], patch_size=cfg.vit3d_patch, dim=cfg.oct_embed_dim,
            depth=cfg.vit3d_depth, num_heads=cfg.vit3d_heads,
            use_fused_attention=cfg.vit_fused_attention, use_fused_ln=cfg.use_fused_ln,
            use_fused_mlp=cfg.use_fused_mlp, use_fused_block_attention=cfg.use_fused_block_attention,
            remat=cfg.remat, dtype=dtype, device=device,
        )
        eprl_kw = dict(z_dim=z, num_classes=c, sample_num=cfg.sample_num, topk=cfg.proxy_topk,
                       dtype=dtype, device=device)
        self.eprl_fundus = EPRL(cfg.fundus_embed_dim, cfg.fundus_tokens, **eprl_kw)
        self.eprl_oct = EPRL(cfg.oct_embed_dim, cfg.oct_tokens, **eprl_kw)
        self.poe = PoE(2, renormalize_mask=cfg.poe_renormalize_mask, device=device)
        self.fc_fundus = Dense(c * z, cfg.fundus_embed_dim, device=device)
        self.dilr = DILR(
            fundus_dim=cfg.fundus_embed_dim, oct_dim=cfg.oct_embed_dim,
            feature_dim=2 * cfg.fundus_embed_dim, guided_in_dim=c * z,
            common_ratio=cfg.common_ratio, num_heads=cfg.num_heads,
            off_diag_weight=cfg.bt_off_diag_weight, dtype=dtype, device=device,
        )
        self.head1 = Dense(3 * cfg.fundus_embed_dim, 64, device=device)
        self.head2 = Dense(64, c, device=device)

    def forward(
        self,
        fundus: torch.Tensor,  # [B, H, W, 3]
        oct_vol: torch.Tensor,  # [B, D, H, W, 1]
        y: Optional[torch.Tensor] = None,
        *,
        train: bool = False,
        modality_mask: Optional[torch.Tensor] = None,  # [2] bool: (fundus, oct)
        guided_uniform: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        eprl_eps: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], None] = None,
        dropout_masks: Optional[Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns ``(logits, loss, combined_features, aux)``.

        ``eprl_eps``: one ``[C, S, z]`` tensor for both EPRL heads, or a pair
        ``(eps_fundus, eps_oct)``.  ``dropout_masks``: ``(masks_fundus,
        masks_oct)``, each EPRL's two keep masks (train mode).  Draws that
        are absent come from ``generator`` in train mode and from the eval
        seed in eval mode.  Train mode needs ``y``.
        """
        cfg = self.cfg
        b = fundus.shape[0]
        c, z_dim = cfg.num_classes, cfg.z_dim
        if train and y is None:
            raise ValueError("MedFusion train mode requires labels y")
        if modality_mask is not None:
            fundus = fundus * modality_mask[0].to(fundus.dtype)
            oct_vol = oct_vol * modality_mask[1].to(oct_vol.dtype)

        tokens_f, _ = self.transformer_2d(fundus)
        tokens_o, _ = self.transformer_3d(oct_vol)

        if eprl_eps is None and not train:
            eprl_eps = eval_eps(c, cfg.sample_num, z_dim, fundus.device)
        eps_f, eps_o = eprl_eps if isinstance(eprl_eps, (tuple, list)) else (eprl_eps, eprl_eps)
        masks_f, masks_o = dropout_masks if dropout_masks is not None else (None, None)
        eprl_kw = dict(train=train, generator=generator)
        mu_f, sig_f, proxy_f, _, ent_f = self.eprl_fundus(
            tokens_f, y, eps=eps_f, dropout_masks=masks_f, **eprl_kw)
        mu_o, sig_o, proxy_o, _, ent_o = self.eprl_oct(
            tokens_o, y, eps=eps_o, dropout_masks=masks_o, **eprl_kw)

        if guided_uniform is None:
            if train:
                shape = (b, c, z_dim)
                guided_uniform = tuple(draw_rows(torch.rand, shape, generator, fundus.device) for _ in range(2))
            else:
                guided_uniform = eval_guided_uniform(b, c, z_dim, fundus.device)
        u_f, u_o = guided_uniform
        guided_f = (mu_f + u_f * sig_f).reshape(b, c * z_dim)
        guided_o = (mu_o + u_o * sig_o).reshape(b, c * z_dim)

        poe = self.poe([mu_f, mu_o], [sig_f, sig_o], modality_mask=modality_mask)
        global_fusion = F.relu(self.fc_fundus(F.relu(poe.reshape(b, c * z_dim))))

        combined, loss_dilr = self.dilr(tokens_f, tokens_o, global_fusion, guided_f, guided_o, train=train)
        logits = self.head2(F.relu(self.head1(F.relu(combined))))

        aux: Dict[str, torch.Tensor] = {
            "dilr_loss": loss_dilr,
            "proxy_loss_fundus": proxy_f,
            "proxy_loss_oct": proxy_o,
            "entropy_loss": ent_f + ent_o,
        }
        if y is None:
            return logits, torch.zeros((), device=logits.device), combined, aux

        ce = label_smoothing_cross_entropy(logits, y, cfg.label_smoothing)
        ib = cfg.kl_weight * kl_to_standard_normal(mu_f, sig_f, axis=1) + (
            cfg.kl_weight * kl_to_standard_normal(mu_o, sig_o, axis=1)
        )
        w_proxy = cfg.proxy_weight_train if train else cfg.proxy_weight_eval
        loss = ce + ib + w_proxy * (proxy_f + proxy_o) + cfg.dilr_weight * loss_dilr
        aux.update({"ce_loss": ce, "ib_loss": ib})
        return logits, loss, combined, aux
