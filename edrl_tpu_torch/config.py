"""Configuration dataclasses of the port.

A copy of ``edrl_tpu/config.py``: the same classes, field names and
defaults, so that a config written for the JAX package means the same here.
``tests/test_torch_hermetic.py`` holds the two copies equal.  Fields that
only the JAX package reads (its parallelism, checkpoint, plotting and
TPU-dispatch knobs) are kept so that the copies stay interchangeable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Dual-view input corruption: the low and the high noise view."""

    condition: str = "noise"  # "noise" | "normal"
    condition_name: str = "Gaussian"  # "Gaussian" | "SaltPepper" | "All"
    gaussian_low: float = 0.0
    gaussian_high: float = 0.5
    salt_pepper_low: float = 0.0
    salt_pepper_high: float = 0.005


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset layout, batch sizes and augmentation."""

    dataset: str = "synthetic"  # "synthetic" | "dr2" | "glu2"
    data_path: str = ""
    label_file: str = ""
    fundus_size: int = 384
    oct_size: Tuple[int, int, int] = (96, 96, 96)  # (D, H, W)
    num_classes: int = 2
    folds: int = 5
    fold: int = 0
    split_seed: int = 10
    batch_size: int = 32
    eval_batch_size: int = 16
    drop_last: bool = True
    num_synthetic_samples: int = 64
    color_jitter_prob: float = 0.8
    color_jitter_strength: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.1)
    grayscale_prob: float = 0.2
    hflip_prob: float = 0.5
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    seed: int = 11
    device_noise: bool = False
    uint8_transport: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """EDRL model hyperparameters."""

    model_name: str = "MedFusion"
    num_classes: int = 2
    fundus_embed_dim: int = 1024
    oct_embed_dim: int = 768
    fundus_tokens: int = 144
    oct_tokens: int = 216
    z_dim: int = 256
    sample_num: int = 800
    proxy_topk: int = 100
    pseudo_label_threshold: float = 0.5
    common_ratio: float = 0.5
    bt_off_diag_weight: float = 0.0051
    num_heads: int = 8
    # Read by nothing, as in the reference: the live dropouts are fixed in
    # their modules (EPRL 0.2; DILR's attention has none).
    dropout: float = 0.25
    label_smoothing: float = 0.1
    kl_weight: float = 0.01
    proxy_weight_train: float = 0.3
    proxy_weight_eval: float = 0.8
    dilr_weight: float = 0.001
    poe_renormalize_mask: bool = False
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_heads: Tuple[int, ...] = (1, 2, 4, 8)
    swin_embed_dim: int = 128
    swin_window: int = 12
    vit3d_depth: int = 12
    vit3d_heads: int = 6
    vit3d_patch: int = 16
    use_bfloat16: bool = True
    remat: bool = False
    remat_attention: bool = True
    # Swin window attention through window_attention_fused_v2 (B2).
    use_fused_attention: bool = True
    # Not ported yet (B6); the port's MedFusion raises when it is set.
    use_fused_block_attention: bool = False
    # ViT-3D attention through self_attention_fused (B1).
    vit_fused_attention: bool = True
    # Not ported yet (B5, B4); the port's MedFusion raises when set.
    use_fused_mlp: bool = False
    use_fused_ln: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs."""

    mode: str = "train&test"  # "train" | "test" | "train&test"
    lr: float = 1e-5
    # Linear warmup: the lr is scaled by min((step + 1) / warmup_steps, 1).
    warmup_steps: int = 100
    grad_clip_norm: float = 0.0  # global-norm clipping of the raw gradients; 0 = off
    weight_decay: float = 1e-6  # Adam's, folded into the gradient
    start_epoch: int = 1
    end_epochs: int = 200
    seed: int = 0
    mmd_kernel_mul: float = 2.0
    mmd_kernel_num: int = 5
    # 0 skips the high-noise forward when js_distillation_weight is 0 too.
    mmd_weight: float = 1.0
    js_distillation_weight: float = 0.0
    scan_batches: int = 0
    checkpoint_dir: str = "checkpoint"
    log_dir: str = "log"
    save_every: int = 0
    save_latest_every: int = 0
    resume: bool = False
    plot_dir: str = ""
    student_t_every: int = 0
    name: str = "checkpoint_0.3"
    use_plateau_schedule: bool = False
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    plateau_metric: str = "loss"  # "loss" | "accuracy"
    data_axis: str = "data"
    model_axis: str = "model"
    num_data_shards: int = 1
    num_model_shards: int = 1
    zero1: bool = False
    log_every: int = 10
    # MK-MMD through the fused kernel (B3) instead of the plain ops.mmd path.
    use_pallas_mmd: bool = False


@dataclasses.dataclass(frozen=True)
class EDRLConfig:
    """Top-level config bundle."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kw) -> "EDRLConfig":
        return dataclasses.replace(self, **kw)


def tiny_test_config(batch_size: int = 4) -> EDRLConfig:
    """A small config for unit tests and CPU runs, with every mechanism on
    (EPRL proxies, PoE, DILR split, dual noise views)."""
    data = DataConfig(
        dataset="synthetic",
        fundus_size=64,
        oct_size=(32, 32, 32),
        batch_size=batch_size,
        eval_batch_size=batch_size,
        num_synthetic_samples=4 * batch_size,
    )
    model = ModelConfig(
        swin_depths=(1, 1),
        swin_heads=(2, 4),
        swin_embed_dim=32,
        swin_window=4,
        vit3d_depth=2,
        vit3d_heads=4,
        vit3d_patch=8,
        fundus_embed_dim=64,
        oct_embed_dim=48,
        fundus_tokens=64,   # (64/4/2)^2 = 8^2
        oct_tokens=64,      # (32/8)^3 = 4^3
        z_dim=32,
        sample_num=16,
        proxy_topk=8,
        num_heads=4,
        use_bfloat16=False,
        use_fused_attention=False,
        vit_fused_attention=False,
        use_fused_mlp=False,
        use_fused_ln=False,
        remat_attention=False,
    )
    # warmup_steps=0: short test runs would otherwise train at ~lr/100.
    train = TrainConfig(lr=1e-3, end_epochs=2, warmup_steps=0)
    return EDRLConfig(data=data, model=model, train=train)
