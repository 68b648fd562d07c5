"""Synthetic GAMMA-like datasets (``edrl_tpu/data/synthetic.py``, copied).

The reference's data paths are placeholders, so the system ships generators
of the real schema (fundus ``[H, W, 3]``, OCT ``[D, H, W]``, integer labels)
with a learnable class signal.  A copy of the JAX package's module: the same
split entropy, the same uint8 memo on the device-noise branch and the same
host-noise branch, so each sample is the same bytes as the JAX package's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from edrl_tpu_torch.config import DataConfig
from edrl_tpu_torch.data.noise import make_noise_views, sample_rng
from edrl_tpu_torch.data.transforms import fundus_train_augment, oct_train_augment


class SyntheticGammaDataset:
    """Deterministic per-index synthetic samples with a recoverable label."""

    def __init__(self, cfg: DataConfig, mode: str = "train", num_classes: int = 0):
        self.cfg = cfg
        self.mode = mode
        # 0 = follow the config (the real label schema carries 4 one-hot
        # columns — ``train_true.xlsx`` — so multi-class must be exercisable).
        self.num_classes = num_classes or cfg.num_classes
        self.n = cfg.num_synthetic_samples
        self._memo = {}  # index -> base sample (deterministic, reused per epoch)

    def __len__(self) -> int:
        return self.n

    def _index_entropy(self, const: int, index: int):
        """Seed entropy for sample ``index`` of THIS split.

        Non-train splits draw **disjoint** samples from the same protocol.
        Until round 3 every split replayed the train entropy ``[const,
        index]``, so a standalone val dataset was byte-identical to the
        first ``len(val)`` train samples and every synthetic "val" metric
        was measured on seen data (invalidating generalization claims in
        the ablation study).  Train keeps the historical entropy so prior
        training runs/compile caches stay reproducible.
        """
        if self.mode == "train":
            return [const, index]
        return [const, 104729 if self.mode == "val" else 104730, index]

    def _base_sample(self, index: int):
        """Raw (pre-noise) fundus/oct pair + label, deterministic in index."""
        rng = np.random.default_rng(
            np.random.SeedSequence(self._index_entropy(1234, index))
        )
        label = index % self.num_classes
        h = self.cfg.fundus_size
        d, oh, ow = self.cfg.oct_size
        # Class signal: mean shift + a low-frequency grating whose frequency
        # depends on the class, visible to both modalities.
        yy, xx = np.mgrid[0:h, 0:h]
        freq = 2 + 3 * label
        pattern = 0.15 * np.sin(2 * np.pi * freq * xx / h) * np.sin(
            2 * np.pi * freq * yy / h
        )
        base = 0.4 + 0.1 * label
        fundus = base + pattern[..., None] + 0.1 * rng.normal(size=(h, h, 3))
        fundus = np.clip(fundus, 0.0, 1.0).astype(np.float32)

        zz = np.mgrid[0:d][:, None, None]
        vol_pattern = 0.15 * np.sin(2 * np.pi * freq * zz / d)
        oct_vol = base + vol_pattern + 0.1 * rng.normal(size=(d, oh, ow))
        oct_vol = np.clip(oct_vol, 0.0, 1.0).astype(np.float32)
        return fundus, oct_vol, label

    def get(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        if self.cfg.device_noise:
            # Single clean view; the train step augments and builds both
            # noise views on the device — host cost is just the (memoized) base,
            # stored uint8 so batching is a pure byte-stack.
            if index not in self._memo:
                fundus, oct_vol, label = self._base_sample(index)
                if self.cfg.uint8_transport:
                    fundus = np.rint(fundus * 255.0).astype(np.uint8)
                    oct_vol = np.rint(oct_vol * 255.0).astype(np.uint8)
                self._memo[index] = (fundus, oct_vol, label)
            fundus, oct_vol, label = self._memo[index]
            return {"fundus": fundus, "oct": oct_vol, "label": np.int32(label)}
        fundus, oct_vol, label = self._base_sample(index)
        rng = sample_rng(self.cfg.seed, epoch, index)
        views = make_noise_views(fundus, oct_vol, self.cfg.noise, rng)
        if self.mode == "train":
            for key in ("fundus_low", "fundus_high"):
                views[key] = fundus_train_augment(
                    views[key],
                    rng,
                    jitter_prob=self.cfg.color_jitter_prob,
                    grayscale_prob=self.cfg.grayscale_prob,
                    hflip_prob=self.cfg.hflip_prob,
                    jitter_strength=self.cfg.color_jitter_strength,
                )
            for key in ("oct_low", "oct_high"):
                views[key] = oct_train_augment(views[key], rng, self.cfg.hflip_prob)
        views["label"] = np.int32(label)
        return views


class HardSyntheticGammaDataset(SyntheticGammaDataset):
    """Adversarial synthetic protocol: weak, modality-split, noise-buried signal.

    The easy generator above is linearly separable (models hit Acc 1.0 by
    epoch ~3), which cannot distinguish EDRL from plain late fusion.  This
    variant is built so the reference paper's mechanisms have to earn their
    keep:

    - **Weak amplitude**: the class pattern is ``signal_amplitude`` (default
      0.06) against 0.12-sigma per-sample nuisance noise, and evaluation adds
      the sigma<=0.5 corruption sweep on top — clean linear separation fails.
    - **Split across modalities with signal dropout**: with probability
      ``signal_dropout`` per modality (never both), a sample's class pattern
      is absent from that modality.  A single-modality model caps out below
      ``1 - dropout/2``; only cross-modal fusion can reach the ceiling.
    - **Class-uncorrelated distractors**: each sample carries a random
      strong grating and intensity shift, so intensity/frequency shortcuts
      that solve the easy task do not transfer.

    No reference analog (its data paths are placeholders); this implements
    the robustness protocol of SURVEY.md section 5.3 / the paper's noise
    claim so ablations (MMD / EPRL / DILR on-off) are measurable.
    """

    signal_amplitude: float = 0.06
    signal_dropout: float = 0.3
    nuisance_sigma: float = 0.12
    distractor_amplitude: float = 0.15

    def _base_sample(self, index: int):
        rng = np.random.default_rng(
            np.random.SeedSequence(self._index_entropy(99177, index))
        )
        label = index % self.num_classes
        h = self.cfg.fundus_size
        d, oh, ow = self.cfg.oct_size

        # Which modalities carry the signal for THIS sample (never neither).
        u = rng.uniform()
        fundus_has = u >= self.signal_dropout
        oct_has = not (self.signal_dropout <= u < 2 * self.signal_dropout)

        # Class-dependent pattern: a fixed-per-class pseudo-random spatial
        # template (not a simple grating, so there is no single-frequency
        # shortcut); weak amplitude.
        cls_rng = np.random.default_rng(np.random.SeedSequence([5150, label]))
        yy, xx = np.mgrid[0:h, 0:h]
        f1, f2 = cls_rng.uniform(2, 9, size=2)
        ph1, ph2 = cls_rng.uniform(0, 2 * np.pi, size=2)
        fundus_sig = np.sin(2 * np.pi * f1 * xx / h + ph1) * np.cos(
            2 * np.pi * f2 * yy / h + ph2
        )
        zz = np.mgrid[0:d][:, None, None]
        f3 = cls_rng.uniform(2, 9)
        ph3 = cls_rng.uniform(0, 2 * np.pi)
        oct_sig = np.sin(2 * np.pi * f3 * zz / d + ph3) * np.ones((1, oh, ow))

        # Distractors: strong class-UNcorrelated structure per sample.
        g1 = rng.uniform(2, 9)
        gph = rng.uniform(0, 2 * np.pi)
        distractor_2d = np.sin(2 * np.pi * g1 * xx / h + gph)
        g2 = rng.uniform(2, 9)
        distractor_3d = np.sin(2 * np.pi * g2 * zz / d + rng.uniform(0, 2 * np.pi))
        base_shift = rng.uniform(-0.08, 0.08)

        a, da, ns = (
            self.signal_amplitude,
            self.distractor_amplitude,
            self.nuisance_sigma,
        )
        fsig = a * fundus_sig if fundus_has else np.zeros((h, h))
        osig = a * oct_sig if oct_has else np.zeros((d, 1, 1))
        fundus = (
            0.5
            + base_shift
            + fsig[..., None]
            + da * distractor_2d[..., None]
            + ns * rng.normal(size=(h, h, 3))
        )
        fundus = np.clip(fundus, 0.0, 1.0).astype(np.float32)
        oct_vol = (
            0.5
            + base_shift
            + osig
            + da * distractor_3d
            + ns * rng.normal(size=(d, oh, ow))
        )
        oct_vol = np.clip(oct_vol, 0.0, 1.0).astype(np.float32)
        return fundus, oct_vol, label


class ComplementarySyntheticGammaDataset(SyntheticGammaDataset):
    """Complementary-evidence protocol: the label is only fully decodable
    by FUSING the two modalities, so the multimodal advantage is
    expressible in *clean accuracy* (the hard protocol above expresses it
    only on the robustness axes — its clean-accuracy column rewards
    memorization, ABLATION.md round 2/3).

    Construction (binary): latent evidence ``u, v ~ N(0,1)`` clipped to
    [-2, 2]; ``label = (u + v > 0)``.  The fundus renders **only** ``u``
    (a fixed protocol-level spatial template scaled by ``a*u``) and the
    OCT renders **only** ``v``.  The Bayes-optimal *unimodal* classifier
    is ``sign(u)`` (resp. ``sign(v)``) with accuracy
    ``E[max(Phi(u), 1-Phi(u))] ~= 0.75``, while fusing both recovers
    ``u + v`` exactly → ceiling ~= 1.0.  Each modality still carries real
    per-modality label signal (~0.75), so EPRL's per-modality proxy
    losses remain learnable (a pure-XOR construction would make them
    degenerate).

    4-class variant: ``label = (u > 0) + 2*(v > 0)`` — each modality
    carries exactly one bit; unimodal ceiling 0.5, fusion ceiling ~1.0.

    Distractors and nuisance noise follow the hard protocol (weaker), so
    the evidence must be read out of structure, not mean intensity.

    No reference analog (its data paths are placeholders,
    ``fusion_train.py:559-560``); this closes STATUS round-3 known-gap #3:
    "a protocol where the multimodal advantage is expressible in accuracy".
    """

    signal_amplitude: float = 0.10
    nuisance_sigma: float = 0.08
    distractor_amplitude: float = 0.10

    def latent_evidence(self, index: int):
        """(u, v) evidence pair for ``index`` — test/analysis hook."""
        rng = np.random.default_rng(
            np.random.SeedSequence(self._index_entropy(77411, index))
        )
        u, v = np.clip(rng.normal(size=2), -2.0, 2.0)
        return float(u), float(v)

    def _label_of(self, u: float, v: float) -> int:
        if self.num_classes == 2:
            return int(u + v > 0)
        if self.num_classes == 4:
            return int(u > 0) + 2 * int(v > 0)
        # Silently emitting binary labels into e.g. a 3-class head would
        # leave classes without support and void the protocol's ceilings.
        raise ValueError(
            "ComplementarySyntheticGammaDataset defines only the binary "
            f"(u+v>0) and 4-class (u>0, v>0) protocols; got num_classes="
            f"{self.num_classes}"
        )

    def _base_sample(self, index: int):
        rng = np.random.default_rng(
            np.random.SeedSequence(self._index_entropy(77411, index))
        )
        u, v = np.clip(rng.normal(size=2), -2.0, 2.0)
        label = self._label_of(float(u), float(v))
        h = self.cfg.fundus_size
        d, oh, ow = self.cfg.oct_size

        # Fixed protocol-level templates (label-independent — the EVIDENCE
        # is the signed coefficient, not the pattern identity).
        t_rng = np.random.default_rng(np.random.SeedSequence([31337]))
        yy, xx = np.mgrid[0:h, 0:h]
        f1, f2 = t_rng.uniform(2, 7, size=2)
        ph1, ph2 = t_rng.uniform(0, 2 * np.pi, size=2)
        fundus_tpl = np.sin(2 * np.pi * f1 * xx / h + ph1) * np.cos(
            2 * np.pi * f2 * yy / h + ph2
        )
        zz = np.mgrid[0:d][:, None, None]
        f3 = t_rng.uniform(2, 7)
        oct_tpl = np.sin(2 * np.pi * f3 * zz / d + t_rng.uniform(0, 2 * np.pi))

        # Per-sample distractors + nuisance, as in the hard protocol.
        g1 = rng.uniform(2, 9)
        distractor_2d = np.sin(2 * np.pi * g1 * xx / h + rng.uniform(0, 2 * np.pi))
        g2 = rng.uniform(2, 9)
        distractor_3d = np.sin(2 * np.pi * g2 * zz / d + rng.uniform(0, 2 * np.pi))
        base_shift = rng.uniform(-0.06, 0.06)

        a, da, ns = (
            self.signal_amplitude,
            self.distractor_amplitude,
            self.nuisance_sigma,
        )
        fundus = (
            0.5
            + base_shift
            + (a * u) * fundus_tpl[..., None]
            + da * distractor_2d[..., None]
            + ns * rng.normal(size=(h, h, 3))
        )
        fundus = np.clip(fundus, 0.0, 1.0).astype(np.float32)
        oct_vol = (
            0.5
            + base_shift
            + (a * v) * oct_tpl
            + da * distractor_3d
            + ns * rng.normal(size=(d, oh, ow))
        )
        oct_vol = np.clip(oct_vol, 0.0, 1.0).astype(np.float32)
        return fundus, oct_vol, label


SYNTHETIC_DATASETS = {
    "synthetic": SyntheticGammaDataset,
    "synthetic_hard": HardSyntheticGammaDataset,
    "synthetic_fusion": ComplementarySyntheticGammaDataset,
}
