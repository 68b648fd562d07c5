"""The evaluation metric suite in numpy (``edrl_tpu/train/metrics.py``, copied).

The reference's 10-metric evaluation surface (``fusion_train.py:493-500``
plus the per-epoch metrics at ``:229-263``): accuracy, weighted precision,
recall and F1, AUC (binary or one-vs-rest), specificity, kappa, ECE,
AURC / E-AURC, NLL and Brier, from their standard definitions, with no
sklearn.  A copy of the JAX package's module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


def accuracy(targets: np.ndarray, predictions: np.ndarray) -> float:
    return float(np.mean(targets == predictions))


def _class_counts(targets, predictions, num_classes):
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    support = np.zeros(num_classes)
    for c in range(num_classes):
        tp[c] = np.sum((predictions == c) & (targets == c))
        fp[c] = np.sum((predictions == c) & (targets != c))
        fn[c] = np.sum((predictions != c) & (targets == c))
        support[c] = np.sum(targets == c)
    return tp, fp, fn, support


def precision_recall_f1_weighted(
    targets: np.ndarray, predictions: np.ndarray, num_classes: Optional[int] = None
):
    """Weighted-average precision/recall/F1, matching sklearn's
    ``average='weighted'`` with zero_division=0 (``fusion_train.py:230-232``)."""
    if num_classes is None:
        num_classes = int(max(targets.max(), predictions.max())) + 1
    tp, fp, fn, support = _class_counts(targets, predictions, num_classes)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-12), 0.0)
    w = support / max(support.sum(), 1)
    return float(np.sum(prec * w)), float(np.sum(rec * w)), float(np.sum(f1 * w))


def binary_auc(targets: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the rank (Mann-Whitney U) statistic, with tie handling."""
    targets = np.asarray(targets)
    scores = np.asarray(scores, dtype=np.float64)
    pos = scores[targets == 1]
    neg = scores[targets == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    # average ranks (ties get mean rank)
    all_scores = np.concatenate([pos, neg])
    order = np.argsort(all_scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(all_scores) + 1)
    # tie correction: average ranks within equal-score groups
    sorted_scores = all_scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = np.mean(ranks[order[i : j + 1]])
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2
    return float(u / (len(pos) * len(neg)))


def auc_ovr(targets: np.ndarray, probabilities: np.ndarray) -> float:
    """One-vs-rest macro AUC for the multi-class case (``fusion_train.py:247-250``)."""
    num_classes = probabilities.shape[1]
    aucs = []
    for c in range(num_classes):
        binary_targets = (targets == c).astype(np.int64)
        if binary_targets.min() == binary_targets.max():
            continue
        aucs.append(binary_auc(binary_targets, probabilities[:, c]))
    return float(np.mean(aucs)) if aucs else float("nan")


def roc_auc(targets: np.ndarray, probabilities: np.ndarray) -> float:
    """Dispatch binary (positive-class prob) vs multi-class OvR as the
    reference does (``fusion_train.py:243-250``)."""
    if len(np.unique(targets)) == 2 and probabilities.shape[1] == 2:
        return binary_auc(targets, probabilities[:, 1])
    return auc_ovr(targets, probabilities)


def specificity(targets: np.ndarray, predictions: np.ndarray) -> float:
    """TN / (TN + FP) from the (0, 0)/(0, 1) confusion cells
    (``fusion_train.py:256-259``)."""
    tn = float(np.sum((targets == 0) & (predictions == 0)))
    fp = float(np.sum((targets == 0) & (predictions == 1)))
    return tn / (tn + fp) if (tn + fp) > 0 else 0.0


def cohen_kappa(targets: np.ndarray, predictions: np.ndarray) -> float:
    num_classes = int(max(targets.max(), predictions.max())) + 1
    cm = np.zeros((num_classes, num_classes), dtype=np.float64)
    for t, p in zip(targets, predictions):
        cm[int(t), int(p)] += 1
    n = cm.sum()
    po = np.trace(cm) / n
    pe = np.sum(cm.sum(axis=0) * cm.sum(axis=1)) / (n * n)
    return float((po - pe) / (1 - pe)) if pe < 1 else 0.0


def expected_calibration_error(
    targets: np.ndarray, probabilities: np.ndarray, n_bins: int = 15
) -> float:
    """Standard confidence-binned ECE (replaces the missing ``metrics.cal_ece``)."""
    confidences = probabilities.max(axis=1)
    predictions = probabilities.argmax(axis=1)
    correct = (predictions == targets).astype(np.float64)
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    n = len(targets)
    for lo, hi in zip(bins[:-1], bins[1:]):
        mask = (confidences > lo) & (confidences <= hi)
        if mask.sum() == 0:
            continue
        ece += (mask.sum() / n) * abs(correct[mask].mean() - confidences[mask].mean())
    return float(ece)


def aurc_eaurc(targets: np.ndarray, probabilities: np.ndarray):
    """Area under the risk-coverage curve and its excess over the optimal
    curve (replaces the missing ``metrics2.calc_aurc_eaurc``)."""
    confidences = probabilities.max(axis=1)
    predictions = probabilities.argmax(axis=1)
    residuals = (predictions != targets).astype(np.float64)
    order = np.argsort(-confidences, kind="mergesort")
    residuals = residuals[order]
    n = len(residuals)
    cum_risk = np.cumsum(residuals) / np.arange(1, n + 1)
    aurc = float(np.mean(cum_risk))
    # Optimal AURC: all errors pushed to the end.
    err = residuals.sum() / n
    optimal = np.sort(residuals)  # zeros first
    cum_opt = np.cumsum(optimal) / np.arange(1, n + 1)
    eaurc = float(aurc - np.mean(cum_opt))
    del err
    return aurc, eaurc


def nll_brier(targets: np.ndarray, probabilities: np.ndarray):
    """Mean negative log-likelihood and (multi-class) Brier score
    (replaces the missing ``metrics2.calc_nll_brier``)."""
    n, num_classes = probabilities.shape
    p_true = probabilities[np.arange(n), targets.astype(np.int64)]
    nll = float(np.mean(-np.log(np.maximum(p_true, 1e-12))))
    one_hot = np.eye(num_classes)[targets.astype(np.int64)]
    brier = float(np.mean(np.sum((probabilities - one_hot) ** 2, axis=1)))
    return nll, brier


@dataclasses.dataclass
class EpochMetrics:
    """The per-epoch metric row written to CSV (``fusion_train.py:92-94``)."""

    loss: float
    accuracy: float
    precision: float
    recall: float
    f1: float
    auc: float
    specificity: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def compute_epoch_metrics(
    targets: np.ndarray,
    probabilities: np.ndarray,
    loss: float,
    num_classes: Optional[int] = None,
) -> EpochMetrics:
    targets = np.asarray(targets)
    probabilities = np.asarray(probabilities, dtype=np.float64)
    predictions = probabilities.argmax(axis=1)
    prec, rec, f1 = precision_recall_f1_weighted(targets, predictions, num_classes)
    return EpochMetrics(
        loss=float(loss),
        accuracy=accuracy(targets, predictions),
        precision=prec,
        recall=rec,
        f1=f1,
        auc=roc_auc(targets, probabilities),
        specificity=specificity(targets, predictions),
    )


def compute_uncertainty_metrics(
    targets: np.ndarray, probabilities: np.ndarray
) -> Dict[str, float]:
    """The deep-ensemble 10-metric suite (``fusion_train.py:464-500``)."""
    targets = np.asarray(targets)
    probabilities = np.asarray(probabilities, dtype=np.float64)
    predictions = probabilities.argmax(axis=1)
    prec, rec, f1 = precision_recall_f1_weighted(targets, predictions)
    aurc, eaurc = aurc_eaurc(targets, probabilities)
    nll, brier = nll_brier(targets, probabilities)
    return {
        "accuracy": accuracy(targets, predictions),
        "auc": roc_auc(targets, probabilities),
        "aurc": aurc,
        "eaurc": eaurc,
        "nll": nll,
        "brier": brier,
        "f1": f1,
        "recall": rec,
        "kappa": cohen_kappa(targets, predictions),
        "ece": expected_calibration_error(targets, probabilities),
    }
