"""Metric logging (``edrl_tpu/train/logging.py``, copied).

CSV columns as in the reference's ``save_results`` (``fusion_train.py:85-115``):
Epoch, Loss, Accuracy, Precision, Recall, F1 Score, AUC, Specificity; Loss
is the epoch average.  ``setup_logging`` writes a run's log file and echoes
it to the console.
"""

from __future__ import annotations

import csv
import os

from edrl_tpu_torch.train.metrics import EpochMetrics

_HEADER = [
    "Epoch",
    "Loss",
    "Accuracy",
    "Precision",
    "Recall",
    "F1 Score",
    "AUC",
    "Specificity",
]


def setup_logging(log_file: str):
    """File + console logging (the reference's ``log_args``,
    ``fusion_train.py:44-63``)."""
    import logging

    logger = logging.getLogger("edrl_tpu_torch")
    logger.setLevel(logging.DEBUG)
    # Idempotent: re-invocation (tests, repeated CLI calls in-process)
    # replaces handlers instead of stacking duplicates.
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    formatter = logging.Formatter(
        "%(asctime)s ===> %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
    fh = logging.FileHandler(log_file)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(formatter)
    ch = logging.StreamHandler()
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(formatter)
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger


class AverageMeter:
    """Running scalar average (``fusion_train.py:137-153``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class CsvMetricWriter:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(_HEADER)

    def drop_rows_from(self, epoch: int) -> int:
        """Remove rows with Epoch >= ``epoch`` (preemption resume: epochs
        after the restored ``latest`` checkpoint re-run and re-write their
        rows; without this the CSV keeps the pre-crash duplicates).
        Returns the number of rows dropped."""
        with open(self.path, newline="") as f:
            rows = list(csv.reader(f))
        kept = [rows[0]] + [
            r for r in rows[1:] if r and int(float(r[0])) < epoch
        ]
        dropped = len(rows) - len(kept)
        if dropped:
            with open(self.path, "w", newline="") as f:
                csv.writer(f).writerows(kept)
        return dropped

    def write(self, epoch: int, m: EpochMetrics):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(
                [
                    epoch,
                    f"{m.loss:.6f}",
                    f"{m.accuracy:.4f}",
                    f"{m.precision:.4f}",
                    f"{m.recall:.4f}",
                    f"{m.f1:.4f}",
                    f"{m.auc:.4f}",
                    f"{m.specificity:.4f}",
                ]
            )
