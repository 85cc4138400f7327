"""Evaluation metrics: running averages, top-k accuracy, confusion matrix.

Counterpart of ``rubiksnet_tpu/utils/metrics.py``: the reference
evaluator's ``AverageMeter`` and ``accuracy`` (its scripts/test_models.py)
and sklearn's ``confusion_matrix``, on numpy arrays.
"""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, topk=(1,)):
    """Precision@k in percent for each k of ``topk``."""
    maxk = max(topk)
    order = np.argsort(-logits, axis=1)[:, :maxk]
    correct = order == labels[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, num_classes=None):
    """(num_classes, num_classes) counts: row = label, column = prediction."""
    if num_classes is None:
        num_classes = int(max(labels.max(), preds.max())) + 1
    cm = np.zeros((num_classes, num_classes), np.float64)
    np.add.at(cm, (labels, preds), 1.0)
    return cm


def per_class_accuracy(labels: np.ndarray, preds: np.ndarray, num_classes=None):
    """Hits over count per class; NaN for a class with no sample."""
    cm = confusion_matrix(labels, preds, num_classes)
    cnt = cm.sum(axis=1)
    hit = np.diag(cm)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(cnt > 0, hit / cnt, np.nan)
