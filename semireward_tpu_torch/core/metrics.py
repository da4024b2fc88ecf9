"""Evaluation metrics — sklearn-equivalent, numpy host-side (copy of
``semireward_tpu/core/metrics.py``).

The reference computes eval metrics with sklearn (core/algorithmbase.py:
420-450): accuracy, balanced accuracy, macro precision/recall/F1, confusion
matrix for classification; mse/rmse/mae/mape/r2 for regression. Reimplemented
here against sklearn's definitions so eval needs no sklearn at runtime (it is
still used in tests as the golden reference when available).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int, normalize: str = None):
    cm = np.zeros((num_classes, num_classes), dtype=np.float64)
    np.add.at(cm, (np.asarray(y_true, np.int64), np.asarray(y_pred, np.int64)), 1.0)
    if normalize == "true":
        with np.errstate(invalid="ignore", divide="ignore"):
            cm = cm / cm.sum(axis=1, keepdims=True)
        cm = np.nan_to_num(cm)
    return cm


def classification_metrics(y_true, y_pred, num_classes: int,
                           y_logits=None) -> Dict[str, float]:
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    n = len(y_true)
    acc = float((y_true == y_pred).mean()) if n else 0.0

    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm)
    support = cm.sum(axis=1)       # true counts per class
    predicted = cm.sum(axis=0)     # predicted counts per class

    with np.errstate(invalid="ignore", divide="ignore"):
        recall_c = np.where(support > 0, tp / support, 0.0)
        precision_c = np.where(predicted > 0, tp / predicted, 0.0)
        f1_c = np.where(precision_c + recall_c > 0,
                        2 * precision_c * recall_c / (precision_c + recall_c), 0.0)

    # sklearn balanced_accuracy: mean recall over classes PRESENT in y_true
    present = support > 0
    balanced_acc = float(recall_c[present].mean()) if present.any() else 0.0
    # sklearn macro average over all labels 0..C-1 (the reference passes no
    # labels list, so sklearn uses the union of observed labels)
    observed = present | (predicted > 0)
    precision = float(precision_c[observed].mean()) if observed.any() else 0.0
    recall = float(recall_c[observed].mean()) if observed.any() else 0.0
    f1 = float(f1_c[observed].mean()) if observed.any() else 0.0

    out = {
        "top-1-acc": acc,
        "balanced_acc": balanced_acc,
        "precision": precision,
        "recall": recall,
        "F1": f1,
    }
    if y_logits is not None and num_classes > 5:
        y_logits = np.asarray(y_logits)
        top5 = np.argsort(y_logits, axis=-1)[:, -5:]
        out["top-5-acc"] = float((top5 == y_true[:, None]).any(axis=1).mean())
    return out


def regression_metrics(y_true, y_pred) -> Dict[str, float]:
    y_true = np.asarray(y_true, np.float64).reshape(-1)
    y_pred = np.asarray(y_pred, np.float64).reshape(-1)
    err = y_pred - y_true
    mse = float((err**2).mean())
    mae = float(np.abs(err).mean())
    # sklearn mean_absolute_percentage_error clips |y| at eps
    eps = np.finfo(np.float64).eps
    mape = float((np.abs(err) / np.maximum(np.abs(y_true), eps)).mean())
    ss_res = float((err**2).sum())
    ss_tot = float(((y_true - y_true.mean())**2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return {"mse": mse, "rmse": mse**0.5, "mae": mae, "mape": mape, "r2": r2}
