"""Classification metrics in numpy (a copy of ``ugpg_tpu/metrics/classification.py``).

Accuracy, per-class precision / recall / F1 / support with macro and
weighted averages (the layout of sklearn's ``classification_report``),
the confusion matrix, per-class accuracy (recall), and ROC-AUC: binary by
the rank statistic with midranks for ties, and the macro one-vs-rest mean
over the classes present in the labels.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "confusion_matrix",
    "classification_report",
    "per_class_accuracy",
    "roc_auc",
    "macro_roc_auc_ovr",
]


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    """C[i, j] = count of samples with true class i predicted as j."""
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def classification_report(
    y_true, y_pred, num_classes: int, class_names: list[str] | None = None
) -> dict:
    """sklearn-style nested dict report (precision/recall/f1/support)."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    support = cm.sum(axis=1)
    pred_count = cm.sum(axis=0)
    tp = np.diag(cm).astype(np.float64)

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)

    total = int(support.sum())
    names = class_names or [str(i) for i in range(num_classes)]
    report: dict = {}
    for i, name in enumerate(names):
        report[name] = {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1-score": float(f1[i]),
            "support": int(support[i]),
        }
    report["accuracy"] = float(tp.sum() / max(total, 1))
    report["macro avg"] = {
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1-score": float(f1.mean()),
        "support": total,
    }
    w = support / max(total, 1)
    report["weighted avg"] = {
        "precision": float((precision * w).sum()),
        "recall": float((recall * w).sum()),
        "f1-score": float((f1 * w).sum()),
        "support": total,
    }
    return report


def per_class_accuracy(y_true, y_pred, num_classes: int) -> np.ndarray:
    """Recall per class (the reference's 'per-class accuracy',
    ref: test_herlev.py:247-251)."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    support = cm.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(support > 0, np.diag(cm) / support, 0.0)


def roc_auc(y_true, scores) -> float:
    """Binary ROC-AUC via the rank statistic (ties handled by midranks).

    Equivalent to sklearn.metrics.roc_auc_score for binary labels.
    """
    y_true = np.asarray(y_true).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    pos_rank_sum = ranks[y_true == 1].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def macro_roc_auc_ovr(y_true, probs) -> float:
    """Macro one-vs-rest ROC-AUC over classes present in y_true
    (ref: test_herlev.py:254-273 label_binarize path)."""
    y_true = np.asarray(y_true).astype(np.int64)
    probs = np.asarray(probs, dtype=np.float64)
    aucs = []
    for k in range(probs.shape[1]):
        binary = (y_true == k).astype(np.int64)
        if binary.sum() in (0, len(binary)):
            continue
        aucs.append(roc_auc(binary, probs[:, k]))
    return float(np.mean(aucs)) if aucs else float("nan")
