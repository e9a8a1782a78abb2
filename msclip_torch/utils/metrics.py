"""Evaluation metrics and the running-average meter, from
``msclip_tpu/utils/metrics.py`` (reference ``tools/zero_shot.py:122-180``):
top-k accuracy, 11-point mAP, balanced ("mean-per-class") accuracy and
ROC-AUC.

The JAX package computes the last three with scikit-learn
(``precision_recall_curve``, ``balanced_accuracy_score``,
``roc_auc_score``). The card's machine has no scikit-learn, so these are
numpy versions of the same definitions, held equal to scikit-learn's
results by ``tests/test_torch_metrics.py``, ties and empty columns
included.
"""

from __future__ import annotations

import warnings

import numpy as np


class AverageMeter:
    """Running average."""

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


def topk_accuracy(logits, target, topk=(1,), mask=None):
    """Percentage top-k accuracy. ``mask`` selects valid (non-pad) rows."""
    logits = np.asarray(logits)
    target = np.asarray(target)
    if mask is not None:
        logits = logits[np.asarray(mask)]
        target = target[np.asarray(mask)]
    n = len(target)
    if n == 0:
        return [0.0 for _ in topk]
    maxk = max(topk)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].any(axis=1).sum() / n for k in topk]


def precision_recall_curve(y_label, y_scores):
    """scikit-learn's ``precision_recall_curve`` for 0/1 labels: one point
    per distinct score, highest threshold last in the arrays' reversed
    order (recall decreasing), then the point (precision 1, recall 0). A
    column with no positive gives recall 1 at every threshold, as current
    scikit-learn (1.9) does; older releases gave NaN there, and so an AP
    of 0."""
    y = np.asarray(y_label).ravel() == 1
    s = np.asarray(y_scores).ravel()
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    # the last index of each run of equal scores
    ends = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[ends]
    fps = 1 + ends - tps
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def map_11points(y_label, y_scores):
    """11-point interpolated average precision, the reference's walk
    (``tools/zero_shot.py:136-147``)."""
    precision, recall = precision_recall_curve(y_label, y_scores)
    recall_thresholds = np.linspace(1, 0, 11, endpoint=True).tolist()
    precision_sum = 0.0
    recall_idx = 0
    precision_tmp = 0.0
    for threshold in recall_thresholds:
        while recall_idx < len(recall) and threshold <= recall[recall_idx]:
            precision_tmp = max(precision_tmp, precision[recall_idx])
            recall_idx += 1
        precision_sum += precision_tmp
    return precision_sum / 11


def multilabel_map_11points(y, logits):
    """Mean over classes of 11-point AP, scaled to percent."""
    y = np.asarray(y)
    logits = np.asarray(logits)
    total = sum(
        map_11points(y[:, c], logits[:, c]) for c in range(y.shape[1])
    )
    return total * 100.0 / y.shape[1]


def mean_per_class_accuracy(y, logits):
    """Balanced accuracy in percent: the mean recall over the classes
    present in ``y`` (a predicted class absent from ``y`` adds no term),
    as scikit-learn's ``balanced_accuracy_score``."""
    y = np.asarray(y).ravel()
    pred = np.asarray(logits).argmax(-1)
    classes = np.unique(y)
    recall = np.array([np.mean(pred[y == c] == c) for c in classes])
    return 100.0 * np.mean(recall)


def roc_auc(y, logits):
    """ROC-AUC in percent of the scores ``logits[:, 1]`` against binary
    ``y`` (positive: the larger label): the Mann-Whitney statistic with
    average ranks for ties, which is the area scikit-learn's
    ``roc_auc_score`` integrates. With one class in ``y`` it warns and
    returns NaN, as current scikit-learn (1.9) does (older releases
    raised)."""
    y = np.asarray(y).ravel()
    s = np.asarray(logits)[:, 1].astype(np.float64)
    classes = np.unique(y)
    if len(classes) == 1:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.", RuntimeWarning)
        return float("nan")
    if len(classes) != 2:
        raise ValueError(f"roc_auc takes binary labels, got {classes}")
    pos = y == classes[1]
    order = np.argsort(s, kind="mergesort")
    sorted_s = s[order]
    # average 1-based rank of each run of equal scores
    starts = np.r_[0, np.nonzero(np.diff(sorted_s))[0] + 1]
    ends = np.r_[starts[1:], s.size]
    ranks = np.empty(s.size)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    n_pos = int(pos.sum())
    n_neg = s.size - n_pos
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return 100.0 * u / (n_pos * n_neg)
