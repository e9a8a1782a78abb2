"""Top-k accuracy and the running-average meter, from
``msclip_tpu/utils/metrics.py`` (reference ``tools/zero_shot.py:165-180``)."""

from __future__ import annotations

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
