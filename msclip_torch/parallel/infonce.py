"""Single-device global-batch InfoNCE, from ``msclip_tpu/parallel/infonce.py``.

The contrastive objective of the reference's training forward
(``clip_openai_pe_res_v1.py:3126-3155``): ``logits = exp(logit_scale) *
img @ txt.T`` over the batch, cross-entropy in both directions. The sharded,
chunked and ring variants of the JAX package wait for multi-process
training (ROADMAP M7).
"""

from __future__ import annotations

import torch


def _ce(logits, labels, label_smoothing=0.0):
    """Cross-entropy with an fp32 log-softmax and optional label smoothing
    (``LOSS.LABEL_SMOOTHING``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    loss = logz - gold
    if label_smoothing > 0.0:
        smooth = logz - logits.mean(dim=-1)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
    return loss.mean()


def infonce_loss(feats_img, feats_txt, logit_scale, label_smoothing=0.0):
    """Symmetric InfoNCE over the batch. Inputs L2-normalized ``[B, E]``;
    returns the fp32 scalar loss."""
    T = torch.exp(logit_scale).float()
    logits = T * (feats_img.float() @ feats_txt.float().t())
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (_ce(logits, labels, label_smoothing)
                  + _ce(logits.t(), labels, label_smoothing))
