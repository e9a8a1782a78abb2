"""Global-batch InfoNCE losses, from ``msclip_tpu/parallel/infonce.py``.

The contrastive objective of the reference's training forward
(``clip_openai_pe_res_v1.py:3126-3155``): ``logits = exp(logit_scale) *
img @ txt.T`` over the global batch, cross-entropy in both directions.

* :func:`infonce_loss`: the full ``[B, B]`` matrix of the batch in hand;
  :func:`gathered_infonce_loss` first gathers every process's rows, so
  every process computes the global matrix (plain data parallelism);
* :func:`sharded_infonce_loss`: each process its ``[b, B]`` row block of
  both directions;
* :func:`chunked_sharded_infonce_loss` (``TPU.SHARDED_LOSS``): the same
  rows against the gathered columns in chunks of ``TPU.LOSS_CHUNK`` with
  an online logsumexp, so no ``[b, B]`` block is held whole;
* :func:`ring_infonce_loss` (``+ TPU.RING_LOSS``): the column shards
  rotate around the group, so no process holds the gathered embeddings.

Each takes a process ``group`` where the JAX functions take
``axis_name`` (``None``: one process). The sharded losses return the mean
over the group on every process, as JAX's ``pmean``; their gradient on a
process is that of its own rows' mean, the convention of
``parallel/collectives.py``: the mean of the processes' gradients (the
train step's all-reduce) is the gradient of the global loss. The
all-gather is differentiable (its backward reduce-scatters), so the
reference's swap-in-my-own-slice gather (``lib/utils/comm.py:140-154``)
has no counterpart.
"""

from __future__ import annotations

import torch

from .collectives import (
    all_gather_rows,
    group_rank,
    group_size,
    rotate,
    value_mean,
)


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


def gathered_infonce_loss(feats_img, feats_txt, logit_scale, group=None,
                          label_smoothing=0.0):
    """:func:`infonce_loss` of the global batch: both local ``[b, E]``
    embedding sets gathered over ``group`` first, so every process
    computes the same ``[B, B]`` loss (what the JAX step computes under
    ``jit`` on a data-sharded batch, ``msclip_tpu/train/trainer.py:
    109-111``)."""
    return infonce_loss(all_gather_rows(feats_img, group),
                        all_gather_rows(feats_txt, group), logit_scale,
                        label_smoothing)


def _labels(b, group, device):
    return group_rank(group) * b + torch.arange(b, device=device)


def sharded_infonce_loss(feats_img, feats_txt, logit_scale, group=None,
                         label_smoothing=0.0):
    """InfoNCE with each process's ``[b, B]`` logit blocks: local rows
    against the gathered columns, both directions."""
    T = torch.exp(logit_scale).float()
    b = feats_img.shape[0]
    labels = _labels(b, group, feats_img.device)
    img_all = all_gather_rows(feats_img, group).float()
    txt_all = all_gather_rows(feats_txt, group).float()
    i2t = T * (feats_img.float() @ txt_all.t())
    t2i = T * (feats_txt.float() @ img_all.t())
    loss = 0.5 * (_ce(i2t, labels, label_smoothing)
                  + _ce(t2i, labels, label_smoothing))
    return value_mean(loss, group)


def chunked_direction(rows, cols_all, T, labels, B, chunk,
                      label_smoothing=0.0):
    """One direction of the chunked loss: local ``[b, E]`` rows against
    gathered ``[>= B, E]`` columns, ``chunk`` columns at a time with an
    online logsumexp; columns from ``B`` on (the padded tail) are masked
    to ``-inf``. Standalone, with ungathered columns and ``labels =
    arange(B)``, it is one direction of :func:`infonce_loss` (the
    per-process work of a chunked step without its gathers)."""
    b = rows.shape[0]
    rows32 = rows.float()
    tail = cols_all.shape[0] % chunk
    if tail:  # standalone callers may pass unpadded columns
        cols_all = torch.cat([cols_all, cols_all.new_zeros(
            chunk - tail, cols_all.shape[1])])
    dev = rows.device
    m = torch.full((b,), float("-inf"), device=dev)
    s = torch.zeros(b, device=dev)
    gold = torch.zeros(b, device=dev)
    tot = torch.zeros(b, device=dev)
    for c in range(cols_all.shape[0] // chunk):
        block = cols_all[c * chunk:(c + 1) * chunk].float()
        logits = T * (rows32 @ block.t())
        col_ids = c * chunk + torch.arange(chunk, device=dev)
        valid = (col_ids < B)[None, :]
        logits = torch.where(valid, logits, float("-inf"))
        m_new = torch.maximum(m, logits.max(dim=-1).values)
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        hit = col_ids[None, :] == labels[:, None]
        gold = gold + torch.where(hit, logits, 0.0).sum(dim=-1)
        tot = tot + torch.where(valid, logits, 0.0).sum(dim=-1)
        m = m_new
    logz = m + torch.log(s)
    # (1-ls)(logz - gold) + ls(logz - mean) with mean = tot / B, _ce's
    # smoothing term
    target = (1.0 - label_smoothing) * gold + label_smoothing * (tot / B)
    return (logz - target).mean()


def chunked_sharded_infonce_loss(feats_img, feats_txt, logit_scale,
                                 group=None, chunk: int = 4096,
                                 label_smoothing=0.0):
    """:func:`sharded_infonce_loss` with the gathered columns streamed in
    ``chunk``-column blocks (``TPU.LOSS_CHUNK``). Both ``[B, E]``
    embedding sets are still gathered on every process; past that scale,
    :func:`ring_infonce_loss`."""
    T = torch.exp(logit_scale).float()
    b = feats_img.shape[0]
    labels = _labels(b, group, feats_img.device)
    img_all = all_gather_rows(feats_img, group)
    txt_all = all_gather_rows(feats_txt, group)
    B = img_all.shape[0]
    chunk = min(chunk, B)
    loss = 0.5 * (
        chunked_direction(feats_img, txt_all, T, labels, B, chunk,
                          label_smoothing)
        + chunked_direction(feats_txt, img_all, T, labels, B, chunk,
                            label_smoothing))
    return value_mean(loss, group)


class _RingDirection(torch.autograd.Function):
    """One InfoNCE direction with ring-rotated column shards
    (``_ring_direction``): the forward accumulates an online logsumexp
    while the ``[b, E]`` column shard travels around the group; the
    backward is a second ring pass in which each shard's column-gradient
    accumulator travels with it and comes home after ``n`` rotations.
    Autograd through the rotations would keep every rotated shard alive,
    the gathered footprint the ring exists to avoid.

    Returns the mean over this process's rows; ``logit_scale``'s gradient
    is this process's part (no sum over the group: the train step's mean
    over the group completes it, where the JAX backward ``psum``s it
    because its loss is ``pmean``ed)."""

    @staticmethod
    def forward(ctx, rows, cols, logit_scale, group, label_smoothing):
        n, b = group_size(group), rows.shape[0]
        B = n * b
        rank = group_rank(group)
        labels = _labels(b, group, rows.device)
        T = torch.exp(logit_scale).float()
        rows32 = rows.float()
        m = torch.full((b,), float("-inf"), device=rows.device)
        s = torch.zeros(b, device=rows.device)
        gold = torch.zeros(b, device=rows.device)
        tot = torch.zeros(b, device=rows.device)
        cur = cols
        for t in range(n):
            src = (rank + t) % n
            logits = T * (rows32 @ cur.float().t())
            col_ids = src * b + torch.arange(b, device=rows.device)
            m_new = torch.maximum(m, logits.max(dim=-1).values)
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            hit = col_ids[None, :] == labels[:, None]
            gold = gold + torch.where(hit, logits, 0.0).sum(dim=-1)
            tot = tot + logits.sum(dim=-1)
            m = m_new
            if t < n - 1:
                (cur,) = rotate([cur], group)
        logz = m + torch.log(s)
        target = (1.0 - label_smoothing) * gold \
            + label_smoothing * (tot / B)
        ctx.save_for_backward(rows, cols, logit_scale, logz)
        ctx.group, ctx.label_smoothing = group, label_smoothing
        return (logz - target).mean()

    @staticmethod
    def backward(ctx, g):
        rows, cols, logit_scale, logz = ctx.saved_tensors
        group, ls = ctx.group, ctx.label_smoothing
        n, b = group_size(group), rows.shape[0]
        B = n * b
        rank = group_rank(group)
        labels = _labels(b, group, rows.device)
        T = torch.exp(logit_scale).float()
        rows32 = rows.float()
        scale = g / b  # d mean / d per-row loss
        cur = cols
        dcols = torch.zeros(cols.shape, dtype=torch.float32,
                            device=cols.device)
        drows = torch.zeros(rows.shape, dtype=torch.float32,
                            device=rows.device)
        dls = torch.zeros((), dtype=torch.float32, device=rows.device)
        for t in range(n):
            src = (rank + t) % n
            cur32 = cur.float()
            logits = T * (rows32 @ cur32.t())
            probs = torch.exp(logits - logz[:, None])
            col_ids = src * b + torch.arange(b, device=rows.device)
            tgt = (1.0 - ls) * (col_ids[None, :] == labels[:, None]) + ls / B
            dlogits = (probs - tgt) * scale
            drows = drows + T * (dlogits @ cur32)
            dcols = dcols + T * (dlogits.t() @ rows32)
            # logits = e^ls * sim, so d logits / d ls = logits
            dls = dls + (dlogits * logits).sum()
            # the accumulator moves with its shard: after n rotations each
            # shard's gradient has every process's part and is home
            cur, dcols = rotate([cur, dcols], group)
        return (drows.to(rows.dtype), dcols.to(cols.dtype),
                dls.to(logit_scale.dtype), None, None)


def ring_infonce_loss(feats_img, feats_txt, logit_scale, group=None,
                      label_smoothing=0.0):
    """Symmetric InfoNCE with ring-rotated shards (``TPU.RING_LOSS``):
    per-process memory O(b E + b^2) at any global batch."""
    loss = 0.5 * (
        _RingDirection.apply(feats_img, feats_txt, logit_scale, group,
                             label_smoothing)
        + _RingDirection.apply(feats_txt, feats_img, logit_scale, group,
                               label_smoothing))
    return value_mean(loss, group)
